"""PyTorch port, the dry-run's cost side (``launch.dryrun``): the op
counters (``count_ops``: torch's ``FlopCounterMode`` and the port's
``OpCounter``), one part's count at a config's depth from its
``depth_points``, ``roofline`` on the H100's constants, the model FLOPs
and ``bitmap_mxv.launch_cost``, at tiny configs and a few production cells
on meta tensors.

Counts are integers and compared exactly: the same ops on the same shapes
count the same on meta and CPU tensors, and a count is linear in each
stack's layers. The JAX module is read for its definitions only
(``roofline`` with the port's constants given to both, its memory and cost
keys, its model FLOPs); nothing of it is compiled.
"""
import dataclasses
import json
import os
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import get_config as jget_config
from repro_torch.configs.base import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.graph import datagen
from repro_torch.kernels import bitmap_mxv
from repro_torch.launch import dryrun
from repro_torch.launch.serve import tiny_config

TRAIN = ShapeConfig("t", 8, 2, "train")
DECODE = ShapeConfig("d", 16, 2, "decode")


@pytest.fixture
def jax_dryrun(monkeypatch):
    """``repro.launch.dryrun``, imported without its forced 512 host
    devices (it sets ``XLA_FLAGS`` only where unset)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as jd
    return jd


def tiny(name, **kw):
    return dataclasses.replace(tiny_config(get_config(name)), **kw)


@pytest.mark.parametrize("name", ARCHS)
def test_counts_on_meta_equal_counts_on_cpu(name):
    """A tiny train part (forward and backward, remat as configured) and a
    decode step of every arch: the FLOPs, the bytes and the peak of the
    bytes allocated are the same on meta and on CPU tensors, and the FLOPs
    are what torch's ``FlopCounterMode`` counts."""
    cfg = tiny(name)
    for shape in (TRAIN, DECODE):
        meta = dryrun.count_ops(dryrun.part_fn(cfg, shape, 2))
        cpu = dryrun.count_ops(dryrun.part_fn(cfg, shape, 2, "cpu"))
        assert meta == cpu, (shape.kind, meta, cpu)
        assert min(meta) > 0
        run = dryrun.part_fn(cfg, shape, 2, "cpu")
        with FlopCounterMode(display=False) as flops:
            run()
        assert flops.get_total_flops() == meta[0], shape.kind


@pytest.mark.parametrize("name,kw", [
    ("qwen2-1.5b", {"n_layers": 5}),
    ("gemma2-9b", {"n_layers": 6}),                  # three (local, global)
    ("mixtral-8x7b", {"n_layers": 5}),
    ("rwkv6-3b", {"n_layers": 5}),
    ("zamba2-1.2b", {"n_layers": 5, "shared_attn_every": 2}),  # 2, 2, 1
    ("whisper-medium", {"n_layers": 5, "encoder_layers": 3})])
def test_depth_extrapolation_is_exact(name, kw):
    """``part_count`` from the counts at ``depth_points`` equals one count
    at the config's depth: FLOPs and bytes exactly; the temporaries
    exactly for a decode step and a one-stack train part, within 10% where
    zamba2's shared block or whisper's two stacks move the train peak."""
    cfg = tiny(name, **kw)
    assert len(dryrun.depth_points(cfg)) in (2, 3)
    for shape in (TRAIN, DECODE):
        want = dryrun.count_ops(dryrun.part_fn(cfg, shape, 2))
        got = dryrun.part_count(cfg, shape, 2)
        assert got[:2] == want[:2], shape.kind
        if shape.kind == "train" and cfg.family in ("zamba2", "whisper"):
            assert abs(got[2] - want[2]) <= 0.1 * want[2]
        else:
            assert got[2] == want[2], shape.kind


def test_depth_points_refuse_a_broken_pattern(tmp_path):
    """A depth that does not repeat the stack's pattern cannot be counted:
    the cell is recorded as an error, no field left empty."""
    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=41)
    with pytest.raises(ValueError):
        dryrun.depth_points(cfg)
    rec = dryrun.run_cell("gemma2-9b", "decode_32k", False, str(tmp_path),
                          cfg=cfg)
    assert rec["status"] == "error" and "pattern" in rec["error"]
    assert "cost" not in rec


def test_dense_layer_flops_closed_form():
    """One dense layer's train part (qwen2 at tiny widths, remat on): the
    products and attention counted by hand. Forward: q, k, v, o and the
    three SwiGLU products (2 T d_in d_out each), attention's QK and PV
    einsums over every key position (4 B H S S h), the unembedding (2 T D
    V); the backward twice every product; remat once more the layer up to
    the last tensor the backward needs (torch's checkpoint stops its
    recompute there), so without the down projection."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=1,
                              d_model=64, d_ff=96, vocab=160, n_heads=4,
                              n_kv_heads=2, head_dim=16, dtype="float32")
    assert cfg.remat and not cfg.tie_embeddings and cfg.mlp == "swiglu"
    B, S = 2, 8
    T, D, H, K, h = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, 16
    down = 2 * T * cfg.d_ff * D
    layer = (2 * T * D * H * h + 2 * 2 * T * D * K * h + 2 * T * H * h * D
             + 2 * 2 * T * D * cfg.d_ff + down + 4 * B * H * S * S * h)
    unembed = 2 * T * D * cfg.vocab
    want = 3 * (layer + unembed) + layer - down
    flops, _, _ = dryrun.count_ops(dryrun.part_fn(
        cfg, ShapeConfig("t", S, B, "train"), B))
    assert flops == want


def test_roofline_matches_jax(jax_dryrun, monkeypatch):
    """The port's ``roofline`` is the JAX body: given both modules the same
    constants (the port's H100 figures), the same terms and bound."""
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jax_dryrun, name, getattr(dryrun, name))
    for args in ((256, 9.7e13, 1.2e12, 3.6e9), (512, 1e9, 5e11, 0.0),
                 (1, 0.0, 0.0, 7.1e11), (16, 5e15, 1e10, 1e6)):
        assert dryrun.roofline(*args) == jax_dryrun.roofline(*args)
    assert dryrun.roofline(1, 0.0, 1.0, 0.0, int_ops_dev=1.67e13)[
        "compute_s"] == 1.67e13 / dryrun.INT32_OPS_PER_S


def test_model_flops_follow_jax():
    """``model_flops`` of every arch and shape: the JAX module's 6 (train)
    or 2 x active params x tokens, a chip's share, and the useful ratio
    over a counted per-device figure."""
    for name in ARCHS:
        cfg, jcfg = get_config(name), jget_config(name)
        for shape in SHAPES.values():
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1)
            want = ((6 if shape.kind == "train" else 2)
                    * jcfg.active_param_count() * tokens)
            got = dryrun.model_flops(cfg, shape, 256, 3e15)
            assert got["model_flops"] == want, name
            assert got["model_flops_per_device"] == want / 256
            assert got["useful_flops_ratio"] == want / 256 / 3e15


def test_launch_cost_equals_the_bound_before_the_move():
    """``launch_cost`` on the R-MAT s16 ELL handle at W = 16 (the kernel
    line's shape) equals the count ``chip_smoke.py``'s ``ell_case`` held
    the kernel against before it moved: each row's valid ids plus the
    row's sentinel (at most the padded width), the frontier and the output
    at 4 bytes, one OR a stored edge and word; every slot valid without
    data."""
    g = datagen.rmat_graph(16, fmt="ell", device="cpu")
    store, w = g.relations[next(iter(g.relations))].A.store, 16
    n, k, deg = store.shape[0], store.shape[1], store.max_deg
    ids = int(torch.clamp(store.mask.sum(dim=1) + 1, max=deg).sum())
    want = (ids * 4 + k * w * 4 + n * w * 4, store.nnz * w)
    assert bitmap_mxv.launch_cost(n, deg, w, k,
                                  valid=store.mask.sum(dim=1)) == want
    assert bitmap_mxv.launch_cost(n, deg, w, k) == (
        n * deg * 4 + k * w * 4 + n * w * 4, n * deg * w)


def jax_keys(jd):
    """The JAX module's cost, memory and roofline keys."""
    ma = types.SimpleNamespace(argument_size_in_bytes=1,
                               output_size_in_bytes=1, temp_size_in_bytes=1,
                               generated_code_size_in_bytes=0,
                               alias_size_in_bytes=0)
    comp = types.SimpleNamespace(memory_analysis=lambda: ma,
                                 cost_analysis=lambda: {"flops": 1.0})
    return (set(jd.cost_stats(comp)), set(jd.mem_stats(comp)),
            set(jd.roofline(1, 1.0, 1.0, 1.0)))


@pytest.mark.parametrize("arch,shape,multi", [
    ("qwen2-1.5b", "train_4k", False), ("qwen2-1.5b", "decode_32k", True),
    ("whisper-medium", "prefill_32k", False)])
def test_model_cells_record_cost_memory_roofline(jax_dryrun, tmp_path,
                                                 arch, shape, multi):
    """Production cells on meta positions carry the JAX module's keys;
    the peak is the layout's held bytes plus the counted temporaries, and
    ``fits_hbm`` judges it; the roofline reads the counted figures."""
    ckeys, mkeys, rkeys = jax_keys(jax_dryrun)
    rec = dryrun.run_cell(arch, shape, multi, str(tmp_path))
    assert rec["status"] == "ok" and not rec["layout_only"]
    assert ckeys <= set(rec["cost"]) and mkeys == set(rec["memory"])
    assert rkeys == set(rec["roofline"])
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["peak_per_device_bytes"] == (rec["layout_bytes_per_position"]
                                            + mem["temp_size_in_bytes"])
    assert rec["fits_hbm"] == (mem["peak_per_device_bytes"]
                               < rec["card_bytes"])
    assert rec["roofline"] == dryrun.roofline(
        rec["chips"], rec["cost"]["flops_per_device"],
        rec["cost"]["bytes_per_device"], rec["collective_bytes_per_device"])
    assert 0 < rec["useful_flops_ratio"] <= 1
    rows, parts = dryrun.part_rows(get_config(arch), SHAPES[shape],
                                   dryrun.meta_mesh(multi))
    assert (rec["cost"]["part_rows"], rec["cost"]["parts"]) == (rows, parts)


def test_graph_cells_record_cost_memory_roofline(jax_dryrun, tmp_path):
    """Every graph cell form: the JAX keys; the bitmap forms' int32
    operations are the kernel's launch cost a hop, every slot valid."""
    ckeys, mkeys, rkeys = jax_keys(jax_dryrun)
    n, max_deg, fq, k = dryrun.GRAPH_CELLS["graph500_s21"]
    recs = [dryrun.run_pagerank_cell("graph500_s21", False, str(tmp_path))]
    for form in ((False, False), (True, False), (True, True)):
        recs.append(dryrun.run_graph_cell("graph500_s21", False,
                                          str(tmp_path), *form))
    for rec in recs:
        assert rec["status"] == "ok" and not rec["layout_only"]
        assert ckeys <= set(rec["cost"]) and mkeys == set(rec["memory"])
        assert rkeys == set(rec["roofline"])
        assert rec["cost"]["bytes_per_device"] > 0
        assert rec["fits_hbm"] == (rec["memory"]["peak_per_device_bytes"]
                                   < rec["card_bytes"])
    rows = n // 16
    w = (fq // 16 + 31) // 32
    assert recs[2]["cost"]["int32_ops_per_device"] == \
        k * bitmap_mxv.launch_cost(rows, max_deg, w, n)[1]
    assert recs[1]["cost"]["int32_ops_per_device"] == 0


def test_no_cost_writes_the_layout_alone(tmp_path):
    """``--no-cost``: every cell of an arch with its layout, marked
    ``layout_only``, no cost, memory or roofline, ``fits_hbm`` on the held
    bytes."""
    assert dryrun.main(["--arch", "gemma-2b", "--mesh", "single",
                        "--no-cost", "--out", str(tmp_path)]) == 0
    for name in os.listdir(tmp_path):
        with open(tmp_path / name) as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["layout_only"]
        assert not {"cost", "memory", "roofline"} & set(rec)
        assert rec["fits_hbm"] == (rec["layout_bytes_per_position"]
                                   < rec["card_bytes"])
