"""PyTorch port, the paper's graph workloads: the ``distr.graph2d`` probes
(``khop_counts_2d`` in its three forms, ``pagerank_2d``), the configs,
``launch.mesh`` and the graph dry-run (``launch.dryrun``), on the CPU.

One module-scoped fixture runs the JAX probes in a subprocess with 8
forced host devices (this process keeps its single-device jax), on the
inputs of ``tests/test_distributed.py::test_dryrun_probes_match_oracle``:
R-MAT scale 7, edge factor 8, F = 8 one-hot seeds, k = 3, on a ("data",
"model") = (2, 4) mesh and a ("pod", "data", "model") = (2, 2, 2) mesh.
It writes its ELL pull rows, the probes' outputs and ``collective_stats``
of each lowered probe to an ``.npz``. The port's probes on 8 CPU
positions must give the same counts bit for bit, PageRank within rtol
1e-4 / atol 1e-6 (float32 push, the JAX suite's tolerance) and rtol 1e-3
against the JAX bfloat16 probe; the dry-run's per-position all-gather
and all-reduce bytes must equal the JAX HLO's.

One finding is pinned here: with a bfloat16 push, the module XLA
compiles for the CPU all-gathers float32 (its CPU backend folds the
cast pair around the collective), while the lowered module, and the
port, all-gather bfloat16. The port's accounting equals the lowered
module's count; the compiled CPU module's equals the float32 push's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import graph500 as jgraph500
from repro.configs import twitter as jtwitter
from repro.launch.dryrun import GRAPH_CELLS as JGRAPH_CELLS
from repro_torch import algorithms as TA
from repro_torch.configs import graph500, twitter
from repro_torch.distr import graph2d
from repro_torch.distr.mesh import Mesh
from repro_torch.graph.datagen import rmat_graph
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SCALE, EDGE_FACTOR, F, K, ITERS = 7, 8, 8, 3, 30
MESHES = {"dm24": ((2, 4), ("data", "model")),
          "pdm222": ((2, 2, 2), ("pod", "data", "model"))}
VARIANTS = [(False, False), (True, False), (True, True)]


def cpu_mesh(name):
    shape, names = MESHES[name]
    return Mesh(np.array([CPU] * int(np.prod(shape)),
                         dtype=object).reshape(shape), names)


_JAX_PROBES = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import json
import numpy as np, jax, jax.numpy as jnp
from repro import algorithms as alg
from repro.distr import graph2d
from repro.graph.datagen import rmat_graph
from repro.launch.dryrun import collective_stats

I = dict(np.load(sys.argv[1]))
scale, ef, f, k, iters = (int(I[a]) for a in ("scale", "ef", "f", "k",
                                                "iters"))
g = rmat_graph(scale=scale, edge_factor=ef, seed=0, fmt="ell")
n, rel = g.n, g.relations["KNOWS"]
out, stats = {}, {}
idx, msk = graph2d.ell_shard_inputs(rel.A_T)
idx_sent, _ = graph2d.ell_shard_inputs(rel.A_T, sentinel=True)
out["idx"], out["msk"], out["idx_sent"] = idx, msk, idx_sent
out["khop_oracle"] = np.asarray(alg.khop_counts(rel, I["seeds"], k=k))
out["pagerank_oracle"] = np.asarray(alg.pagerank(rel, iters=iters))
deg = np.asarray(rel.A.to_dense()).astype(bool).sum(1).astype(np.float32)
out["deg"] = deg
devs = np.array(jax.devices()[:8])
meshes = {"dm24": jax.sharding.Mesh(devs.reshape(2, 4), ("data", "model")),
          "pdm222": jax.sharding.Mesh(devs.reshape(2, 2, 2),
                                      ("pod", "data", "model"))}

def both(lowered):
    return {"lowered": collective_stats(lowered.as_text(dialect="hlo"))[1],
            "compiled": collective_stats(lowered.compile().as_text())[1]}

for mname, mesh in meshes.items():
    for packed, sentinel in ((False, False), (True, False), (True, True)):
        tag = f"{mname}/khop/{int(packed)}{int(sentinel)}"
        fn = graph2d.khop_counts_2d(mesh, n, k, packed=packed,
                                    sentinel=sentinel)
        jfn = jax.jit(fn, in_shardings=graph2d.shardings_2d(
            mesh, n, idx.shape[1], f))
        out[tag] = np.asarray(jfn(jnp.asarray(idx_sent if sentinel else idx),
                                  jnp.asarray(msk), jnp.asarray(I["frontier"])))
        stats[tag] = both(jfn.lower(*graph2d.input_specs_2d(
            n, idx.shape[1], f)))
    for pname, pd in (("f32", None), ("bf16", jnp.bfloat16)):
        tag = f"{mname}/pagerank/{pname}"
        specs, shards = graph2d.pagerank_specs_2d(mesh, n, idx.shape[1])
        jfn = jax.jit(graph2d.pagerank_2d(mesh, n, iters=iters,
                                          push_dtype=pd), in_shardings=shards)
        out[tag] = np.asarray(jfn(jnp.asarray(idx), jnp.asarray(msk),
                                  jnp.asarray(deg)))
        stats[tag] = both(jfn.lower(*specs))
out["stats"] = np.array(json.dumps(stats))
np.savez(sys.argv[2], **out)
print("JAX_PROBES_OK")
"""


def inputs():
    n = 1 << SCALE
    seeds = np.random.default_rng(0).integers(0, n, size=F)
    frontier = np.zeros((n, F), np.int8)
    frontier[seeds, np.arange(F)] = 1
    return seeds, frontier


@pytest.fixture(scope="module")
def jax_probes(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_probes")
    src, dst = d / "in.npz", d / "out.npz"
    seeds, frontier = inputs()
    np.savez(src, scale=SCALE, ef=EDGE_FACTOR, f=F, k=K, iters=ITERS,
             seeds=seeds, frontier=frontier)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_PROBES, str(src),
                        str(dst)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "JAX_PROBES_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    out = dict(np.load(dst))
    out["stats"] = json.loads(str(out["stats"]))
    return out


@pytest.fixture(scope="module")
def port():
    """The port's pull rows of the same graph."""
    g = rmat_graph(SCALE, edge_factor=EDGE_FACTOR, seed=0, fmt="ell",
                   device="cpu")
    rel = g.relations["KNOWS"]
    idx, msk = graph2d.ell_shard_inputs(rel.A.T)
    idx_sent, _ = graph2d.ell_shard_inputs(rel.A.T, sentinel=True)
    deg = (rel.A.to_dense() != 0).sum(dim=1).to(torch.float32)
    return g, rel, idx, msk, idx_sent, deg


def test_pull_rows_match_jax(jax_probes, port):
    _, _, idx, msk, idx_sent, deg = port
    np.testing.assert_array_equal(idx, jax_probes["idx"])
    np.testing.assert_array_equal(msk, jax_probes["msk"])
    np.testing.assert_array_equal(idx_sent, jax_probes["idx_sent"])
    np.testing.assert_array_equal(deg.numpy(), jax_probes["deg"])


# -- the probes against the JAX probes ----------------------------------------
@pytest.mark.parametrize("packed,sentinel", VARIANTS)
@pytest.mark.parametrize("mname", sorted(MESHES))
def test_khop_counts_match_jax(mname, packed, sentinel, jax_probes, port):
    g, rel, idx, msk, idx_sent, _ = port
    seeds, frontier = inputs()
    fn = graph2d.khop_counts_2d(cpu_mesh(mname), g.n, K, packed=packed,
                                sentinel=sentinel)
    got = fn(torch.from_numpy(idx_sent if sentinel else idx),
             torch.from_numpy(msk), torch.from_numpy(frontier))
    assert got.dtype == torch.int32 and got.shape == (F,)
    want = jax_probes[f"{mname}/khop/{int(packed)}{int(sentinel)}"]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jax_probes["khop_oracle"])
    np.testing.assert_array_equal(
        got.numpy(), TA.khop_counts(rel.A, seeds, k=K).numpy())


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_pagerank_matches_jax(mname, jax_probes, port):
    g, rel, idx, msk, _, deg = port
    mesh = cpu_mesh(mname)
    args = (torch.from_numpy(idx), torch.from_numpy(msk), deg)
    got = graph2d.pagerank_2d(mesh, g.n, iters=ITERS)(*args)
    assert got.dtype == torch.float32 and got.shape == (g.n,)
    np.testing.assert_allclose(got.numpy(),
                               jax_probes[f"{mname}/pagerank/f32"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), jax_probes["pagerank_oracle"],
                               rtol=1e-4, atol=1e-6)
    bf = graph2d.pagerank_2d(mesh, g.n, iters=ITERS,
                             push_dtype=torch.bfloat16)(*args)
    assert bf.dtype == torch.float32
    np.testing.assert_allclose(bf.numpy(),
                               jax_probes[f"{mname}/pagerank/bf16"],
                               rtol=1e-3)


def test_bf16_push_all_gathers_bf16(port, monkeypatch):
    """The push vector crosses the all-gather in bfloat16; the float32
    conversion happens inside the reduce."""
    g, _, idx, msk, _, deg = port
    from repro_torch.distr import mesh as M
    seen = []
    real = M.all_gather

    def spy(mesh, xs, axis):
        seen.extend(x.dtype for x in xs)
        return real(mesh, xs, axis)

    monkeypatch.setattr(M, "all_gather", spy)
    graph2d.pagerank_2d(cpu_mesh("dm24"), g.n, iters=2,
                        push_dtype=torch.bfloat16)(
        torch.from_numpy(idx), torch.from_numpy(msk), deg)
    assert seen and set(seen) == {torch.bfloat16}


# -- the dry-run's accounting against the JAX HLO -----------------------------
def _kinds(stats):
    return {k: (v["count"], v["bytes"]) for k, v in stats.items()}


@pytest.mark.parametrize("packed,sentinel", VARIANTS)
@pytest.mark.parametrize("mname", sorted(MESHES))
def test_khop_collective_bytes_match_jax(mname, packed, sentinel,
                                         jax_probes, port):
    g, _, idx, _, _, _ = port
    rec = dryrun.khop_layout(cpu_mesh(mname), g.n, idx.shape[1], F, K,
                             packed=packed, sentinel=sentinel)
    st = jax_probes["stats"][f"{mname}/khop/{int(packed)}{int(sentinel)}"]
    assert _kinds(rec["collectives"]) == _kinds(st["compiled"])
    assert _kinds(rec["collectives"]) == _kinds(st["lowered"])


@pytest.mark.parametrize("mname", sorted(MESHES))
def test_pagerank_collective_bytes_match_jax(mname, jax_probes, port):
    g, _, idx, _, _, _ = port
    mesh = cpu_mesh(mname)
    f32 = dryrun.pagerank_layout(mesh, g.n, idx.shape[1], ITERS)
    bf16 = dryrun.pagerank_layout(mesh, g.n, idx.shape[1], ITERS,
                                  push_dtype=torch.bfloat16)
    st32 = jax_probes["stats"][f"{mname}/pagerank/f32"]
    st16 = jax_probes["stats"][f"{mname}/pagerank/bf16"]
    assert _kinds(f32["collectives"]) == _kinds(st32["compiled"])
    assert _kinds(f32["collectives"]) == _kinds(st32["lowered"])
    assert _kinds(bf16["collectives"]) == _kinds(st16["lowered"])
    # the CPU compiler's float32 wire (module doc)
    assert _kinds(st16["compiled"]) == _kinds(st32["compiled"])
    assert bf16["gathered_bytes_per_position"] * 2 == \
        f32["gathered_bytes_per_position"]


def test_layout_bytes_equal_the_tensors_a_cpu_probe_holds(port, monkeypatch):
    """On an 8-position CPU mesh, the accounting's per-position argument
    and all-gather bytes equal the ``nbytes`` of what the probe shards and
    gathers."""
    g, _, idx, msk, _, _ = port
    _, frontier = inputs()
    from repro_torch.distr import mesh as M
    mesh = cpu_mesh("dm24")
    recs = {p: dryrun.khop_layout(mesh, g.n, idx.shape[1], F, K, packed=p)
            for p in (False, True)}
    held = {"shard": [], "gather": []}
    real_shard, real_gather = M.shard, M.all_gather

    def shard(mesh, x, spec):
        out = real_shard(mesh, x, spec)
        held["shard"].append(out[0].nbytes)
        return out

    def gather(mesh, xs, axis):
        out = real_gather(mesh, xs, axis)
        held["gather"].append({t.nbytes for t in out})
        return out

    monkeypatch.setattr(M, "shard", shard)
    monkeypatch.setattr(M, "all_gather", gather)
    for packed, rec in recs.items():
        held["shard"].clear()
        held["gather"].clear()
        graph2d.khop_counts_2d(mesh, g.n, K, packed=packed)(
            torch.from_numpy(idx), torch.from_numpy(msk),
            torch.from_numpy(frontier))
        assert sum(held["shard"]) == rec["argument_bytes_per_position"]
        assert held["gather"] == [{rec["gathered_bytes_per_position"]}] * K


# -- configs, meshes, the dry-run CLI -----------------------------------------
def test_configs_are_the_jax_configs():
    assert graph500.GRAPH_CONFIG == jgraph500.GRAPH_CONFIG
    assert twitter.GRAPH_CONFIG == jtwitter.GRAPH_CONFIG
    assert dryrun.GRAPH_CELLS == JGRAPH_CELLS


def test_production_and_host_meshes():
    meta = torch.device("meta")
    m = make_production_mesh(devices=[meta] * 256)
    assert m.axis_names == ("data", "model") and m.shape == {
        "data": 16, "model": 16} and m.size == 256
    m2 = make_production_mesh(multi_pod=True, devices=[CPU] * 600)
    assert m2.axis_names == ("pod", "data", "model")
    assert tuple(m2.shape.values()) == (2, 16, 16)
    assert m2.distinct_devices == 1
    with pytest.raises(ValueError, match="Number of devices 8 must be >="):
        make_production_mesh(devices=[CPU] * 8)
    h = make_host_mesh("cpu")
    assert h.axis_names == ("data",) and h.size == 1 and h.home == CPU


def test_meshes_default_to_the_cards():
    """With no device list the meshes take the visible CUDA devices, and a
    host without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ValueError, match="Number of devices 0"):
        make_production_mesh()
    with pytest.raises(ValueError, match="no CUDA device"):
        make_host_mesh()


def test_dryrun_writes_the_sixteen_cells(tmp_path, capsys):
    out = str(tmp_path / "dry")
    assert dryrun.main(["--graph", "--mesh", "both", "--out", out]) == 0
    files = sorted(os.listdir(out))
    want = sorted(f"graph_{g}__{k}__{m}.json" for g in
                  ("graph500_s21", "twitter41m")
                  for k in ("pagerank", "khop", "khop_bitmap",
                            "khop_bitmap_sentinel")
                  for m in ("pod16x16", "pod2x16x16"))
    assert files == want

    def cell(name):
        with open(os.path.join(out, name + ".json")) as f:
            return json.load(f)

    # graph500_s21 on one pod, by hand: 2,097,152 rows over 16 "data"
    # positions, F = 256 over 16 "model" positions
    rows, deg, f_l = 2_097_152 // 16, 64, 256 // 16
    k = cell("graph_graph500_s21__khop__pod16x16")
    assert not k["layout_only"] and k["positions"] == 256
    assert k["memory"]["peak_per_device_bytes"] == (
        k["layout_bytes_per_position"] + k["memory"]["temp_size_in_bytes"])
    assert k["argument_bytes_per_position"] == rows * deg * 5 + rows * f_l
    assert k["output_bytes_per_position"] == f_l * 4
    assert k["gathered_bytes_per_position"] == 2_097_152 * f_l
    assert k["collectives"] == {
        "all-gather": {"count": 2, "bytes": 2 * 2_097_152 * f_l},
        "all-reduce": {"count": 1, "bytes": f_l * 4}}
    b = cell("graph_graph500_s21__khop_bitmap__pod16x16")
    assert b["gathered_bytes_per_position"] == 2_097_152 * 4   # one word
    assert b["argument_bytes_per_position"] == k[
        "argument_bytes_per_position"]
    s = cell("graph_graph500_s21__khop_bitmap_sentinel__pod16x16")
    assert s["collectives"] == b["collectives"]
    p = cell("graph_graph500_s21__pagerank__pod16x16")
    assert p["argument_bytes_per_position"] == rows * deg * 5 + rows * 4
    assert p["output_bytes_per_position"] == rows * 4
    assert p["collectives"] == {
        "all-gather": {"count": 10, "bytes": 10 * 2_097_152 * 4},
        "all-reduce": {"count": 10, "bytes": 40}}
    assert p["fits_hbm"] and p["card_bytes"] > 0
    # two pods: F over pod x model (8 a position)
    k2 = cell("graph_graph500_s21__khop__pod2x16x16")
    assert k2["positions"] == 512
    assert k2["output_bytes_per_position"] == 8 * 4
    t = cell("graph_twitter41m__khop__pod16x16")
    assert t["argument_bytes_per_position"] == (41_600_000 // 16) * (
        deg * 5 + f_l)
    capsys.readouterr()
    assert dryrun.main(["--graph", "--mesh", "both", "--out", out,
                        "--resume"]) == 0
    assert "16 skipped" in capsys.readouterr().out


def test_dryrun_model_cells_are_not_ported(capsys, tmp_path):
    """The model cells are ported since the models' mesh slice: ``--arch``
    runs (``tests/test_torch_sharding.py`` holds them to the JAX specs);
    with nothing asked for, the CLI still exits 2."""
    with pytest.raises(SystemExit) as e:
        dryrun.main([])
    assert e.value.code == 2
    assert "--arch" in capsys.readouterr().err
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "train_4k",
                        "--out", str(tmp_path)]) == 0
    assert os.listdir(tmp_path) == ["qwen2-7b__train_4k__pod16x16.json"]
