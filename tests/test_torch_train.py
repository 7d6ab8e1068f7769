"""PyTorch port, the training substrate, held against the JAX package
(``repro.train``, ``repro.distr.compression``, ``repro.models.base``):
the schedule, clipping, AdamW and Adafactor on trees with stacked layer
leaves, int8 compression with error feedback, the synthetic data stream,
checkpoints (each package restoring the other's) and the init rule.

Inputs come from numpy with fixed seeds; the port keeps one tensor a layer
where the JAX package stacks the layers on axis 0, so each comparison
stacks the port's layers first. Tolerances: the optimizers' params and
state within 1e-6 absolute plus 1e-5 relative (float32 arithmetic in
another order: at most 9.5e-7 on params up to about 30, a few ulp); the
schedule and the clipped grads within 1e-6 relative; compression, data
and checkpoints bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ARCHS, ShapeConfig
from repro.distr import compression as jcomp
from repro.models import get_model as jget_model
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.configs.base import get_config as tget_config
from repro_torch.distr import compression as tcomp
from repro_torch.models import ParamTree, get_model, jax_leaves
from repro_torch.models.base import tree_map
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from test_arch_smoke import tiny_of

L, D, F, E, V = 2, 8, 16, 3, 12


# -- a tree with stacked layer leaves, in both layouts -----------------------------
def port_tree(rng, dtype=np.float32, scale=1.0):
    """The port's nesting: a list of per-layer dicts (norm gain, bias,
    matrix, experts) beside unstacked leaves. Layer 1's values are 10x
    layer 0's, so a per-layer absmax or RMS differs from the stacked one."""
    def arr(*shape, k=1.0):
        return (scale * k * rng.normal(size=shape)).astype(dtype)
    layers = [{"ln": arr(D, k=10 ** i), "b": arr(F, k=10 ** i),
               "w": arr(D, F, k=10 ** i), "experts": arr(E, D, F, k=10 ** i)}
              for i in range(L)]
    return {"embed": arr(V, D), "layers": layers, "ln_f": arr(D)}


def jax_layout(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: np.stack([x[k] for x in tree["layers"]])
                     for k in tree["layers"][0]}
    return out


def port_params(tree):
    return ParamTree(tree_map(lambda a: torch.from_numpy(a.copy()), tree))


def stacked_np(tree):
    """A port tree (tensors) as the JAX layout of numpy arrays."""
    return jax_layout(tree_map(lambda t: t.detach().float().numpy(), tree))


def close(got, want, rtol=1e-5, atol=1e-6):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32), rtol=rtol,
                                   atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_jax_leaves_follow_the_jax_flatten_order():
    """Paths and order of a port tree's JAX view equal jax.tree_util's on
    the stacked tree (dict keys sorted as strings), stacked rank included,
    and zamba2's segments read as seg{i} (seg10 before seg2)."""
    tree = port_tree(np.random.default_rng(0))
    got = jax_leaves(port_params(tree))
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_layout(tree))
    assert [p for p, _, _ in got] == [jax.tree_util.keystr(k) for k, _ in flat]
    for (_, ts, stacked), (_, a) in zip(got, flat):
        assert (len(ts),) + tuple(ts[0].shape) == a.shape if stacked \
            else tuple(ts[0].shape) == a.shape
    segs = {"segments": [[{"w": torch.zeros(2)}]] * 11}
    paths = [p for p, _, _ in jax_leaves(segs)]
    assert paths[:3] == ["['segments']['seg0']['w']",
                         "['segments']['seg1']['w']",
                         "['segments']['seg10']['w']"]


# -- schedule and clipping ---------------------------------------------------------
@pytest.mark.parametrize("warmup,total", [(5, 20), (0, 10), (3, 3)])
def test_schedule_matches_jax(warmup, total):
    kw = dict(lr=1e-3, warmup_steps=warmup, total_steps=total)
    j, t = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    for step in range(total + 3):
        got = topt.schedule(t, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jopt.schedule(j, step)),
                                   rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e4])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipped (1.0) and untouched (1e4); bfloat16 grads are scaled in
    float32 and cast back, as the JAX package does."""
    rng = np.random.default_rng(1)
    tree = port_tree(rng)
    tree["embed"] = tree["embed"].astype(ml_dtypes.bfloat16)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray,
                                                   jax_layout(tree)),
                                      max_norm)
    tg = tree_map(lambda a: torch.from_numpy(a.astype(np.float32)), tree)
    tg["embed"] = tg["embed"].to(torch.bfloat16)
    tg, tn = topt.clip_by_global_norm(tg, max_norm)
    assert tg["embed"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    close(stacked_np(tg), jg, rtol=1e-6, atol=0)


# -- the optimizers ------------------------------------------------------------------
def run_optimizer(name, steps=4, **kw):
    rng = np.random.default_rng(2)
    tree = port_tree(rng)
    grads = [port_tree(rng, scale=0.1) for _ in range(steps)]
    j, t = jopt.OptConfig(name=name, **kw), topt.OptConfig(name=name, **kw)
    jp = jax.tree.map(jnp.asarray, jax_layout(tree))
    js = (jopt.adafactor_init(jp, j) if name == "adafactor"
          else jopt.adamw_init(jp))
    tp = port_params(tree)
    ts = (topt.adafactor_init(tp, t) if name == "adafactor"
          else topt.adamw_init(tp))
    jupdate = jax.jit(jopt.update_fn(name), static_argnums=0)
    for g in grads:
        jp, js = jupdate(j, jp, jax.tree.map(jnp.asarray, jax_layout(g)), js)
        tp, ts = topt.update_fn(name)(t, tp, tree_map(torch.from_numpy, g),
                                      ts)
    return jp, js, tp, ts


def test_adamw_matches_jax_on_stacked_leaves():
    """Weight decay by the stacked rank: the per-layer gains and biases
    ((L, D) in JAX) decay, ln_f does not; lr large enough for decay to show."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.5)
    jp, js, tp, ts = run_optimizer("adamw", **kw)
    assert int(ts["step"]) == int(js["step"]) == 4
    close(stacked_np(tp), jp)
    close(jax_layout(tree_map(lambda t: t.numpy(), ts["m"])), js["m"])
    close(jax_layout(tree_map(lambda t: t.numpy(), ts["v"])), js["v"])


@pytest.mark.parametrize("chunked", [False, True])
def test_adafactor_matches_jax_on_stacked_leaves(chunked):
    """factored_min_dim 4 factors every (.., D, F) leaf and the embedding,
    but not the (L, D) gains (L = 2 < 4). Unchunked, the update's RMS
    clip is over the whole stacked leaf; chunked (a 1-byte threshold),
    the rank-4 experts take it per layer, as the JAX lax.map does."""
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=6, factored_min_dim=4,
              chunked_update_min_bytes=1 if chunked else 1 << 30)
    jp, js, tp, ts = run_optimizer("adafactor", **kw)
    acc = ts["acc"]
    assert set(acc["layers"][0]["w"]) == {"vr", "vc"}
    assert set(acc["layers"][0]["ln"]) == {"v"}
    assert set(acc["embed"]) == {"vr", "vc"}
    close(stacked_np(tp), jp)
    jacc = jax.tree.leaves(js["acc"])
    tacc = [np.stack([t.numpy() for t in ts]) if stacked else ts[0].numpy()
            for _, ts, stacked in jax_leaves(acc)]
    assert [a.shape for a in tacc] == [a.shape for a in jacc]
    close(tacc, jacc)


def test_adafactor_branches_differ_in_jax():
    """The chunked case is a different result, so the test above tells the
    two RMS clips apart."""
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=6, factored_min_dim=4)
    a = run_optimizer("adafactor", chunked_update_min_bytes=1 << 30, **kw)[0]
    b = run_optimizer("adafactor", chunked_update_min_bytes=1, **kw)[0]
    assert not np.allclose(a["layers"]["experts"], b["layers"]["experts"],
                           atol=1e-5)
    np.testing.assert_array_equal(a["layers"]["w"], b["layers"]["w"])


def test_adafactor_refuses_to_factor_the_layer_axis():
    tp = port_params(port_tree(np.random.default_rng(3)))
    with pytest.raises(ValueError, match="across the layers"):
        topt.adafactor_init(tp, topt.OptConfig(factored_min_dim=2))


# -- compression -----------------------------------------------------------------------
def test_compression_with_error_feedback_matches_jax():
    """One absmax scale per stacked leaf (layer 1 is 10x layer 0), int8
    round half to even, the residual in float32, five steps of feedback:
    bit for bit."""
    rng = np.random.default_rng(4)
    jerr = terr = None
    for _ in range(5):
        g = port_tree(rng)
        jg, jerr = jcomp.compress_decompress(
            jax.tree.map(jnp.asarray, jax_layout(g)), jerr)
        tg, terr = tcomp.compress_decompress(
            tree_map(torch.from_numpy, g), terr)
        close(stacked_np(tg), jg, rtol=0, atol=0)
        close(stacked_np(terr), jerr, rtol=0, atol=0)
    q, scale = tcomp.quantize(torch.tensor([0.5, -1.0, 0.25]))
    assert q.dtype == torch.int8 and q.tolist() == [64, -127, 32]
    assert torch.equal(tcomp.dequantize(q, scale),
                       torch.from_numpy(np.array(jcomp.dequantize(
                           *jcomp.quantize(jnp.asarray([0.5, -1.0, 0.25]))))))


def test_compression_keeps_bfloat16_grads_and_float32_residuals():
    g = {"w": torch.linspace(-1, 1, 7, dtype=torch.bfloat16)}
    out, err = tcomp.compress_decompress(g)
    assert out["w"].dtype == torch.bfloat16 and err["w"].dtype == torch.float32


# -- data --------------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-1.5b", "whisper-medium",
                                  "llava-next-mistral-7b"])
def test_synthetic_batch_bit_for_bit(name):
    jc, tc, _, _ = tiny_pair(name)
    js, ts = ShapeConfig("t", 40, 6, "train"), TShapeConfig("t", 40, 6,
                                                            "train")
    for step, host in ((0, (0, 1)), (7, (1, 3)), (8, (0, 2))):
        want = jdata.synthetic_batch(jc, js, step, jdata.DataConfig(seed=3),
                                     *host)
        got = tdata.synthetic_batch(tc, ts, step, tdata.DataConfig(seed=3),
                                    *host)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = tdata.stream(tc, ts, start_step=4)
    next(it)
    np.testing.assert_array_equal(next(it)["tokens"], jdata.synthetic_batch(
        jc, js, 5)["tokens"])
    on = tdata.to_device(got, "cpu")
    assert on["tokens"].dtype == torch.int32


# -- checkpoints ------------------------------------------------------------------------
def tiny_pair(name, **kw):
    jc = dataclasses.replace(tiny_of(name), **kw)
    tc = dataclasses.replace(tget_config(name), **dataclasses.asdict(jc))
    return jc, tc, jget_model(jc), get_model(tc)


def test_checkpoint_roundtrip_latest_and_corruption(tmp_path):
    d = str(tmp_path)
    tree = port_params(port_tree(np.random.default_rng(5)))
    state = topt.adamw_init(tree)
    tckpt.save((tree, state), d, 5)
    with torch.no_grad():
        for p in tree.parameters():
            p.add_(1)
    tckpt.save((tree, state), d, 9)
    assert tckpt.latest_step(d) == 9
    other = port_params(port_tree(np.random.default_rng(6)))
    _, step = tckpt.restore((other, topt.adamw_init(other)), d)
    assert step == 9
    for a, b in zip(other.parameters(), tree.parameters()):
        assert torch.equal(a, b)
    _, step = tckpt.restore((other, topt.adamw_init(other)), d, step=5)
    assert not torch.equal(other["ln_f"], tree["ln_f"])
    leaf = os.path.join(d, "step_9", "leaf_0.npy")
    arr = np.load(leaf)
    arr.flat[0] += 1
    np.save(leaf, arr)
    before = [t.clone() for t in other.parameters()]
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore((other, topt.adamw_init(other)), d)
    # checked before any leaf is copied: the tree is as it was
    assert all(torch.equal(a, b) for a, b in zip(before, other.parameters()))
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore(other, d, step=5)


def test_async_checkpointer_gc_and_errors(tmp_path):
    w = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"p": torch.ones(4)}
    for s in (1, 2, 3, 4):
        w.save(tree, s)
        tree["p"].add_(1)           # the copy was taken at save()
    w.wait()
    steps = sorted(n for n in os.listdir(str(tmp_path))
                   if n.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    out = {"p": torch.zeros(4)}
    _, s = tckpt.restore(out, str(tmp_path))
    assert s == 4 and out["p"].tolist() == [4.0] * 4
    # a write that fails off-thread is raised by wait()
    os.rename(str(tmp_path), str(tmp_path) + ".moved")
    open(str(tmp_path), "w").close()
    w.save(tree, 5)
    with pytest.raises(OSError):
        w.wait()
    w.wait()                        # reported once


@pytest.mark.parametrize("name,opt", [("qwen2-1.5b", "adamw"),
                                      ("zamba2-1.2b", "adamw"),
                                      ("llama4-maverick-400b-a17b",
                                       "adafactor")])
def test_checkpoint_paths_and_cross_package_restore(tmp_path, name, opt):
    """The port's manifest lists the JAX package's leaves (path, shape,
    dtype) in its order for (params, state); a JAX checkpoint restores into
    the port's tree and a port checkpoint into the JAX tree, equal arrays
    both ways (float32)."""
    from repro_torch.models import params_from_numpy, params_to_numpy
    jc, tc, jm, tm = tiny_pair(name)
    jp = jm.init(0)
    jstate = jopt.init_fn(opt)(jp)
    rng = np.random.default_rng(7)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)), jp)
    jp, jstate = jax.jit(jopt.update_fn(opt), static_argnums=0)(
        jopt.OptConfig(name=opt), jp, jg, jstate)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save((jp, jstate), jdir, 1)

    tp = tm.init(1, "cpu")
    tstate = topt.init_fn(opt)(tp)
    _, step = tckpt.restore((tp, tstate), jdir)
    assert step == 1 and int(tstate["step"]) == 1
    close(params_to_numpy(tc, tp), jp, rtol=0, atol=0)
    for (_, ts, stacked), want in zip(jax_leaves(tstate),
                                      jax.tree.leaves(jstate)):
        got = np.stack([t.numpy() for t in ts]) if stacked else ts[0].numpy()
        np.testing.assert_array_equal(got, np.asarray(want))

    tckpt.save((tp, tstate), tdir, 1)
    with open(os.path.join(jdir, "step_1", "manifest.json")) as f:
        jm_ = json.load(f)
    with open(os.path.join(tdir, "step_1", "manifest.json")) as f:
        tm_ = json.load(f)
    assert ([(x["path"], x["shape"], x["dtype"], x["sha1"])
             for x in tm_["leaves"]]
            == [(x["path"], x["shape"], x["dtype"], x["sha1"])
                for x in jm_["leaves"]])
    like = jax.tree.map(jnp.zeros_like, (jp, jstate))
    (rp, rstate), _ = jckpt.restore(like, tdir)
    close(rp, jp, rtol=0, atol=0)
    close(rstate, jstate, rtol=0, atol=0)
    # and the port's params carried through numpy equal JAX's
    back = params_from_numpy(tc, jax.tree.map(np.asarray, rp), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                 tp.parameters()))


def test_bfloat16_checkpoints_restore_in_the_port_only(tmp_path):
    """A known difference of the reference: the JAX restore cannot read a
    bfloat16 leaf (np.load gives |V2, which jnp.asarray refuses); the port
    reads the manifest's dtype and restores it bit for bit, from its own
    checkpoint and from the JAX package's."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    vals = np.random.default_rng(8).normal(size=(3, 5)).astype(
        ml_dtypes.bfloat16)
    jckpt.save({"p": jnp.asarray(vals)}, jdir, 1)
    with pytest.raises(TypeError, match="V2"):
        jckpt.restore({"p": jnp.zeros((3, 5), jnp.bfloat16)}, jdir)
    got = {"p": torch.zeros((3, 5), dtype=torch.bfloat16)}
    tckpt.restore(got, jdir)
    want = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16)
    assert torch.equal(got["p"], want)
    tree = {"layers": [{"w": want.clone()}, {"w": -want}],
            "s": torch.tensor(3, dtype=torch.int32)}
    tckpt.save(tree, tdir, 2)
    with open(os.path.join(tdir, "step_2", "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    assert [(m["path"], m["dtype"]) for m in meta] == [
        ("['layers']['w']", "bfloat16"), ("['s']", "int32")]
    out = {"layers": [{"w": torch.zeros_like(want)} for _ in range(2)],
           "s": torch.tensor(0, dtype=torch.int32)}
    tckpt.restore(out, tdir)
    assert torch.equal(out["layers"][1]["w"], -want) and int(out["s"]) == 3
    bad = {"layers": [{"w": torch.zeros((3, 5))} for _ in range(2)],
           "s": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="bfloat16"):
        tckpt.restore(bad, tdir)


# -- the init rule -------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_init_zeroes_the_leaves_jax_zeroes(name):
    """By JAX path: the JAX init zeroes a leaf whose stacked rank is at most
    1 (ln_f), and draws the per-layer gains and biases, (L, D) there."""
    jc, tc, jm, tm = tiny_pair(name)
    jp = jm.init(0)
    flat, _ = jax.tree_util.tree_flatten_with_path(jp)
    want = {jax.tree_util.keystr(k): not np.asarray(v).any() for k, v in flat}
    got = {p: not any(t.any() for t in ts)
           for p, ts, _ in jax_leaves(tm.init(0, "cpu"))}
    assert list(got) == list(want)
    assert got == want
    assert any(want.values()) and not all(want.values())
