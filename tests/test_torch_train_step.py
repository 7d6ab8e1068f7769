"""PyTorch port, the training path, held against the JAX package: every
family's loss and gradients at ``tests/test_arch_smoke.py``'s ``tiny_of``
shapes (params carried across by ``models.params_from_numpy``), with remat
on and off; ``make_train_step`` with and without microbatches, hoisting and
compression; ``launch.train`` on the CPU.

Tolerances (float32 on both sides, sums in another order): the loss within
1e-5 (at most 4.8e-7 measured); each gradient leaf within 1e-5 absolute
plus 1e-4 of the leaf's largest JAX value (at most 1e-6 of it measured;
llama4's top-1 router's gradient is rounding, under 1e-10 on both sides,
so only the 1e-5 holds it); params after the train steps within 1% of
one step's size (lr) a step, but for at most 1e-4 of them, each within 2
lr a step. Adam's step m / sqrt(v) does not scale with the gradient, so
where an element's gradient is at rounding level, or small at one step
and large at the next, the rounding of sums in another order moves its
step: here by up to 0.25% of a step (measured at lr 1e-2: 2.5e-5 in
qwen2's ``bk``, every other leaf under 5e-6); on the card against the CPU
one element in 1e5 has passed 1% (``chip_smoke.py``'s ``train_parity``).
Remat on and off are equal bit for bit (the same kernels recompute the
same values).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCHS, ShapeConfig
from repro.models import get_model as jget_model
from repro.models.base import cross_entropy as jcross_entropy
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import train as ttrain
from repro_torch.models import (cross_entropy, get_model, jax_leaves,
                                params_from_numpy, params_to_numpy)
from repro_torch.models.base import tree_leaves, tree_unflatten
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step
from test_arch_smoke import TINY_SHAPE, tiny_of


def tree_close(got, want, rel=1e-4, atol=1e-5, what=""):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            np.asarray(g, np.float32), w, rtol=0,
            atol=atol + rel * float(np.abs(w).max()),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def batch_of(cfg, seed):
    """A training batch at TINY_SHAPE (llava's text shortened by its image
    tokens), labels with a few -100s."""
    rng = np.random.default_rng(seed)
    B, S = TINY_SHAPE.global_batch, TINY_SHAPE.seq_len
    if cfg.family == "llava":
        S -= cfg.n_image_tokens
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    b["labels"][0, :3] = -100
    if cfg.family == "whisper":
        b["frames"] = rng.normal(size=(B, cfg.n_audio_frames,
                                       cfg.d_frontend)).astype(np.float32)
    if cfg.family == "llava":
        b["patches"] = rng.normal(size=(B, cfg.n_image_tokens,
                                        cfg.d_frontend)).astype(np.float32)
    return b


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_side():
    """name -> (JAX cfg, JAX params as numpy, batch, loss, grads as numpy):
    one jitted value_and_grad a family, shared by the remat cases."""
    cache = {}

    def get(name):
        if name not in cache:
            jc = tiny_of(name)
            jm = jget_model(jc)
            jp = jm.init(0)
            batch = batch_of(jc, 1)
            loss, grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[name] = (jc, jax.tree.map(np.asarray, jp), batch,
                           float(loss), jax.tree.map(np.asarray, grads))
        return cache[name]

    return get


def port_cfg(jc, **kw):
    return dataclasses.replace(tget_config(jc.name),
                               **{**dataclasses.asdict(jc), **kw})


def port_loss_and_grads(tc, jp, batch):
    tm = get_model(tc)
    tp = params_from_numpy(tc, jp, "cpu")
    tp.requires_grad_(True)
    loss = tm.loss_fn(tp, to_torch(batch))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    return tp, loss, grads


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(jax_side, name, remat):
    """whisper runs its encoder on the frames; llava pads its labels over
    the image positions with -100 and casts its patches to the stream's
    dtype; every family's layers are rematerialised under remat."""
    jc, jp, batch, jloss, jgrads = jax_side(name)
    tc = port_cfg(jc, remat=remat)
    tp, loss, grads = port_loss_and_grads(tc, jp, batch)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=0, atol=1e-5)
    got = params_to_numpy(tc, tree_unflatten(tp, [g.detach() for g in grads]))
    tree_close(got, jgrads, what=name)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "mixtral-8x7b", "rwkv6-3b",
                                  "zamba2-1.2b", "whisper-medium"])
def test_remat_changes_nothing(jax_side, name):
    jc, jp, batch, _, _ = jax_side(name)
    on = port_loss_and_grads(port_cfg(jc, remat=True), jp, batch)
    off = port_loss_and_grads(port_cfg(jc, remat=False), jp, batch)
    assert torch.equal(on[1], off[1])
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


@pytest.mark.parametrize("name", ARCHS)
def test_train_input_specs_match_jax(name):
    jc = tiny_of(name)
    tc = port_cfg(jc)
    want = jget_model(jc).train_input_specs(ShapeConfig("t", 32, 4, "train"))
    got = get_model(tc).train_input_specs(TShapeConfig("t", 32, 4, "train"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)


def test_cross_entropy_matches_jax():
    """float32 over bfloat16 logits, -100 excluded, an all-ignored batch 0."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[1, 2:] = -100
    want = jcross_entropy(jnp.asarray(logits, jnp.bfloat16),
                          jnp.asarray(labels))
    got = cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                        torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = torch.full((2, 3), -100, dtype=torch.int32)
    assert float(cross_entropy(torch.randn(2, 3, 4), none)) == 0.0


# -- the train step ---------------------------------------------------------------
STEP_CASES = [
    ("plain", "qwen2-1.5b", {}),
    ("microbatches", "qwen2-1.5b", {"microbatches": 2}),
    ("hoisted", "qwen2-1.5b", {"microbatches": 2,
                               "hoist_weight_gather": True}),
    ("compressed", "gemma2-9b", {"compress_grads": True}),
    ("adafactor", "llama4-maverick-400b-a17b", {}),
]
ROUTER = "['layers']['moe']['router']"
LR = 1e-2


def state_leaves(state):
    """Optimizer state as the JAX package's leaves (layers stacked), in
    its order."""
    return [np.stack([t.numpy() for t in ts]) if stacked else ts[0].numpy()
            for _, ts, stacked in jax_leaves(state)]


@pytest.mark.parametrize("case,name,kw", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_train_step_matches_jax(case, name, kw):
    """Steps from the same params and batches: the metrics (loss, grad
    norm, lr at the new step), the params, the optimizer state and
    compression's residuals. Microbatched grads are float32 accumulators
    into the update; the hoisted form is the gradient of the mean loss.

    llama4 routes top-1, so its renormalised routing weight is p / p = 1:
    the router's gradient is zero up to rounding (under 1e-10 here) in both
    packages, and Adafactor's first step, g / |g|, moves it by the sign of
    that rounding. Its router is held to that bound instead of to JAX's
    params, and one step is compared (the next routes on the moved
    router)."""
    jc = tiny_of(name)
    jm, tc = jget_model(jc), port_cfg(jc)
    tm = get_model(tc)
    opt = dict(name=jc.optimizer, lr=LR, warmup_steps=1, total_steps=4)
    jstep = jax.jit(jmake_train_step(jm, jopt.OptConfig(**opt), **kw))
    tstep = make_train_step(tm, topt.OptConfig(**opt), **kw)
    jp = jm.init(0)
    js = jopt.init_fn(jc.optimizer)(jp)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    ts = topt.init_fn(jc.optimizer)(tp)
    top1 = jc.family == "moe" and jc.experts_per_token == 1
    steps = 1 if top1 else 2
    jerr = terr = None
    for step in range(steps):
        batch = batch_of(jc, 10 + step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if top1:
            g = jax.grad(jm.loss_fn)(jp, jb)["layers"]["moe"]["router"]
            assert float(jnp.abs(g).max()) < 1e-10
        if kw.get("compress_grads"):
            jp, js, jmet, jerr = jstep(jp, js, jb, jerr)
            tp, ts, tmet, terr = tstep(tp, ts, to_torch(batch), terr)
        else:
            jp, js, jmet = jstep(jp, js, jb)
            tp, ts, tmet = tstep(tp, ts, to_torch(batch))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
        assert float(tmet["lr"]) == float(jmet["lr"])
    assert int(ts["step"]) == steps
    got = dict(zip((p for p, _, _ in jax_leaves(tp)),
                   jax.tree.leaves(params_to_numpy(tc, tp))))
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got.keys() == want.keys()
    if top1:
        moved = np.abs(got.pop(ROUTER) - want.pop(ROUTER))
        assert moved.max() <= 2 * LR * 1.001
    d = np.concatenate([np.abs(np.asarray(g, np.float32) - w).ravel()
                        for g, w in zip(got.values(), want.values())])
    assert (d > 0.01 * LR * steps).sum() <= 1e-4 * d.size, case
    assert d.max() <= 2 * LR * steps, case
    state = [(p, a) for (p, _, _), a in zip(jax_leaves(ts), state_leaves(ts))
             if not (top1 and "['router']" in p)]
    jstate = [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
              jax.tree_util.tree_flatten_with_path(js)[0]
              if not (top1 and "['router']" in jax.tree_util.keystr(k))]
    assert [p for p, _ in state] == [p for p, _ in jstate]
    tree_close([a for _, a in state], [a for _, a in jstate], what=case)
    if terr is not None:
        tree_close(params_to_numpy(tc, terr), jerr, what=case)


# -- the entry point ---------------------------------------------------------------
def test_train_main_descends_and_resumes(tmp_path):
    """14 steps with a checkpoint at step 7; then the run is restarted as if
    it had died before its last save: it resumes at 7 and its last 7 losses
    and final params equal the uninterrupted run's."""
    argv = ["--device", "cpu", "--arch", "qwen2-1.5b", "--batch", "4",
            "--seq", "32", "--steps", "14", "--ckpt-dir", str(tmp_path)]
    full = ttrain.run(argv + ["--ckpt-every", "7"])
    assert len(full.losses) == 14 and full.losses[-1] < full.losses[0]
    assert ttrain.ckpt.latest_step(str(tmp_path)) == 14
    with open(tmp_path / "LATEST", "w") as f:
        f.write("7")
    resumed = ttrain.run(argv + ["--resume"])
    assert resumed.start == 7 and len(resumed.losses) == 7
    assert resumed.losses == full.losses[7:]
    assert all(torch.equal(a, b) for a, b in zip(
        resumed.params.parameters(), full.params.parameters()))
    # as the JAX entry point's test: resumed at the saved 14, two steps run
    more = ttrain.main(argv[:8] + ["--steps", "16", "--ckpt-dir",
                                   str(tmp_path), "--resume"])
    assert len(more) == 2


@pytest.mark.parametrize("flags", [["--microbatches", "2"],
                                   ["--compress-grads", "1"]])
def test_train_main_options_run_on_cpu(flags, capsys):
    losses = ttrain.main(["--device", "cpu", "--arch", "zamba2-1.2b",
                          "--steps", "3", "--batch", "2", "--seq", "8"]
                         + flags)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert "[train] done: 3 steps" in capsys.readouterr().out


def test_train_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.main(["--steps", "1"])
