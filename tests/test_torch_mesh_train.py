"""PyTorch port, the sharded train step (``train.train_step`` under a
``distr.shardctx.ShardCtx``), ``distr.sharding.place`` / ``gather``,
``train.checkpoint.restore(shardings=, mesh=)`` and an elastic restart,
on meshes of CPU positions.

One module-scoped fixture runs the JAX package's step in a subprocess with
8 forced host devices (this process keeps its single-device jax):
``tests/test_distributed.py``'s tiny qwen2 (vocab 160, so the embedding
is vocab-sharded; float32), jitted with ``in_shardings=(params,
opt_state, batch)`` under ``use(ShardCtx(mesh))``, two steps from the JAX
init on seeded batches, for AdamW with ``microbatches = 2`` (hoisting off
and on), Adafactor (factoring from 16, four layers so that ``wo``'s
column statistics shard their layer dim) and the (2, 4) and (2, 2, 2)
meshes. The port takes the same params and batches on 8 CPU positions.

Tolerances are ``tests/test_torch_train_step.py``'s (float32 on both
sides, sums in another order): the loss within 1e-5, the gradient norm
within rtol 1e-5, the learning rate equal; the params within 1% of a step
(lr) a step but for at most 1e-4 of them, each within 2 lr a step (Adam's
and Adafactor's steps do not scale with the gradient: an element whose
gradient is rounding, qwen2's ``bk`` here, steps by that rounding's sign);
the optimizer state within 1e-5 plus 1e-4 of its leaf's largest value.

Against the port's own unsharded step (deterministic algorithms on, so
that the CPU's backward sums in one order) the sharded step is bit for bit
where the schedule sums as the unsharded step with ``microbatches`` = data
blocks x microbatches does: the loss, and, while the global norm stays
under the clip (asserted: the norm's partial sums run per block, so its
last bits differ), every param and moment. Adafactor's factored
statistics and RMS sum per block: within the tolerances above.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import get_model as jget_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.distr import sharding as sh
from repro_torch.distr.mesh import Mesh
from repro_torch.distr.shardctx import ShardCtx, use
from repro_torch.launch import dryrun, elastic
from repro_torch.models import get_model, jax_leaves, params_from_numpy
from repro_torch.models.base import tree_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LR = 1e-2
B, S, STEPS = 8, 64, 2
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "2x16": ((2, 16), ("data", "model")),
          "1x16": ((1, 16), ("data", "model"))}
# name: mesh, optimizer, microbatches, hoist, layers
CASES = {"adamw_mb2": ("2x4", "adamw", 2, False, 2),
         "adamw_mb2_hoist": ("2x4", "adamw", 2, True, 2),
         "adafactor": ("2x4", "adafactor", 1, False, 4),
         "adamw_pod": ("2x2x2", "adamw", 1, False, 2),
         "adafactor_pod_mb2": ("2x2x2", "adafactor", 2, False, 4)}
# the same with labels ignored unevenly over the blocks (``uneven``)
UNEVEN = {f"uneven_mb{mb}": ("2x4", "adamw", mb, False, 2, "uneven")
          for mb in (1, 2)}


def tiny(layers=2):
    return dataclasses.replace(
        get_config("qwen2-1.5b"), n_layers=layers, d_model=64, d_ff=128,
        vocab=160, n_heads=4, n_kv_heads=2, head_dim=16, dtype="float32")


def opt_cfg(name):
    return dict(name=name, lr=LR, warmup_steps=1, total_steps=4,
                factored_min_dim=16)


def cpu_mesh(name):
    shape, names = MESHES[name]
    return Mesh(np.full(shape, CPU, dtype=object), names)


def batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 160, (B, S)).astype(np.int32),
             "labels": rng.integers(0, 160, (B, S)).astype(np.int32)}
            for _ in range(STEPS)]


def uneven(bs):
    """``bs`` with labels ignored (-100) unevenly: rows 0-2 half, row 6 a
    quarter, so every part of a (2, 4) step at 1 or 2 microbatches holds
    its own count of valid labels."""
    out = []
    for b in bs:
        labels = b["labels"].copy()
        labels[:3, :S // 2] = -100
        labels[6, :S // 4] = -100
        out.append({"tokens": b["tokens"], "labels": labels})
    return out


_JAX_STEPS = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import dataclasses, json
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_config
from repro.distr import sharding as sh
from repro.distr.shardctx import ShardCtx, use
from repro.models import get_model
from repro.train import optimizer as opt_mod
from repro.train.train_step import make_train_step

I = dict(np.load(sys.argv[1]))
cases, opts = json.loads(str(I["cases"])), json.loads(str(I["opts"]))
devs = np.array(jax.devices()[:8])
meshes = {"2x4": jax.sharding.Mesh(devs.reshape(2, 4), ("data", "model")),
          "2x2x2": jax.sharding.Mesh(devs.reshape(2, 2, 2),
                                     ("pod", "data", "model"))}
out = {}
for name, (mname, optname, mb, hoist, layers, *lab) in cases.items():
    cfg = dataclasses.replace(
        get_config("qwen2-1.5b"), n_layers=layers, d_model=64, d_ff=128,
        vocab=160, n_heads=4, n_kv_heads=2, head_dim=16, dtype="float32")
    model, mesh = get_model(cfg), meshes[mname]
    opt = opt_mod.OptConfig(**opts[optname])
    params = model.init(0)
    state = (opt_mod.adafactor_init(params, opt) if optname == "adafactor"
             else opt_mod.adamw_init(params))
    pshard = sh.param_shardings(params, mesh, vocab=cfg.vocab)
    oshard = sh.opt_state_shardings(state, mesh, vocab=cfg.vocab)
    bshard = sh.batch_shardings(
        {"tokens": jax.ShapeDtypeStruct(I["tokens0"].shape, jnp.int32),
         "labels": jax.ShapeDtypeStruct(I["tokens0"].shape, jnp.int32)},
        mesh)
    step = make_train_step(model, opt, microbatches=mb,
                           hoist_weight_gather=hoist)
    with use(ShardCtx(mesh)):
        fn = jax.jit(step, in_shardings=(pshard, oshard, bshard))
        params = jax.device_put(params, pshard)
        state = jax.device_put(state, oshard)
        for k in range(int(I["steps"])):
            b = {"tokens": jnp.asarray(I[f"tokens{k}"]),
                 "labels": jnp.asarray(I[f"{(lab or ['labels'])[0]}{k}"])}
            params, state, m = fn(params, state, b)
            for key in ("loss", "grad_norm", "lr"):
                out[f"{name}/{key}{k}"] = np.asarray(m[key])
    for tag, tree in (("p", params), ("s", state)):
        for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{name}/{tag}/{jax.tree_util.keystr(kp)}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("JAX_STEPS_OK")
"""


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_mesh_steps")
    src, dst = d / "in.npz", d / "out.npz"
    arrays = {}
    for k, (b, u) in enumerate(zip(batches(), uneven(batches()))):
        arrays[f"tokens{k}"], arrays[f"labels{k}"] = b["tokens"], b["labels"]
        arrays[f"uneven{k}"] = u["labels"]
    np.savez(src, steps=STEPS, cases=json.dumps({**CASES, **UNEVEN}),
             opts=json.dumps({n: opt_cfg(n) for n in ("adamw",
                                                      "adafactor")}),
             **arrays)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_STEPS, str(src),
                        str(dst)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and "JAX_STEPS_OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(dst))


def to_torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def port_start(cfg, optname, device="cpu"):
    """The JAX init's params (carried across) and the port's fresh state."""
    jp = jax.tree.map(np.asarray, jget_model(cfg_jax(cfg)).init(0))
    params = params_from_numpy(cfg, jp, device)
    opt = topt.OptConfig(**opt_cfg(optname))
    state = (topt.adafactor_init(params, opt) if optname == "adafactor"
             else topt.adamw_init(params))
    return params, state, opt


def cfg_jax(cfg):
    from repro.configs.base import get_config as jget_config
    return dataclasses.replace(jget_config(cfg.name), **{
        f: getattr(cfg, f) for f in ("n_layers", "d_model", "d_ff", "vocab",
                                     "n_heads", "n_kv_heads", "head_dim",
                                     "dtype")})


def place_all(cfg, mesh, params, state, batch=None):
    P = sh.place(params, sh.param_shardings(params, mesh, cfg.vocab), mesh)
    St = sh.place(state, sh.opt_state_shardings(state, mesh, cfg.vocab),
                  mesh)
    if batch is None:
        return P, St
    return P, St, place_batch(mesh, batch)


def place_batch(mesh, batch):
    return sh.place(batch, sh.batch_shardings(batch, mesh), mesh)


def mesh_steps(cfg, mesh, P, St, opt, bs, **kw):
    step = make_train_step(get_model(cfg), opt, **kw)
    metrics = []
    with use(ShardCtx(mesh)):
        for b in bs:
            P, St, m = step(P, St, place_batch(mesh, to_torch(b)))
            metrics.append(m)
    return P, St, metrics


def jax_tree_of(tree):
    """``{keystr: array}`` of a port tree (params or state; layers
    stacked)."""
    return {path: np.stack([t.detach().numpy() for t in ts]) if stacked
            else ts[0].detach().numpy()
            for path, ts, stacked in jax_leaves(tree)}


def params_close(got, want, steps):
    d = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert (d > 0.01 * LR * steps).sum() <= 1e-4 * d.size
    assert d.max() <= 2 * LR * steps


def state_close(got, want):
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].astype(np.float32), w.astype(np.float32), rtol=0,
            atol=1e-5 + 1e-4 * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_matches_jax(jax_steps, case):
    mname, optname, mb, hoist, layers = CASES[case]
    cfg, mesh = tiny(layers), cpu_mesh(mname)
    params, state, opt = port_start(cfg, optname)
    P, St = place_all(cfg, mesh, params, state)
    P, St, ms = mesh_steps(cfg, mesh, P, St, opt, batches(),
                           microbatches=mb, hoist_weight_gather=hoist)
    for k, m in enumerate(ms):
        np.testing.assert_allclose(float(m["loss"]),
                                   float(jax_steps[f"{case}/loss{k}"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jax_steps[f"{case}/grad_norm{k}"]),
                                   rtol=1e-5)
        assert float(m["lr"]) == float(jax_steps[f"{case}/lr{k}"])
        assert m["collectives"]["all-gather"]["bytes"] > 0
    got_p = {"[0]" + k: v for k, v in jax_tree_of(sh.gather(P)).items()}
    got_s = {"[1]" + k: v for k, v in jax_tree_of(sh.gather(St)).items()}
    want_p = {"[0]" + k[len(case) + 3:]: v for k, v in jax_steps.items()
              if k.startswith(f"{case}/p/")}
    want_s = {"[1]" + k[len(case) + 3:]: v for k, v in jax_steps.items()
              if k.startswith(f"{case}/s/")}
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    params_close(got_p, want_p, STEPS)
    state_close(got_s, want_s)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("mname,optname,mb,hoist", [
    ("2x4", "adamw", 1, False), ("2x4", "adamw", 2, False),
    ("2x4", "adamw", 2, True), ("2x2x2", "adamw", 1, False),
    ("1x16", "adamw", 2, False), ("2x4", "adafactor", 1, False),
    ("2x2x2", "adafactor", 2, False)])
def test_mesh_step_equals_unsharded_step(deterministic, mname, optname, mb,
                                         hoist):
    """The sharded step against the unsharded one with ``microbatches`` =
    data blocks x ``mb`` on the same params and batches: bit for bit for
    AdamW (the norm under the clip, asserted), within the tolerances for
    Adafactor (its statistics sum per block)."""
    layers = 4 if optname == "adafactor" else 2
    cfg, mesh = tiny(layers), cpu_mesh(mname)
    nd = int(np.prod([mesh.shape[a] for a in sh.data_axes(mesh)]))
    params, state, opt = port_start(cfg, optname)
    P, St = place_all(cfg, mesh, params, state)
    ref_p, ref_s, _ = port_start(cfg, optname)
    ref = make_train_step(get_model(cfg), opt, microbatches=nd * mb,
                          hoist_weight_gather=hoist)
    P, St, ms = mesh_steps(cfg, mesh, P, St, opt, batches(),
                           microbatches=mb, hoist_weight_gather=hoist)
    for k, (b, m) in enumerate(zip(batches(), ms)):
        ref_p, ref_s, rm = ref(ref_p, ref_s, to_torch(b))
        if optname == "adamw" or k == 0:
            assert float(m["loss"]) == float(rm["loss"])
        else:       # Adafactor's first update differs in rounding
            np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                       rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        assert float(rm["grad_norm"]) < opt.clip_norm
    got = tree_leaves(sh.gather(P)) + tree_leaves(sh.gather(St))
    want = tree_leaves(ref_p) + tree_leaves(ref_s)
    if optname == "adamw":
        assert all(torch.equal(g, w.detach()) for g, w in zip(got, want))
    else:
        params_close(jax_tree_of(sh.gather(P)), jax_tree_of(ref_p), STEPS)
        state_close(jax_tree_of(sh.gather(St)), jax_tree_of(ref_s))


@pytest.mark.parametrize("mb", [1, 2])
def test_loss_is_the_mean_of_the_blocks_means(jax_steps, mb):
    """With labels ignored (-100) unevenly over the data blocks, the mesh
    step's loss is the JAX step's: the mean of each microbatch's mean over
    its valid labels, so each part's mean weighs by its share of its JAX
    microbatch's valid labels (on (2, 4) at ``microbatches`` 2: D = 2
    blocks of M = 2 parts). Two steps against the JAX step within
    ``test_mesh_step_matches_jax``'s tolerances: the loss, the gradient
    norm and the params."""
    case = f"uneven_mb{mb}"
    mname, optname, _, hoist, layers, _ = UNEVEN[case]
    cfg, mesh = tiny(layers), cpu_mesh(mname)
    params, state, opt = port_start(cfg, optname)
    P, St = place_all(cfg, mesh, params, state)
    P, St, ms = mesh_steps(cfg, mesh, P, St, opt, uneven(batches()),
                           microbatches=mb, hoist_weight_gather=hoist)
    for k, m in enumerate(ms):
        np.testing.assert_allclose(float(m["loss"]),
                                   float(jax_steps[f"{case}/loss{k}"]),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jax_steps[f"{case}/grad_norm{k}"]),
                                   rtol=1e-5)
    got_p = {"[0]" + k: v for k, v in jax_tree_of(sh.gather(P)).items()}
    want_p = {"[0]" + k[len(case) + 3:]: v for k, v in jax_steps.items()
              if k.startswith(f"{case}/p/")}
    assert got_p.keys() == want_p.keys()
    params_close(got_p, want_p, STEPS)


def test_place_gather_round_trip_and_sharing():
    """``gather(place(x))`` is ``x`` bit for bit; positions on one device
    holding the same block share one tensor (a replicated leaf is held
    once); a block is a view of the placed tensor there."""
    cfg, mesh = tiny(), cpu_mesh("2x4")
    params, state, _ = port_start(cfg, "adamw")
    specs = sh.param_shardings(params, mesh, cfg.vocab)
    P = sh.place(params, specs, mesh)
    assert all(torch.equal(a, b.detach()) for a, b in zip(
        tree_leaves(sh.gather(P)), tree_leaves(params)))
    ln = P["ln_f"]                              # (64,): "model" only
    assert ln.spec == ("model",)
    assert len(ln.local()) == 4 and len({id(t) for t in ln.blocks}) == 4
    assert ln.blocks[0] is ln.blocks[4]          # data rows share it
    bias = P["layers"][0]["attn"]["bk"]           # (32,): over model
    assert len({id(t) for t in bias.blocks}) == len(bias.local())
    tok = P["embed"]["tok"]                       # (160, 64): vocab-sharded
    assert tok.spec == ("model", "data")
    assert len(tok.local()) == 8
    assert tok.blocks[1].data_ptr() == params["embed"]["tok"][40:80, 0:32] \
        .data_ptr()
    held = sum(sh.position_bytes(P, pos) for pos in range(mesh.size))
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert total <= held <= 4 * total
    step = sh.place_leaf(torch.tensor(3, dtype=torch.int32), (), mesh)
    assert len({id(t) for t in step.blocks}) == 1


def test_position_bytes_equal_the_dryrun_accounting():
    """What the train_mesh phase checks on the card: each position's bytes
    of the placed params, optimizer state and batch equal the dry-run's
    argument bytes for that mesh and batch, and the step's collectives
    equal the dry-run's."""
    cfg = dataclasses.replace(tiny(), microbatches=1)
    for mname in ("2x4", "2x2x2", "2x16"):
        mesh = cpu_mesh(mname)
        params, state, opt = port_start(cfg, "adamw")
        b = batches()[0]
        P, St, Bt = place_all(cfg, mesh, params, state, to_torch(b))
        lay = dryrun.model_layout(cfg, ShapeConfig("t", S, B, "train"),
                                  mesh, activations=False)
        held = {sh.position_bytes((P, St, Bt), pos)
                for pos in range(mesh.size)}
        assert held == {lay["argument_bytes_per_position"]}, mname
        step = make_train_step(get_model(cfg), topt.OptConfig())
        with use(ShardCtx(mesh)):
            _, _, m = step(P, St, Bt)
        assert m["collectives"] == lay["collectives"], mname


def test_restore_onto_a_mesh(tmp_path):
    """``restore(shardings=, mesh=)`` from the port's checkpoint and from
    the JAX package's: the template may be meta tensors or ``Spec``
    records; the placed tree gathers to the saved one bit for bit; a
    placed tree saves in the same layout (each package reads it)."""
    cfg, mesh = tiny(), cpu_mesh("2x4")
    params, state, _ = port_start(cfg, "adamw")
    model = get_model(cfg)
    ckpt.save((params, state), str(tmp_path / "port"), 3)
    like = (model.param_specs(), topt.adamw_init(sh.as_meta(
        model.param_specs())))
    specs = (sh.param_shardings(like[0], mesh, cfg.vocab),
             sh.opt_state_shardings(like[1], mesh, cfg.vocab))
    placed, at = ckpt.restore(like, str(tmp_path / "port"),
                              shardings=specs, mesh=mesh)
    assert at == 3
    want = tree_leaves((params, state))
    assert all(torch.equal(a, b.detach()) for a, b in zip(
        tree_leaves(sh.gather(placed)), want))
    ckpt.save(placed, str(tmp_path / "placed"), 4)
    jtree, _ = jckpt.restore(
        jax.tree.map(np.asarray, (jget_model(cfg_jax(cfg)).init(0),
                                  jopt.adamw_init(jget_model(
                                      cfg_jax(cfg)).init(0)))),
        str(tmp_path / "placed"))
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(
        jax.tree.leaves(jtree),
        [np.stack([t.detach().numpy() for t in ts]) if s else
         ts[0].detach().numpy() for _, ts, s in jax_leaves((params, state))]))
    jckpt.save(jtree, str(tmp_path / "jax"), 5)
    placed, at = ckpt.restore(like, str(tmp_path / "jax"), shardings=specs,
                              mesh=mesh)
    assert at == 5 and all(torch.equal(a, b.detach()) for a, b in zip(
        tree_leaves(sh.gather(placed)), want))
    with pytest.raises(ValueError):
        ckpt.restore(like, str(tmp_path / "jax"), shardings=specs)


def test_elastic_restart_onto_a_smaller_mesh(tmp_path, deterministic):
    """Four workers of 8 CPU positions hold a (2, 16) mesh; one stops its
    heartbeats; the policy plans (1, 16); the same checkpoint restored onto
    it, stepped with ``microbatches = 2``, equals the (2, 16) step with one
    microbatch a block, and both equal the unsharded step."""
    cfg = tiny()
    params, state, opt = port_start(cfg, "adamw")
    model = get_model(cfg)
    ckpt.save((params, state), str(tmp_path), 1)
    t = [0.0]
    pol = elastic.RestartPolicy(timeout_s=10, clock=lambda: t[0])
    for w in range(4):
        pol.heartbeat(f"w{w}", 1.0)
    t[0] = 8.0
    for w in range(3):
        pol.heartbeat(f"w{w}", 1.0)
    t[0] = 16.0
    assert pol.should_restart() and pol.dead_workers() == ["w3"]
    shape, axes = pol.plan_restart(chips_per_worker=8)
    assert (shape, axes) == ((1, 16), ("data", "model"))
    like = (model.param_specs(), topt.adamw_init(sh.as_meta(
        model.param_specs())))
    out = {}
    for mname, mb in (("2x16", 1), (f"{shape[0]}x{shape[1]}", 2)):
        mesh = cpu_mesh(mname)
        specs = (sh.param_shardings(like[0], mesh, cfg.vocab),
                 sh.opt_state_shardings(like[1], mesh, cfg.vocab))
        (P, St), _ = ckpt.restore(like, str(tmp_path), shardings=specs,
                                  mesh=mesh)
        P, St, ms = mesh_steps(cfg, mesh, P, St, opt, batches()[:1],
                               microbatches=mb)
        out[mname] = (float(ms[0]["loss"]),
                      tree_leaves(sh.gather((P, St))))
    ref_p, ref_s, _ = port_start(cfg, "adamw")
    ref_p, ref_s, rm = make_train_step(model, opt, microbatches=2)(
        ref_p, ref_s, to_torch(batches()[0]))
    want = tree_leaves((ref_p, ref_s))
    for loss, leaves in out.values():
        assert loss == float(rm["loss"])
        assert all(torch.equal(a, b.detach()) for a, b in zip(leaves, want))


@pytest.mark.parametrize("mname", ["2x4", "2x2x2"])
def test_mesh_step_with_compression_equals_unsharded_step(deterministic,
                                                          mname):
    """int8 gradient compression with error feedback on the mesh: one
    absmax scale a JAX leaf over its distinct blocks (a max, exact), so
    the sharded step with one microbatch a data block equals the unsharded
    one with ``microbatches`` = data blocks bit for bit, the residuals
    too (the norm under the clip, asserted)."""
    cfg, mesh = tiny(), cpu_mesh(mname)
    nd = int(np.prod([mesh.shape[a] for a in sh.data_axes(mesh)]))
    params, state, opt = port_start(cfg, "adamw")
    P, St = place_all(cfg, mesh, params, state)
    ref_p, ref_s, _ = port_start(cfg, "adamw")
    model = get_model(cfg)
    ref = make_train_step(model, opt, microbatches=nd, compress_grads=True)
    step = make_train_step(model, opt, compress_grads=True)
    err = ref_err = None
    for b in batches():
        with use(ShardCtx(mesh)):
            P, St, m, err = step(P, St, place_batch(mesh, to_torch(b)), err)
        ref_p, ref_s, rm, ref_err = ref(ref_p, ref_s, to_torch(b), ref_err)
        assert float(m["loss"]) == float(rm["loss"])
        assert float(rm["grad_norm"]) < opt.clip_norm
        assert m["collectives"]["all-reduce"]["count"] > 0
    got = tree_leaves(sh.gather((P, St, err)))
    want = tree_leaves((ref_p, ref_s, ref_err))
    assert all(torch.equal(g, w.detach()) for g, w in zip(got, want))
