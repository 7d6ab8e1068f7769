"""PyTorch port, the models' sharding policy held against the JAX package:
``distr.sharding`` (the specs of every param, optimizer-state, batch and
cache leaf of every arch at its published widths, shapes only), the
activation annotations of ``distr.shardctx`` (the ordered logs of one
forward of each family), ``launch.elastic`` and the model cells of
``launch.dryrun``, on the CPU.

The JAX functions run in this process: they read a mesh's ``shape`` and
``axis_names`` only, so a duck mesh stands for the production meshes, and
``NamedSharding`` is replaced by a box holding its spec while the JAX
``*_shardings`` functions run. The annotation logs come from a recording
subclass of the JAX ``ShardCtx`` that logs what ``constrain`` would apply
and returns its array; each family's forward runs eagerly at
``tests/test_arch_smoke.py``'s ``tiny_of`` widths with each layer stack
cut to one layer (a JAX scan traces its body once, the port runs it once a
layer: with one layer each both log every annotation once).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import shapes_for as jshapes_for
from repro.distr import sharding as jsh
from repro.distr import shardctx as jsc
from repro.launch import elastic as jelastic
from repro.models import get_model as jget_model
from repro.train import optimizer as jopt
from repro_torch.configs.base import ARCHS, SHAPES, get_config
from repro_torch.distr import sharding as sh
from repro_torch.distr import shardctx as tsc
from repro_torch.distr.mesh import Mesh
from repro_torch.launch import dryrun, elastic
from repro_torch.models import get_model, jax_leaves, params_from_numpy
from repro_torch.models.base import tree_map
from repro_torch.train import optimizer as topt
from test_arch_smoke import tiny_of

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class Duck:
    """What the JAX policy reads of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


class Box:
    """``NamedSharding(mesh, spec)`` kept as its spec (a pytree leaf)."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


@pytest.fixture
def jax_boxes(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", Box)


def duck(name):
    return Duck(*MESHES[name])


def port_mesh(name):
    shape, names = MESHES[name]
    return Mesh(np.full(shape, torch.device("meta"), dtype=object), names)


def jax_specs(tree):
    """``{keystr: spec}`` of a tree of ``Box`` leaves."""
    return {jax.tree_util.keystr(k): v.spec for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_specs(tree, shardings):
    """``{JAX keystr: JAX spec}`` of a port tree and its shardings."""
    meta = sh.as_meta(tree)
    spec_of = {}
    tree_map(lambda t, s: spec_of.setdefault(id(t), s), meta, shardings)
    return {path: sh.stacked_spec([spec_of[id(t)] for t in ts], stacked)
            for path, ts, stacked in jax_leaves(meta)}


def jax_order(tree, *rest):
    """The leaves of a batch or cache tree (with ``rest``'s alongside) in
    ``jax.tree.leaves``'s order: dict keys sorted, lists and tuples in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in jax_order(tree[k], *(r[k] for r in rest))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, sh.Spec):
        return [x for i, v in enumerate(tree)
                for x in jax_order(v, *(r[i] for r in rest))]
    return [(tree,) + tuple(rest)]


def port_flat(tree, shardings):
    """``[spec]`` of a batch or cache tree, in JAX's leaf order."""
    return [tuple(s) for _, s in jax_order(sh.as_meta(tree), shardings)]


# -- param / optimizer state / batch / cache specs ------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_jax(arch, mesh, jax_boxes):
    """Every param leaf and optimizer-state leaf (the arch's optimizer) of
    the published config: the port's specs, read back as the JAX leaves'
    (layer dims restored), equal the JAX policy's."""
    assert ARCHS == JARCHS
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm, tm = jget_model(jcfg), get_model(cfg)
    jp = jm.param_specs()
    want = jax_specs(jsh.param_shardings(jp, duck(mesh), vocab=jcfg.vocab))
    tp = tm.param_specs()
    got = port_specs(tp, sh.param_shardings(tp, port_mesh(mesh), cfg.vocab))
    assert got == want
    jstate = jax.eval_shape(jopt.init_fn(jcfg.optimizer), jp)
    want = jax_specs(jsh.opt_state_shardings(jstate, duck(mesh),
                                             vocab=jcfg.vocab))
    tstate = topt.init_fn(cfg.optimizer)(sh.as_meta(tp))
    got = port_specs(tstate, sh.opt_state_shardings(
        tstate, port_mesh(mesh), cfg.vocab))
    assert got == want


def _cells():
    return [(a, s.name) for a in ARCHS for s in jshapes_for(jget_config(a))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _cells())
def test_batch_and_cache_specs_match_jax(arch, shape, mesh, jax_boxes):
    """Each cell's batch (train / prefill) and decode inputs and caches,
    with ``seq_to_model`` on and off."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    jm, tm = jget_model(jcfg), get_model(cfg)
    js, ts = JSHAPES[shape], SHAPES[shape]
    jb, tb = jm.train_input_specs(js), tm.train_input_specs(ts)
    assert port_flat(tb, sh.batch_shardings(tb, port_mesh(mesh))) == [
        v.spec for v in jax.tree.leaves(jsh.batch_shardings(jb, duck(mesh)))]
    if js.kind != "decode":
        return
    jb, tb = jm.decode_input_specs(js), tm.decode_input_specs(ts)
    assert port_flat(tb, sh.batch_shardings(tb, port_mesh(mesh))) == [
        v.spec for v in jax.tree.leaves(jsh.batch_shardings(jb, duck(mesh)))]
    jc = jm.cache_specs(js.global_batch, js.seq_len)
    tc = tm.cache_specs(ts.global_batch, ts.seq_len)
    assert [tuple(x.shape) for x, in jax_order(sh.as_meta(tc))] == [
        tuple(x.shape) for x in jax.tree.leaves(jc)]
    for s2m in (True, False):
        got = port_flat(tc, sh.cache_shardings(tc, port_mesh(mesh),
                                               ts.global_batch, s2m))
        want = [v.spec for v in jax.tree.leaves(jsh.cache_shardings(
            jc, duck(mesh), js.global_batch, seq_to_model=s2m))]
        assert got == want


def test_stacked_leaf_with_sharded_layers():
    """Where the JAX spec shards a stacked leaf's layer dim (llama4's 48
    layers over "model" = 16, on Adafactor's ``vc`` of ``wo``), each layer
    is held by the positions of its layer block only, and the JAX spec
    reads back."""
    cfg = get_config("llama4-maverick-400b-a17b")
    mesh = port_mesh("16x16")
    tp = get_model(cfg).param_specs()
    state = topt.init_fn("adafactor")(sh.as_meta(tp))
    specs = sh.opt_state_shardings(state, mesh, cfg.vocab)
    vc = [layer["attn"]["wo"]["vc"] for layer in specs["acc"]["layers"]]
    assert all(isinstance(s, sh.LayerSpec) for s in vc)
    assert [s.layer_block for s in vc] == [i // 3 for i in range(48)]
    assert jsh.param_pspec("['acc']['layers']['attn']['wo']['vc']",
                           (48, cfg.d_model), duck("16x16")) == \
        jax.sharding.PartitionSpec("model", "data")
    cpu = Mesh(np.full((2, 4), torch.device("cpu"), dtype=object),
               ("data", "model"))
    spec = sh.LayerSpec(("data",), ("model",), 1)
    x = sh.place_leaf(torch.arange(8.0), spec, cpu)
    held = [pos for pos in range(8) if x.blocks[pos] is not None]
    assert held == [1, 5]                   # model index 1, both data rows
    assert torch.equal(sh.gather_leaf(x), torch.arange(8.0))


# -- activation annotations ---------------------------------------------------------
class Recording(jsc.ShardCtx):
    """The JAX context, logging each constraint instead of applying it."""

    def __init__(self, mesh, rules=None):
        super().__init__(mesh, rules)
        self.log = []

    def constrain(self, x, *logical):
        if any(self.rules.get(l) == "skip" for l in logical if l):
            return x
        self.log.append((tuple(logical), tuple(x.shape),
                         tuple(self.pspec(x.shape, *logical))))
        return x


def one_layer(jc):
    kw = {"n_layers": 1}
    if jc.family == "whisper":
        kw["encoder_layers"] = 1
    if jc.family == "zamba2":
        kw = {"n_layers": 2, "shared_attn_every": 1}
    return dataclasses.replace(jc, **kw)


def port_cfg(jc):
    return dataclasses.replace(get_config(jc.name), **{
        f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)})


@pytest.mark.parametrize("arch", ARCHS)
def test_annotation_logs_match_jax(arch):
    """One loss forward of each family: the ordered ``(logical axes,
    shape, spec)`` of every annotation, JAX's against the port's, on a
    (2, 4) and a (2, 2, 2) mesh (one forward each side: the log's specs are
    computed per mesh from its axes and shapes); the port's loss is the
    same with and without a context (``shard`` returns its tensor)."""
    jc = one_layer(tiny_of(arch))
    tc = port_cfg(jc)
    jm, tm = jget_model(jc), get_model(tc)
    rng = np.random.default_rng(0)
    B, S = 4, 16
    s = S - (jc.n_image_tokens if jc.family == "llava" else 0)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, s)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (B, s)).astype(np.int32)}
    if jc.family == "whisper":
        batch["frames"] = rng.normal(size=(B, jc.n_audio_frames,
                                           jc.d_frontend)).astype(np.float32)
    if jc.family == "llava":
        batch["patches"] = rng.normal(size=(B, jc.n_image_tokens,
                                            jc.d_frontend)).astype(np.float32)
    jp = jm.init(0)
    rec = Recording(duck("2x4"))
    with jsc.use(rec):
        jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ctx = tsc.ShardCtx(port_mesh("2x4"))
    with torch.no_grad():
        plain = tm.loss_fn(tp, tb)
        with tsc.use(ctx):
            logged = tm.loss_fn(tp, tb)
    assert rec.log and ctx.log == rec.log
    assert torch.equal(plain, logged)
    assert tsc.get() is None
    j = jsc.ShardCtx(duck("2x2x2"))
    t = tsc.ShardCtx(port_mesh("2x2x2"))
    assert [t.pspec(s, *lg) for lg, s, _ in ctx.log] == [
        tuple(j.pspec(s, *lg)) for lg, s, _ in rec.log]


def test_shardctx_rules_match_jax():
    """``axes_for``'s progressive drop, ``pspec``'s first-annotation-wins
    and rule overrides, on shapes that exercise each."""
    cases = [((8, 16, 64), ("batch", None, "embed")),
             ((2, 16, 64), ("batch", "seq", "ff")),
             ((6, 3, 64), ("batch", None, "vocab")),
             ((16, 64, 4), ("batch", "embed", "heads")),
             ((32, 8), ("seq_full", "embed")),
             ((4, 16), ("seq_shard", "embed"))]
    for mesh in MESHES:
        for rules in (None, {"batch": ("data",), "seq": ("model",)}):
            j = jsc.ShardCtx(duck(mesh), rules)
            t = tsc.ShardCtx(port_mesh(mesh), rules)
            for shape, lg in cases:
                assert t.pspec(shape, *lg) == tuple(j.pspec(shape, *lg))
                assert all(t.axes_for(l, d) == j.axes_for(l, d)
                           for l, d in zip(lg, shape))


# -- elastic --------------------------------------------------------------------------
@pytest.mark.parametrize("chips", [8, 15, 16, 17, 24, 100, 192, 255, 256,
                                   257, 300, 511, 512, 513, 768, 1000, 4096])
def test_plan_mesh_matches_jax(chips):
    for kw in ({}, {"model_degree": 8}, {"pod_size": 128}):
        try:
            want = jelastic.plan_mesh(chips, **kw)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                elastic.plan_mesh(chips, **kw)
            continue
        assert elastic.plan_mesh(chips, **kw) == want


def test_plan_mesh_cases():
    assert elastic.plan_mesh(512) == ((2, 16, 16), ("pod", "data", "model"))
    assert elastic.plan_mesh(256) == ((16, 16), ("data", "model"))
    assert elastic.plan_mesh(192) == ((12, 16), ("data", "model"))
    with pytest.raises(RuntimeError):
        elastic.plan_mesh(8)


def _fleet(module, chips_per_worker):
    """``tests/test_substrate.py``'s fleet under a fake clock: w3 stops
    beating, w2 straggles. Everything the policy answers, in order."""
    t = [0.0]
    pol = module.RestartPolicy(timeout_s=10, straggler_factor=2.0,
                               clock=lambda: t[0])
    for w in ("w0", "w1", "w2", "w3"):
        pol.heartbeat(w, 1.0)
    t[0] = 8.0
    for w in ("w0", "w1", "w2"):
        pol.heartbeat(w, 1.0 if w != "w2" else 5.0)
    t[0] = 16.0
    out = [pol.dead_workers(), pol.stragglers(), pol.should_restart()]
    try:
        out.append(pol.plan_restart(chips_per_worker=chips_per_worker))
    except RuntimeError as e:
        out.append(str(e))
    out += [sorted(pol.cordoned), pol.dead_workers(), pol.should_restart()]
    return out


@pytest.mark.parametrize("chips_per_worker", [8, 16, 64, 256])
def test_restart_policy_matches_jax(chips_per_worker):
    got = _fleet(elastic, chips_per_worker)
    assert got == _fleet(jelastic, chips_per_worker)
    assert got[:3] == [["w3"], ["w2"], True]


# -- the dry-run's model cells -------------------------------------------------------------
def _jax_bytes(tree, boxes, mesh):
    total = 0
    for x, b in zip(jax.tree.leaves(tree), jax.tree.leaves(boxes)):
        n = np.dtype(x.dtype).itemsize
        for d, e in zip(x.shape, b.spec + (None,) * (len(x.shape)
                                                     - len(b.spec))):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= d // int(np.prod([mesh.shape[a] for a in axes] or [1]))
        total += n
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_argument_bytes_match_jax_specs(arch, multi_pod, jax_boxes):
    """Every model cell: the port's per-position argument bytes equal the
    sum of the JAX leaves' shard shapes under the JAX specs (params,
    optimizer state, batch; caches and the position for decode)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jm = jget_model(jcfg)
    mesh = Duck(*(((2, 16, 16), ("pod", "data", "model")) if multi_pod
                  else ((16, 16), ("data", "model"))))
    jp = jm.param_specs()
    pb = _jax_bytes(jp, jsh.param_shardings(jp, mesh, vocab=jcfg.vocab),
                    mesh)
    for js in jshapes_for(jcfg):
        want = pb
        if js.kind == "train":
            st = jax.eval_shape(jopt.init_fn(jcfg.optimizer), jp)
            want += _jax_bytes(st, jsh.opt_state_shardings(
                st, mesh, vocab=jcfg.vocab), mesh)
            b = jm.train_input_specs(js)
        elif js.kind == "prefill":
            b = jm.train_input_specs(js)
            b.pop("labels", None)
        else:
            c = jm.cache_specs(js.global_batch, js.seq_len)
            want += _jax_bytes(c, jsh.cache_shardings(
                c, mesh, js.global_batch), mesh) + 4
            b = jm.decode_input_specs(js)
        want += _jax_bytes(b, jsh.batch_shardings(b, mesh), mesh)
        got = dryrun.model_layout(cfg, SHAPES[js.name],
                                  dryrun.meta_mesh(multi_pod),
                                  activations=False)
        assert got["argument_bytes_per_position"] == want, js.name


def test_dryrun_cli_writes_every_model_cell(tmp_path):
    """``--arch`` no longer raises: every cell of one arch on both meshes
    writes an ok JSON, with its activation layouts; ``--resume`` skips
    them; a rule override reaches the layouts."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "qwen2-1.5b", "--mesh", "both",
                        "--out", out]) == 0
    import json
    import os
    names = sorted(os.listdir(out))
    cells = [f"qwen2-1.5b__{s}__{m}.json" for s in
             ("decode_32k", "prefill_32k", "train_4k")
             for m in ("pod16x16", "pod2x16x16")]
    assert names == sorted(cells)
    rec = json.load(open(os.path.join(out, "qwen2-1.5b__train_4k__"
                                      "pod16x16.json")))
    assert rec["status"] == "ok" and rec["kind"] == "train"
    assert ["batch", None, "embed"] in [e[0] for e in
                                        rec["activation_layouts"]]
    assert set(rec["collectives"]) == {"all-gather", "reduce-scatter",
                                       "all-reduce"}
    assert dryrun.main(["--arch", "qwen2-1.5b", "--mesh", "single",
                        "--resume", "--out", out]) == 0
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                        "--rule", "embed=skip", "--tag", "_noembed",
                        "--out", out]) == 0
    rec = json.load(open(os.path.join(out, "qwen2-1.5b__train_4k__"
                                      "pod16x16_noembed.json")))
    assert all("embed" not in e[0] for e in rec["activation_layouts"])


def test_collective_stats_parses_hlo_text():
    """``tests/test_dryrun_analysis.py``'s HLO text, against the JAX
    parser too."""
    import os
    os.environ.setdefault("XLA_FLAGS", "")   # jax is up: the count stays
    from repro.launch.dryrun import collective_stats as jcollective_stats
    hlo = """
  %ag = bf16[2048,14336]{1,0} all-gather(%p0), replica_groups=...
  %ar = f32[16,4096]{1,0} all-reduce(%p1), to_apply=%sum
  %rs = f32[256,128]{1,0} reduce-scatter(%p2), dimensions={0}
  %a2a = s8[64,64]{1,0} all-to-all(%p3)
  %cp = f32[8]{0} collective-permute(%p4)
  %dot = f32[128,128]{1,0} dot(%a, %b)
"""
    total, kinds = dryrun.collective_stats(hlo)
    want = (2048 * 14336 * 2 + 16 * 4096 * 4 + 256 * 128 * 4
            + 64 * 64 * 1 + 8 * 4)
    assert total == want
    assert kinds["all-gather"]["count"] == 1
    assert kinds["all-reduce"]["bytes"] == 16 * 4096 * 4
    assert "dot" not in kinds
    assert (total, kinds) == jcollective_stats(hlo)
