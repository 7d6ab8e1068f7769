"""The train step: loss -> grad -> (optional compression) -> update. Port
of ``repro.train.train_step``.

Gradients come from autograd (``torch.autograd.grad`` over the params,
whose ``requires_grad`` the step turns on). Microbatches (the activation
memory lever) each take their own gradient, added into a float32
(``accum_dtype``) accumulator as the JAX scan does, never into ``p.grad``
(which would sum in the params' dtype). int8 gradient compression with
error feedback is ``distr.compression``. The update writes the params and
the optimizer state in place.

Under an active ``distr.shardctx.ShardCtx`` the step is the port's
counterpart of ``jax.jit(train_step, in_shardings=(params, opt_state,
batch))`` on the context's mesh: it takes and returns trees of
``distr.sharding.Placed`` leaves (``sharding.place``), and its schedule
is:

  * every distinct batch block (dim 0 split over the data group) is
    computed once, on the device of the first position holding it, split
    into ``microbatches``, with the params gathered for it: per microbatch,
    or with ``hoist_weight_gather`` once per step over the data axes (the
    TP-only layout: ``param_pspec`` with the data axes dropped) and per
    microbatch over the rest;
  * the gradients of the blocks' microbatches are added, in data-position
    order and then microbatch order, straight into each param block
    (a reduce-scatter; an all-reduce for a param not sharded over data) in
    ``accum_dtype`` (the params' dtype when hoisted), each scaled by its
    part's weight (hoisted: each loss scaled by it first). The loss is the
    JAX step's: the mean over its ``microbatches`` contiguous row ranges of
    each range's mean over its valid labels. A part (data block b, local
    slice j) lies in JAX microbatch (b * microbatches + j) // blocks, so
    its weight is its valid labels over ``microbatches`` times that
    microbatch's (``_part_weights``);
  * the "model" axis partitions the storage and the update, not the compute:
    each block's forward and backward runs with whole params;
  * the global norm, compression's scales and Adafactor's factored
    statistics and RMS clip are reductions over the distinct blocks (each
    counted once, never once per position holding it), in block order;
  * the update runs once on each distinct (block, device) tensor.

The step's collectives are counted per position, in the result-buffer
bytes of the JAX package's ``collective_stats`` (``step_collectives``,
which the dry-run reads too), and returned in ``metrics["collectives"]``.
With every leaf a single block (a one-position mesh), the step computes
what the unsharded step does with ``microbatches`` = the data blocks x
``microbatches``, bit for bit; otherwise the reductions above sum in
another order.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.distr import compression, shardctx
from repro_torch.distr import sharding as sh
from repro_torch.distr.sharding import Placed
from repro_torch.models.base import (jax_leaves, tree_leaves, tree_map,
                                     tree_unflatten)
from repro_torch.train import optimizer as opt_mod


def make_train_step(model, opt_cfg: opt_mod.OptConfig, *,
                    microbatches: int = 1, compress_grads: bool = False,
                    accum_dtype=torch.float32,
                    hoist_weight_gather: bool = False):
    """``train_step(params, opt_state, batch[, error_fb])`` ->
    ``(params, opt_state, metrics[, error_fb])``; metrics are the loss,
    the gradient's global norm and the learning rate at the new step (and,
    on a mesh, the collectives).

    ``hoist_weight_gather`` (microbatches only) is the JAX package's
    gradient of the mean microbatch loss, whose cotangents add up in the
    params' dtype; on a mesh it also keeps the params gathered over the
    data axes across the microbatches."""
    update = opt_mod.update_fn(opt_cfg.name)

    def train_step(params, opt_state, batch, error_fb=None):
        ctx = shardctx.get()
        if ctx is not None:
            return _mesh_step(model, opt_cfg, ctx.mesh, params, opt_state,
                              batch, error_fb, microbatches=microbatches,
                              compress_grads=compress_grads,
                              accum_dtype=accum_dtype,
                              hoist=hoist_weight_gather)
        params.requires_grad_(True)
        leaves = tree_leaves(params)

        def grads_of(batch, scale=1.0):
            loss = model.loss_fn(params, batch)
            return loss.detach(), torch.autograd.grad(loss * scale, leaves)

        with torch.enable_grad():
            if microbatches > 1:
                n = next(iter(batch.values())).shape[0] // microbatches
                # hoisted: d(mean loss), summed in the params' dtype
                scale = 1.0 / microbatches if hoist_weight_gather else 1.0
                loss = 0.0
                acc = [torch.zeros(p.shape, device=p.device, dtype=(
                    p.dtype if hoist_weight_gather else accum_dtype))
                    for p in leaves]
                for i in range(microbatches):
                    l, gs = grads_of({k: v[i * n:(i + 1) * n]
                                      for k, v in batch.items()}, scale)
                    loss = loss + l
                    for a, g in zip(acc, gs):
                        a.add_(g.to(a.dtype))
                loss = loss / microbatches
                grads = acc if hoist_weight_gather else [
                    a / microbatches for a in acc]
            else:
                loss, grads = grads_of(batch)
        grads = tree_unflatten(params, grads)

        if compress_grads:
            grads, error_fb = compression.compress_decompress(grads, error_fb)

        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.clip_norm)
        params, opt_state = update(opt_cfg, params, grads, opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt_mod.schedule(opt_cfg, opt_state["step"])}
        if compress_grads:
            return params, opt_state, metrics, error_fb
        return params, opt_state, metrics

    return train_step


# -- the schedule's collectives ---------------------------------------------------
class Layout:
    """A param tensor's global shape, dtype and spec (no data)."""
    __slots__ = ("shape", "dtype", "spec")

    def __init__(self, shape, dtype, spec):
        self.shape, self.dtype = tuple(shape), dtype
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))


def layouts(params, shardings=None):
    """A tree of ``Layout`` from placed params, or from params (tensors,
    meta tensors or ``Spec`` records) and their shardings."""
    if shardings is None:
        return tree_map(lambda x: Layout(x.shape, x.dtype, x.spec), params)
    return tree_map(lambda t, s: Layout(tuple(t.shape), t.dtype, s),
                       params, shardings)


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _axes_in(spec, dims=None) -> tuple:
    dims = range(len(spec)) if dims is None else dims
    return tuple(a for i in dims for a in sh.axes_of(spec[i]))


def step_collectives(layout_tree, mesh, *, batch_blocks: int,
                     vocab=None, microbatches: int = 1, hoist: bool = False,
                     accum_dtype=torch.float32, optimizer: str = "adamw",
                     opt_cfg: opt_mod.OptConfig = opt_mod.OptConfig(),
                     compress_grads: bool = False) -> Dict[str, dict]:
    """The sharded step's collectives, per position, by kind: ``{kind:
    {"count", "bytes"}}`` with each collective's result bytes on one
    position (``collective_stats``'s per-device convention). Every
    position holds blocks of one size, so one position stands for all.

    * all-gather: each sharded param to whole params for compute, per
      microbatch; hoisted, over the data axes once (to the TP-only layout)
      and over the rest per microbatch; Adafactor's factored statistics
      (their partial sums over the dims not reduced, and the updated ``vr``
      / ``vc``) where sharded;
    * reduce-scatter: each gradient sharded over data, to its block, in the
      accumulation dtype (with more than one batch block);
    * all-reduce: a gradient not sharded over data (its block), the loss,
      the global norm, compression's scale per JAX leaf, Adafactor's
      partial row / column sums over the axes sharding the reduced dim and
      its RMS clip's sum (float32 scalars and statistics)."""
    out: Dict[str, dict] = {}

    def add(kind, nbytes, count=1):
        if count:
            e = out.setdefault(kind, {"count": 0, "bytes": 0})
            e["count"] += count
            e["bytes"] += count * int(nbytes)

    daxes = set(sh.data_axes(mesh))
    any_sharded = False
    for path, ls, stacked in jax_leaves(layout_tree):
        shape0 = ls[0].shape
        stacked_shape = ((len(ls),) if stacked else ()) + shape0
        rank = len(stacked_shape)
        factored = (optimizer == "adafactor" and opt_mod._factored(
            stacked_shape, opt_cfg.factored_min_dim))
        per_layer = opt_mod.adafactor_per_layer(
            opt_cfg, rank, factored, _nbytes(stacked_shape, torch.float32))
        leaf_sharded = False
        for l in ls:
            spec, full = l.spec, _nbytes(l.shape, l.dtype)
            nb = sh.spec_blocks(mesh, spec)
            if nb == 1:
                pass
            elif hoist:
                kept = tuple(None if set(sh.axes_of(e)) & daxes else e
                             for e in spec)
                if any(set(sh.axes_of(e)) & daxes for e in spec):
                    add("all-gather", full // sh.spec_blocks(mesh, kept))
                if sh.spec_blocks(mesh, kept) > 1:
                    add("all-gather", full, microbatches)
            else:
                add("all-gather", full, microbatches)
            leaf_sharded |= nb > 1
            adt = l.dtype if hoist else accum_dtype
            if batch_blocks > 1:
                kind = ("reduce-scatter" if set(_axes_in(spec)) & daxes
                        else "all-reduce")
                add(kind, _nbytes(l.shape, adt) // nb)
            if factored:
                bs = sh.block_shape(l.shape, spec, mesh)
                for red in (-1, -2):
                    keep = [i for i in range(len(spec))
                            if i != len(spec) + red]
                    if _axes_in(spec, [len(spec) + red]):
                        add("all-reduce", _nbytes([bs[i] for i in keep],
                                                  torch.float32))
                    stat = [l.shape[i] for i in keep]
                    if _axes_in(spec, keep):
                        add("all-gather", _nbytes(stat, torch.float32))
                    # the updated vr / vc, whole, for the denominators
                    sspec = sh.param_pspec(
                        path, (((len(ls),) if stacked else ()) + tuple(stat)),
                        mesh, vocab)
                    if any(sspec):
                        add("all-gather", _nbytes(stat, torch.float32))
            if optimizer == "adafactor" and per_layer and nb > 1:
                add("all-reduce", 4)
        any_sharded |= leaf_sharded
        if leaf_sharded and compress_grads:
            add("all-reduce", 4)
        if optimizer == "adafactor" and not per_layer and leaf_sharded:
            add("all-reduce", 4)
    if batch_blocks > 1:
        add("all-reduce", 4)                # the loss
    if any_sharded:
        add("all-reduce", 4)                # the global norm
    return out


# -- the sharded step ---------------------------------------------------------------
def _data_blocks(batch) -> List[int]:
    """One position for each distinct batch block, in block order."""
    leaves = sh.tree_items(batch)
    first = leaves[0].distinct()
    for x in leaves[1:]:
        if x.distinct() != first or x.spec[0] != leaves[0].spec[0]:
            raise ValueError("batch leaves are not split alike on dim 0")
    return first


def _whole(x: Placed, dev) -> torch.Tensor:
    """``x``'s global tensor on ``dev``: its block there when it is not
    sharded (a new tensor object, storage shared), else gathered."""
    if sh.spec_blocks(x.mesh, x.spec) == 1:
        for pos, t in enumerate(x.blocks):
            if x.mesh.device_at(pos) == dev:
                return t.detach()
    return sh.gather_leaf(x, dev)


def _tp_only(x: Placed) -> Placed:
    """``x`` gathered over the data axes: the TP-only layout."""
    daxes = set(sh.data_axes(x.mesh))
    kept = tuple(None if set(sh.axes_of(e)) & daxes else e for e in x.spec)
    if kept == x.spec:
        return x
    full = sh.gather_leaf(x)
    return sh.place_leaf(full, kept, x.mesh)


def _zeros_like(x: Placed, dtype) -> Placed:
    return sh.blocks_like(x, lambda pos: torch.zeros(
        x.blocks[pos].shape, dtype=dtype, device=x.blocks[pos].device))


def _sum_blocks(x: Placed, fn, home) -> torch.Tensor:
    """``fn`` of each distinct block, summed in block order on ``home``."""
    total = None
    for pos in x.distinct():
        part = fn(x.blocks[pos]).to(home)
        total = part if total is None else total + part
    return total


def part_grads(model, params, whole, batch, scale=None):
    """One part of the sharded step: ``(loss, gradients)`` of
    ``model.loss_fn`` over ``batch`` at the params ``whole`` (tensors that
    require grad, in ``tree_leaves(params)`` order), the gradient that of
    ``loss * scale`` when ``scale`` is given. The loss comes back detached,
    so its graph, which holds ``whole``, goes with the call."""
    with torch.enable_grad():
        loss = model.loss_fn(tree_unflatten(params, whole), batch)
        gs = torch.autograd.grad(loss if scale is None else loss * scale,
                                 whole)
    return loss.detach(), gs


def _part_weights(labels: Placed, blocks, microbatches: int, home
                  ) -> List[torch.Tensor]:
    """Each part's weight in the step's loss, in part order (data block,
    then local slice): its valid labels (not -100, ``cross_entropy``'s
    ignore) over ``microbatches`` x the valid labels of the JAX microbatch
    holding it, at least 1. With equal counts it is 1 / parts. Tensors on
    ``home``: no host sync."""
    valid = []
    for bpos in blocks:
        t = labels.blocks[bpos]
        n = t.shape[0] // microbatches
        valid += [(t[j * n:(j + 1) * n] != -100).sum().to(home)
                  for j in range(microbatches)]
    d = len(blocks)
    total = [torch.clamp(sum(valid[j * d:(j + 1) * d]), min=1)
             for j in range(microbatches)]
    return [v / (microbatches * total[q // d]) for q, v in enumerate(valid)]


def _mesh_step(model, opt_cfg, mesh, params, opt_state, batch, error_fb, *,
               microbatches, compress_grads, accum_dtype, hoist):
    home = mesh.home
    pleaves: List[Placed] = tree_leaves(params)
    for x in pleaves + tree_leaves(batch):
        if not isinstance(x, Placed) or x.mesh != mesh:
            raise ValueError("the sharded step takes trees placed on the "
                             "context's mesh (distr.sharding.place)")
    blocks = _data_blocks(batch)
    n_parts = len(blocks) * microbatches
    weights = iter(_part_weights(batch["labels"], blocks, microbatches,
                                 home))
    collectives = step_collectives(
        layouts(params), mesh, batch_blocks=len(blocks),
        vocab=getattr(model.cfg, "vocab", None), microbatches=microbatches,
        hoist=hoist, accum_dtype=accum_dtype, optimizer=opt_cfg.name,
        opt_cfg=opt_cfg, compress_grads=compress_grads)

    # -- forward and backward, block by block -------------------------------------
    source = [_tp_only(x) for x in pleaves] if hoist else pleaves
    # one part: the gradient as autograd gives it, as the unsharded step
    # without microbatches keeps it
    own = hoist or n_parts == 1
    acc = [_zeros_like(x, x.dtype if own else accum_dtype) for x in pleaves]
    loss = 0.0
    for bpos in blocks:
        dev = mesh.device_at(bpos)
        rows = next(iter(sh.tree_items(batch))).blocks[bpos].shape[0]
        n = rows // microbatches
        for j in range(microbatches):
            mb = {k: v.blocks[bpos][j * n:(j + 1) * n]
                  for k, v in batch.items()}
            w = next(weights)
            whole = [_whole(x, dev).requires_grad_(True) for x in source]
            l, gs = part_grads(model, params, whole, mb,
                               w.to(dev) if hoist else None)
            del whole
            loss = loss + w * l.to(home)
            with torch.no_grad():
                for a, x, g in zip(acc, pleaves, gs):
                    for pos in a.local():
                        t = a.blocks[pos]
                        g_t = g[x.slices(pos)].to(t.dtype).to(t.device)
                        t.add_(g_t if hoist else g_t * w.to(t.device))
            del gs
    grads = tree_unflatten(params, acc)

    with torch.no_grad():
        if compress_grads:
            grads, error_fb = _compress(grads, error_fb, home)
        gnorm = _clip(grads, opt_cfg.clip_norm, home)
        _update(opt_cfg, params, grads, opt_state, home)
    step = opt_state["step"]
    metrics = {"loss": loss, "grad_norm": gnorm,
               "lr": opt_mod.schedule(opt_cfg, sh.gather_leaf(step, "cpu")),
               "collectives": collectives}
    if compress_grads:
        return params, opt_state, metrics, error_fb
    return params, opt_state, metrics


def _clip(grads, max_norm: float, home) -> torch.Tensor:
    """``clip_by_global_norm`` over the distinct blocks: the norm (each
    leaf's blocks summed in block order, the leaves in tree order)."""
    total = 0
    for g in tree_leaves(grads):
        total = total + _sum_blocks(
            g, lambda b: torch.sum(torch.square(b.float())), home)
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        for pos in g.local():
            b = g.blocks[pos]
            b.copy_(b.float() * scale.to(b.device))
    return gn


def _compress(grads, error_fb, home):
    """``compression.compress_decompress`` on placed grads: one absmax
    scale per JAX leaf over its distinct blocks."""
    if error_fb is None:
        error_fb = tree_map(lambda g: _zeros_like(g, torch.float32), grads)
    deq_of, res_of = {}, {}
    for (_, gs, _), (_, es, _) in zip(jax_leaves(grads),
                                      jax_leaves(error_fb)):
        g32 = [sh.blocks_like(g, lambda pos, g=g, e=e: g.blocks[pos].float()
                              + e.blocks[pos]) for g, e in zip(gs, es)]
        amax = torch.stack([x.blocks[pos].abs().max().to(home)
                            for x in g32 for pos in x.distinct()]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for g, x in zip(gs, g32):
            s = scale
            deq = sh.blocks_like(x, lambda pos, x=x: compression.dequantize(
                compression.quantize(x.blocks[pos], s.to(
                    x.blocks[pos].device))[0], s.to(x.blocks[pos].device)))
            deq_of[id(g)] = sh.blocks_like(
                deq, lambda pos, d=deq, g=g: d.blocks[pos].to(g.dtype))
            res_of[id(g)] = sh.blocks_like(
                x, lambda pos, x=x, d=deq: x.blocks[pos] - d.blocks[pos])
    leaves = tree_leaves(grads)
    return (tree_unflatten(grads, [deq_of[id(g)] for g in leaves]),
            tree_unflatten(grads, [res_of[id(g)] for g in leaves]))


def _next_step(state):
    step = sh.gather_leaf(state["step"], "cpu") + 1
    state["step"] = sh.place_leaf(step, (), state["step"].mesh)
    return step


def _update(opt, params, grads, state, home):
    step = _next_step(state)
    if opt.name == "adamw":
        lr, bc1, bc2 = opt_mod.adamw_coeffs(opt, step)
        for rank, ps, gs, ms, vs in opt_mod._groups(params, grads,
                                                    state["m"], state["v"]):
            for p, g, m, v in zip(ps, gs, ms, vs):
                assert p.spec == g.spec == m.spec == v.spec, p
                for pos in p.local():
                    opt_mod.adamw_apply(opt, p.blocks[pos], g.blocks[pos],
                                        m.blocks[pos], v.blocks[pos], rank,
                                        lr, bc1, bc2)
        return
    lr, beta2 = opt_mod.adafactor_coeffs(opt, step)
    acc_of = {}
    tree_map(lambda p, a: acc_of.setdefault(id(p), a), params,
                state["acc"])
    for rank, ps, gs in opt_mod._groups(params, grads):
        accs = [acc_of[id(p)] for p in ps]
        factored = "vr" in accs[0]
        per_layer = opt_mod.adafactor_per_layer(
            opt, rank, factored, sum(_nbytes(p.shape, torch.float32)
                                     for p in ps))
        us = []
        for g, acc in zip(gs, accs):
            g2 = sh.blocks_like(g, lambda pos, g=g:
                                torch.square(g.blocks[pos].float()) + 1e-30)
            if factored:
                whole = {}
                for name, red in (("vr", -1), ("vc", -2)):
                    stat = _stat_mean(g2, red, home)
                    v = acc[name]
                    for pos in v.local():
                        b = v.blocks[pos]
                        b.mul_(beta2).add_(stat[v.slices(pos)].to(b.device),
                                           alpha=1 - beta2)
                    whole[name] = sh.gather_leaf(v)
                vr, vc = whole["vr"], whole["vc"]
                mr = vr.mean(dim=-1, keepdim=True)
                nd = len(g.shape)

                def denom(pos, g=g, vr=vr, vc=vc, mr=mr, nd=nd):
                    sl = g.slices(pos)
                    lead = sl[:nd - 2]
                    dev = g.blocks[pos].device
                    r = vr[lead + (sl[-2],)].to(dev)
                    c = vc[lead + (sl[-1],)].to(dev)
                    m = mr[lead].to(dev)
                    return torch.sqrt(r[..., :, None] * c[..., None, :]
                                      / torch.clamp(m[..., None], min=1e-30))
            else:
                v = acc["v"]
                for pos in v.local():
                    v.blocks[pos].mul_(beta2).add_(g2.blocks[pos],
                                                   alpha=1 - beta2)

                def denom(pos, v=v):
                    return torch.sqrt(v.blocks[pos])
            us.append(sh.blocks_like(g, lambda pos, g=g, denom=denom:
                                     g.blocks[pos].float() / torch.clamp(
                                         denom(pos), min=1e-30)))
        # update clipping (RMS <= 1) per the Adafactor paper
        sq = [_sum_blocks(u, lambda b: torch.sum(b * b), home) for u in us]
        if per_layer:
            rms = [torch.sqrt(s / u.numel() + 1e-30) for s, u in zip(sq, us)]
        else:
            total = sum(sq)
            count = sum(u.numel() for u in us)
            rms = [torch.sqrt(total / count + 1e-30)] * len(us)
        for p, u, r in zip(ps, us, rms):
            for pos in p.local():
                opt_mod.apply_update(opt, p.blocks[pos], u.blocks[pos],
                                     r.to(p.blocks[pos].device), rank, lr)


def _stat_mean(g2: Placed, red: int, home) -> torch.Tensor:
    """The mean of ``g2`` over dim ``red`` (-1 or -2), whole, on ``home``:
    each distinct block's partial sum added into its slice (the all-reduce
    over the axes sharding ``red``, then the all-gather)."""
    nd = len(g2.shape)
    keep = [i for i in range(nd) if i != nd + red]
    out = torch.zeros([g2.shape[i] for i in keep], dtype=torch.float32,
                      device=home)
    for pos in g2.distinct():
        sl = g2.slices(pos)
        out[tuple(sl[i] for i in keep)] += g2.blocks[pos].sum(dim=red).to(home)
    return out / g2.shape[red]
