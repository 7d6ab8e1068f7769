"""Optimizers built in-repo: AdamW and Adafactor (factored second moment,
which llama4-maverick's config takes), the cosine LR schedule and
global-norm clipping. Port of ``repro.train.optimizer``.

Params are the port's ``ParamTree`` (one entry per layer); gradients and
state are trees in their nesting (``models.base.as_tree``), the state with
one entry per layer. The JAX package states its rules on its stacked
leaves; they hold here on the groups ``models.jax_leaves`` gives:

- weight decay applies where the stacked rank is at least 2: every
  per-layer norm gain and bias, (L, D) there, is decayed; ``ln_f`` is not;
- Adafactor factors the last two dims of the stacked shape, and clips its
  update's RMS over the whole stacked leaf, across the layers, except
  where the JAX update maps over the layers (a factored leaf of stacked
  rank 4 or more and at least ``chunked_update_min_bytes`` in float32:
  llama4's experts): there per layer.

Updates run in float32 and are written back in place in the param's
dtype. The step count and the schedule are float32 CPU scalars, as the JAX
package evaluates them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.base import jax_leaves, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_min_dim: int = 128
    # the JAX update maps over the stacked layers of leaves at least this
    # large in float32, which makes Adafactor's RMS clip per layer there
    chunked_update_min_bytes: int = 1 << 30


def schedule(opt: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step``: linear warmup, then a cosine down to
    ``min_lr_frac``; a float32 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = opt.lr * step / max(opt.warmup_steps, 1)
    t = torch.clamp((step - opt.warmup_steps)
                    / max(opt.total_steps - opt.warmup_steps, 1), 0, 1)
    cos = opt.lr * (opt.min_lr_frac
                    + (1 - opt.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < opt.warmup_steps, warm, cos)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / norm)`` in float32 and
    cast it back to its dtype, in place: (grads, the float32 norm)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.copy_(g.float() * scale)
    return grads, gn


def _groups(*trees):
    """The JAX leaves of trees in one nesting, side by side:
    ``(stacked rank, tensors of the first tree, of the second, ...)``."""
    views = [jax_leaves(t) for t in trees]
    for parts in zip(*views):
        _, ts, stacked = parts[0]
        yield (ts[0].dim() + stacked,) + tuple(p[1] for p in parts)


def _step(state):
    return state["step"] + 1


# -- AdamW ----------------------------------------------------------------------
def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def adamw_coeffs(opt: OptConfig, step):
    """``(lr, bc1, bc2)`` of the step numbered ``step``."""
    lr = float(schedule(opt, step))
    bc1 = float(1 - opt.b1 ** step.float())
    bc2 = float(1 - opt.b2 ** step.float())
    return lr, bc1, bc2


@torch.no_grad()
def adamw_apply(opt: OptConfig, p, g, m, v, rank: int, lr, bc1, bc2):
    """One element-wise AdamW update of ``p`` (and its moments) in place;
    ``rank`` is the JAX leaf's stacked rank (decay from 2)."""
    g = g.float()
    m.mul_(opt.b1).add_(g, alpha=1 - opt.b1)
    v.mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
    u = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
    if rank >= 2:
        u.add_(p.float(), alpha=opt.weight_decay)
    p.copy_(p.float() - lr * u)


@torch.no_grad()
def adamw_update(opt: OptConfig, params, grads, state):
    step = _step(state)
    lr, bc1, bc2 = adamw_coeffs(opt, step)
    for rank, ps, gs, ms, vs in _groups(params, grads, state["m"],
                                        state["v"]):
        for p, g, m, v in zip(ps, gs, ms, vs):
            adamw_apply(opt, p, g, m, v, rank, lr, bc1, bc2)
    state["step"] = step
    return params, state


# -- Adafactor --------------------------------------------------------------------
def _factored(shape, min_dim):
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(params, opt: OptConfig = OptConfig()):
    """Each leaf's second-moment statistics, per layer: ``vr`` / ``vc``
    where its stacked shape is factored, else ``v``. A factored stacked
    shape whose second-last dim is the layer axis (a per-layer vector with
    at least ``factored_min_dim`` layers; no config has so many) would share
    ``vc`` across the layers: it raises."""
    factored = {}
    for path, ts, stacked in jax_leaves(params):
        shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
        f = _factored(shape, opt.factored_min_dim)
        if f and stacked and ts[0].dim() < 2:
            raise ValueError(f"{path}: factoring {shape} would share "
                             f"Adafactor's statistics across the layers")
        for t in ts:
            factored[id(t)] = f

    def one(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
        if factored[id(p)]:
            return {"vr": z(p.shape[:-1]),
                    "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"acc": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32)}


def adafactor_coeffs(opt: OptConfig, step):
    """``(lr, beta2)`` of the step numbered ``step``."""
    return (float(schedule(opt, step)),
            float(1.0 - step.float() ** (-opt.decay_rate)))


def adafactor_per_layer(opt: OptConfig, rank: int, factored: bool,
                        nbytes32: int) -> bool:
    """Whether the RMS clip runs per layer: where the JAX update maps over
    the layers (``nbytes32``: the stacked leaf's bytes in float32)."""
    return (rank >= 4 and factored
            and nbytes32 >= opt.chunked_update_min_bytes)


@torch.no_grad()
def apply_update(opt: OptConfig, p, u, rms, rank: int, lr):
    """``p -= lr * (u / max(rms, 1) [+ decay])`` in place."""
    u = u / torch.clamp(rms, min=1.0)
    if rank >= 2:
        u.add_(p.float(), alpha=opt.weight_decay)
    p.copy_(p.float() - lr * u)


@torch.no_grad()
def adafactor_update(opt: OptConfig, params, grads, state):
    step = _step(state)
    lr, beta2 = adafactor_coeffs(opt, step)
    acc_of = {}
    tree_map(lambda p, a: acc_of.setdefault(id(p), a), params, state["acc"])
    for rank, ps, gs in _groups(params, grads):
        accs = [acc_of[id(p)] for p in ps]
        factored = "vr" in accs[0]
        per_layer = adafactor_per_layer(
            opt, rank, factored, sum(p.numel() for p in ps) * 4)
        us = []
        for g, acc in zip(gs, accs):
            g = g.float()
            g2 = g * g + 1e-30
            if factored:
                vr, vc = acc["vr"], acc["vc"]
                vr.mul_(beta2).add_(g2.mean(dim=-1), alpha=1 - beta2)
                vc.mul_(beta2).add_(g2.mean(dim=-2), alpha=1 - beta2)
                denom = torch.sqrt(
                    vr[..., :, None] * vc[..., None, :]
                    / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                  min=1e-30))
            else:
                acc["v"].mul_(beta2).add_(g2, alpha=1 - beta2)
                denom = torch.sqrt(acc["v"])
            us.append(g / torch.clamp(denom, min=1e-30))
        # update clipping (RMS <= 1) per the Adafactor paper
        if per_layer:
            rms = [torch.sqrt(torch.mean(u * u) + 1e-30) for u in us]
        else:
            total = sum(torch.sum(u * u) for u in us)
            whole = torch.sqrt(total / sum(u.numel() for u in us) + 1e-30)
            rms = [whole] * len(us)
        for p, u, r in zip(ps, us, rms):
            apply_update(opt, p, u, r, rank, lr)
    state["step"] = step
    return params, state


def init_fn(name: str):
    return {"adamw": adamw_init, "adafactor": adafactor_init}[name]


def update_fn(name: str):
    return {"adamw": adamw_update, "adafactor": adafactor_update}[name]
