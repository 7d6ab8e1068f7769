"""The train step: loss -> grad -> (optional compression) -> update. Port
of ``repro.train.train_step``.

Gradients come from autograd (``torch.autograd.grad`` over the params,
whose ``requires_grad`` the step turns on). Microbatches (the activation
memory lever) each take their own gradient, added into a float32
(``accum_dtype``) accumulator as the JAX scan does, never into ``p.grad``
(which would sum in the params' dtype). int8 gradient compression with
error feedback is ``distr.compression``. The update writes the params and
the optimizer state in place.
"""
from __future__ import annotations

import torch

from repro_torch.distr import compression
from repro_torch.models.base import tree_leaves, tree_unflatten
from repro_torch.train import optimizer as opt_mod


def make_train_step(model, opt_cfg: opt_mod.OptConfig, *,
                    microbatches: int = 1, compress_grads: bool = False,
                    accum_dtype=torch.float32,
                    hoist_weight_gather: bool = False):
    """``train_step(params, opt_state, batch[, error_fb])`` ->
    ``(params, opt_state, metrics[, error_fb])``; metrics are the loss,
    the gradient's global norm and the learning rate at the new step.

    ``hoist_weight_gather`` (microbatches only) is the JAX package's
    gradient of the mean microbatch loss, whose cotangents add up in the
    params' dtype: under a mesh it keeps the params gathered across the
    microbatches; without one (the only case the port runs yet) it is
    that gradient and nothing more."""
    update = opt_mod.update_fn(opt_cfg.name)

    def train_step(params, opt_state, batch, error_fb=None):
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

