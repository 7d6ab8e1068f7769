"""Logical-axis sharding context (MaxText-style logical axis rules). Port of
``repro.distr.shardctx``.

Model code annotates activations with *logical* axes ("batch", "seq",
"embed", ...); the active ``ShardCtx`` maps them onto mesh axes. In the
JAX package that mapping becomes ``with_sharding_constraint`` for GSPMD.
The port computes each position's part eagerly (``train.train_step``'s
sharded step), so there is nothing for a compiler to constrain: ``shard``
returns its tensor unchanged, with or without a context. With a context
active, each annotation that the JAX package would turn into a constraint
is recorded as ``(logical axes, shape, spec)`` in the context's ``log``,
which the tests and the dry-run read. A rule of ``"skip"`` records
nothing, as it constrains nothing there.

Specs are the tuples ``distr.mesh.shard`` takes: one entry per dimension,
``None``, an axis name or a tuple of axis names.
"""
from __future__ import annotations

import contextlib
from typing import Optional

# logical axis -> mesh axes (tuples tried in full, then progressively dropped
# if the dimension size isn't divisible by the axis-group product)
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": (),                 # sequence replicated by default; SP opts in
    "seq_shard": "skip",       # forced q seq-sharding made GSPMD re-replicate
                               # per layer; left to propagation
    "seq_full": ("pod", "data", "model"),  # long-context decode KV
    "embed": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": (),
    "head_dim": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "none": (),
}

_CTX: Optional["ShardCtx"] = None


class ShardCtx:
    """Logical axes -> mesh axes over ``mesh`` (anything with ``shape`` and
    ``axis_names``: a ``distr.mesh.Mesh``). ``log`` holds every recorded
    annotation, in call order."""

    def __init__(self, mesh, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.log = []

    def axes_for(self, logical: Optional[str], dim_size: int):
        if logical is None:
            return None
        group = self.rules.get(logical, ())
        if group == "skip":
            return None
        group = tuple(a for a in group if a in self.mesh.axis_names)
        # drop leading axes until the group divides the dimension
        while group:
            prod = 1
            for a in group:
                prod *= self.mesh.shape[a]
            if prod <= dim_size and dim_size % prod == 0:
                return group if len(group) > 1 else group[0]
            group = group[1:]
        return None

    def pspec(self, shape, *logical) -> tuple:
        assert len(logical) == len(shape), (shape, logical)
        spec = []
        used = set()
        for l, s in zip(logical, shape):
            axes = self.axes_for(l, s)
            group = axes if isinstance(axes, tuple) else (axes,) if axes else ()
            if any(a in used for a in group):
                axes = None          # a mesh axis shards at most one dim:
                group = ()           # first logical annotation wins
            used.update(group)
            spec.append(axes)
        return tuple(spec)

    def constrain(self, x, *logical):
        """``x`` unchanged; the annotation logged unless a rule skips it."""
        if any(self.rules.get(l) == "skip" for l in logical if l):
            return x
        shape = tuple(x.shape)
        self.log.append((tuple(logical), shape, self.pspec(shape, *logical)))
        return x


def get() -> Optional[ShardCtx]:
    return _CTX


@contextlib.contextmanager
def use(ctx: Optional[ShardCtx]):
    global _CTX
    prev = _CTX
    _CTX = ctx
    try:
        yield ctx
    finally:
        _CTX = prev


def shard(x, *logical):
    """Annotate activation x with logical axes: ``x`` itself, logged by the
    active context if there is one."""
    ctx = _CTX
    if ctx is None:
        return x
    return ctx.constrain(x, *logical)
