"""PyTorch port, element-wise family: the BSR plans and their numeric phase
(``kernels.bsr_ewise``'s plain version), the ``grb`` element-wise family,
extract / assign and reduce, held against the JAX package.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX side runs ``repro.core.bsr``'s plans with their XLA gather (what the
JAX ``grb`` runs) and, for the six kernel modes, ``repro.kernels.ops``'s
Pallas kernel in interpret mode. Every comparison is bit for bit: stored
values are small multiples of 0.5, so every sum here is exact in float32,
and each op is one float32 rounding in both packages. The CUDA kernel
itself is tested on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bsr as jbsr
from repro.core import grb as jgrb
from repro.core import semiring as JS
from repro.core.bitadj import BitELL as JBitELL
from repro.core.bsr import BSR as JBSR
from repro.core.ell import ELL as JELL
from repro.kernels import ops as jkops
from repro_torch.core import bsr as tbsr
from repro_torch.core import grb as tgrb
from repro_torch.core import semiring as TS
from repro_torch.core.bitadj import BitELL as TBitELL
from repro_torch.core.bsr import BSR as TBSR
from repro_torch.core.ell import ELL as TELL
from repro_torch.kernels import bsr_ewise as tkew
from repro_torch.kernels import ops as tkops

ARRAYS = ("blocks", "block_rows", "block_cols", "first", "last", "valid",
          "row_ptr")

# name -> (JAX callable, port named op)
OPS = {
    "plus": (lambda a, b: a + b, TS.ewise("plus")),
    "times": (lambda a, b: a * b, TS.ewise("times")),
    "min": (jnp.minimum, TS.ewise("min")),
    "max": (jnp.maximum, TS.ewise("max")),
    "first": (lambda a, b: a, TS.ewise("first")),
    "second": (lambda a, b: b, TS.ewise("second")),
    "pair": (lambda a, b: jnp.ones_like(a), TS.ewise("pair")),
    "minus": (lambda a, b: a - b, TS.ewise("minus")),
    "identity": (lambda a: a, TS.ewise("identity")),
    "ainv": (lambda a: -a, TS.ewise("ainv")),
    "abs": (jnp.abs, TS.ewise("abs")),
    "one": (jnp.ones_like, TS.ewise("one")),
    "mul(0.3)": (lambda a: a * 0.3, TS.ewise("mul", 0.3)),
    "add(-1)": (lambda a: a + -1.0, TS.ewise("add", -1.0)),  # empties 1s
    "ge(1)": (lambda a: a >= 1.0, TS.ewise("ge", 1.0)),
    "gt(0)": (lambda a: a > 0.0, TS.ewise("gt", 0.0)),
    "le(-1)": (lambda a: a <= -1.0, TS.ewise("le", -1.0)),
    "lt(0.5)": (lambda a: a < 0.5, TS.ewise("lt", 0.5)),
    "eq(1)": (lambda a: a == 1.0, TS.ewise("eq", 1.0)),
    "ne(1)": (lambda a: a != 1.0, TS.ewise("ne", 1.0)),
    "ge(9)": (lambda a: a >= 9.0, TS.ewise("ge", 9.0)),      # empties all
}
BINARY = ["plus", "times", "min", "max", "first", "second", "pair", "minus"]
UNARY = ["identity", "ainv", "abs", "one", "mul(0.3)", "add(-1)", "ge(1)"]
PREDICATES = ["ge(1)", "gt(0)", "le(-1)", "lt(0.5)", "eq(1)", "ne(1)",
              "ge(9)"]


def entries(rng, n, m, nnz, empty_rows=()):
    """Random entries valued in {+-0.5, ..., +-2} (never 0), none in the
    given rows; duplicates keep the last, in both builds."""
    r = rng.integers(0, n, size=nnz)
    c = rng.integers(0, m, size=nnz)
    keep = ~np.isin(r, list(empty_rows))
    r, c = r[keep], c[keep]
    v = rng.choice([-2, -1.5, -1, -0.5, 0.5, 1, 1.5, 2], size=len(r))
    return r, c, v.astype(np.float64)


def both_bsr(e, shape, block=32):
    return (JBSR.from_coo(*e, shape, block=block),
            TBSR.from_coo(*e, shape, block=block, device="cpu"))


def assert_bsr_same(j, t):
    assert tuple(t.shape) == tuple(j.shape) and t.block == j.block
    assert t.nnz == j.nnz
    for f in ARRAYS:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# (n, m, A entries, B entries, A's empty rows, B's empty rows): ragged n,
# tiles absent on either side, and each operand empty once
PAIRS = {
    "ragged": (200, 150, 700, 700, range(32, 64), range(96, 160)),
    "b_empty": (256, 256, 900, 0, (), ()),
    "a_empty": (96, 70, 0, 300, (), ()),
}


def pair(name, seed=0, block=32):
    n, m, na, nb, ea, eb = PAIRS[name]
    rng = np.random.default_rng(seed + n)
    jA, tA = both_bsr(entries(rng, n, m, na, ea), (n, m), block)
    jB, tB = both_bsr(entries(rng, n, m, nb, eb), (n, m), block)
    return jA, tA, jB, tB


# every op on the ragged pair; the empty operands with a few (the plans,
# not the ops, differ there)
@pytest.mark.parametrize("case,opname", [("ragged", o) for o in BINARY] + [
    ("b_empty", "plus"), ("b_empty", "min"), ("a_empty", "times"),
    ("a_empty", "minus")])
def test_ewise_add_mult_plans_bit_identical(case, opname):
    jA, tA, jB, tB = pair(case)
    jop, top = OPS[opname]
    assert_bsr_same(jbsr.ewise_add(jA, jB, jop), tbsr.ewise_add(tA, tB, top))
    assert_bsr_same(jbsr.ewise_mult(jA, jB, jop),
                    tbsr.ewise_mult(tA, tB, top))


@pytest.mark.parametrize("case,opname", [
    ("ragged", o) for o in UNARY + PREDICATES if o != "ge(1)"] + [
    (c, o) for c in ("ragged", "b_empty", "a_empty")
    for o in ("ge(1)", "add(-1)")])
def test_apply_select_plans_bit_identical(case, opname):
    jA, tA, _, _ = pair(case)
    jop, top = OPS[opname]
    if opname in UNARY:
        assert_bsr_same(jbsr.apply_stored(jA, jop),
                        tbsr.apply_stored(tA, top))
    if opname in PREDICATES:
        assert_bsr_same(jbsr.select_stored(jA, jop),
                        tbsr.select_stored(tA, top))


@pytest.mark.parametrize("case", list(PAIRS))
@pytest.mark.parametrize("complement", [False, True])
def test_mask_keep_bit_identical(case, complement):
    jA, tA, jB, tB = pair(case)
    assert_bsr_same(jbsr.mask_keep(jA, jB, complement=complement),
                    tbsr.mask_keep(tA, tB, complement=complement))
    assert_bsr_same(jbsr.mask_keep(jB, jA, complement=complement),
                    tbsr.mask_keep(tB, tA, complement=complement))


@pytest.mark.parametrize("r0,r1,c0,c1", [(0, 200, 0, 150), (32, 190, 64, 150),
                                         (64, 96, 0, 33), (160, 200, 96, 97)])
def test_extract_ranges_bit_identical(r0, r1, c0, c1):
    jA, tA, _, _ = pair("ragged")
    assert_bsr_same(jbsr.extract_ranges(jA, r0, r1, c0, c1),
                    tbsr.extract_ranges(tA, r0, r1, c0, c1))


# each kernel mode once against the JAX Pallas kernel (interpret mode)
PALLAS = [("union", "min"), ("intersect", "times"), ("apply", "mul(0.3)"),
          ("select", "ge(1)"), ("mask", None), ("mask_c", None)]


@pytest.mark.parametrize("mode,opname", PALLAS)
def test_kernel_modes_match_jax_pallas(mode, opname):
    jA, tA, jB, tB = pair("ragged", seed=1)
    jop, top = OPS[opname] if opname else (None, None)
    before = tkew.launches
    got = tkops.bsr_ewise(tA, tB, mode, top)
    assert tkew.launches == before             # CPU: the plain version
    assert_bsr_same(jkops.bsr_ewise(jA, jB, mode, jop), got)


def test_map_tiles_plain_matches_jax_gather():
    """The plain version against ``_ewise_jnp`` on one selector plan with
    absent tiles on both sides."""
    from repro.kernels import bsr_ewise as jkew
    jA, tA, jB, tB = pair("ragged", seed=2)
    rng = np.random.default_rng(9)
    T = 40
    sa = rng.integers(-1, tA.nnzb, size=T).astype(np.int32)
    sb = rng.integers(-1, tB.nnzb, size=T).astype(np.int32)
    for mode, opname in PALLAS:
        jop, top = OPS[opname] if opname else (None, None)
        want = jkew.map_tiles(jA.blocks, sa, jB.blocks, sb, mode, jop)
        got = tkew.map_tiles(tA.blocks, sa, tB.blocks, sb, mode, top)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        np.testing.assert_array_equal(
            got.numpy(), tkew.map_tiles_plain(tA.blocks, sa, tB.blocks, sb,
                                              mode, top).numpy())


def test_map_tiles_rejects_bad_inputs():
    _, tA, _, tB = pair("ragged")
    sel = np.arange(3, dtype=np.int32)
    with pytest.raises(TypeError, match="named element-wise op"):
        tkew.map_tiles(tA.blocks, sel, tB.blocks, sel, "union",
                       lambda a, b: a + b)
    with pytest.raises(TypeError, match="binary"):
        tkew.map_tiles(tA.blocks, sel, tB.blocks, sel, "union",
                       TS.ewise("abs"))
    with pytest.raises(ValueError, match="mode"):
        tkew.map_tiles(tA.blocks, sel, tB.blocks, sel, "xor", TS.PLUS)
    with pytest.raises(ValueError, match="selectors"):
        tkew.map_tiles(tA.blocks, sel + tA.nnzb, None, None, "apply",
                       TS.ewise("abs"))
    with pytest.raises(ValueError, match="scalar"):
        TS.ewise("ge")
    with pytest.raises(ValueError, match="unknown"):
        TS.ewise("xor")


# ---------------------------------------------------------------------------
# the grb family on BSR, ELL and dense operands, with descriptors
# ---------------------------------------------------------------------------
N, M = 150, 130


def operands(fmt, seed):
    """A, B, a mask and an out= of one kind, in both packages: (jax, port)
    pairs of handles, or of dense arrays / tensors."""
    rng = np.random.default_rng(seed)
    ents = [entries(rng, N, M, k, e) for k, e in
            ((600, range(0, 32)), (600, range(64, 96)), (1500, ()),
             (500, range(96, 128)))]
    out = []
    for r, c, v in ents:
        if fmt == "bsr":
            j, t = both_bsr((r, c, v), (N, M))
            out.append((jgrb.GBMatrix(j), tgrb.GBMatrix(t)))
        elif fmt == "ell":
            out.append((jgrb.GBMatrix(JELL.from_coo(r, c, v, (N, M))),
                        tgrb.GBMatrix(TELL.from_coo(r, c, v, (N, M),
                                                    device="cpu"))))
        else:
            d = np.zeros((N, M), np.float32)
            d[r, c] = v
            out.append((jnp.asarray(d), torch.from_numpy(d.copy())))
    return out


def dense_of(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tgrb.GBMatrix):
        return x.store.to_dense().numpy()
    if isinstance(x, jgrb.GBMatrix):
        return np.asarray(x.to_dense())
    return np.asarray(x)


def assert_result_same(want, got):
    np.testing.assert_array_equal(dense_of(want), dense_of(got))
    if isinstance(want, jgrb.GBMatrix):
        assert isinstance(got, tgrb.GBMatrix) and got.fmt == want.fmt
        assert got.nvals == want.nvals
        if want.fmt == "bsr":
            assert_bsr_same(want.store, got.store)


DESCS = {
    "none": dict(),
    "mask": dict(mask=True),
    "comp": dict(mask=True, complement=True),
    "accum": dict(accum=True, out=True),
    "mask_accum_out": dict(mask=True, accum=True, out=True),
    "mask_replace_out": dict(mask=True, replace=True, out=True),
    "comp_out": dict(mask=True, complement=True, out=True),
}


def descs(spec, jM, tM):
    j = jgrb.Descriptor(mask=jM if spec.get("mask") else None,
                        complement=spec.get("complement", False),
                        accum=JS.MIN if spec.get("accum") else None,
                        replace=spec.get("replace", False))
    t = tgrb.Descriptor(mask=tM if spec.get("mask") else None,
                        complement=spec.get("complement", False),
                        accum=TS.MIN if spec.get("accum") else None,
                        replace=spec.get("replace", False))
    return j, t


@pytest.mark.parametrize("fmt", ["bsr", "ell", "dense"])
@pytest.mark.parametrize("dname", list(DESCS))
def test_grb_ewise_family_matches_jax(fmt, dname):
    (jA, tA), (jB, tB), (jM, tM), (jO, tO) = operands(fmt, 7)
    spec = DESCS[dname]
    jd, td = descs(spec, jM, tM)
    jo, to = (jO, tO) if spec.get("out") else (None, None)
    assert_result_same(jgrb.ewise_add(jA, jB, JS.PLUS, jd, jo),
                       tgrb.ewise_add(tA, tB, TS.PLUS, td, to))
    assert_result_same(jgrb.ewise_mult(jA, jB, OPS["times"][0], jd, jo),
                       tgrb.ewise_mult(tA, tB, OPS["times"][1], td, to))
    assert_result_same(jgrb.apply(OPS["ainv"][0], jA, jd, jo),
                       tgrb.apply(OPS["ainv"][1], tA, td, to))
    assert_result_same(jgrb.select(OPS["gt(0)"][0], jA, jd, jo),
                       tgrb.select(OPS["gt(0)"][1], tA, td, to))


@pytest.mark.parametrize("fmt", ["bsr", "ell", "dense"])
@pytest.mark.parametrize("rows,cols", [
    (slice(32, 128), slice(0, 96)),              # block-aligned ranges
    (slice(5, 140), slice(33, 130)),             # unaligned
    ([3, 90, 17, 140], [0, 129, 64])])           # index vectors
def test_grb_extract_matches_jax(fmt, rows, cols):
    (jA, tA), _, _, _ = operands(fmt, 8)
    assert_result_same(jgrb.extract(jA, rows, cols),
                       tgrb.extract(tA, rows, cols))


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_grb_extract_with_descriptor_matches_jax(fmt):
    (jA, tA), (jB, tB), (jM, tM), _ = operands(fmt, 9)
    jd, td = descs(DESCS["mask_accum_out"], None, None)
    I, J = list(range(0, N, 2)), list(range(1, M, 2))
    jm = jgrb.extract(jM, I, J)
    tm = tgrb.extract(tM, I, J)
    jo = jgrb.extract(jB, I, J)
    to = tgrb.extract(tB, I, J)
    assert_result_same(jgrb.extract(jA, I, J, jd.with_(mask=jm), jo),
                       tgrb.extract(tA, I, J, td.with_(mask=tm), to))


@pytest.mark.parametrize("fmt", ["bsr", "ell", "dense"])
@pytest.mark.parametrize("dname", ["none", "mask", "mask_accum_out"])
def test_grb_assign_matches_jax(fmt, dname):
    (jA, tA), (jB, tB), (jM, tM), _ = operands(fmt, 10)
    I, J = list(range(10, 70)), list(range(40, 120))
    sub_j = jgrb.extract(jB, I, J)
    sub_t = tgrb.extract(tB, I, J)
    spec = dict(DESCS[dname])
    spec.pop("out", None)
    jd, td = descs(spec, jgrb.extract(jM, I, J), tgrb.extract(tM, I, J))
    assert_result_same(jgrb.assign(jA, sub_j, I, J, jd),
                       tgrb.assign(tA, sub_t, I, J, td))


@pytest.mark.parametrize("fmt", ["bsr", "ell", "dense", "bitadj"])
@pytest.mark.parametrize("monoid", ["plus", "or", "min", "max"])
def test_grb_reduce_matches_jax(fmt, monoid):
    if fmt == "bitadj":
        rng = np.random.default_rng(12)
        r, c, _ = entries(rng, N, M, 900)
        jA = jgrb.GBMatrix(JBitELL.from_coo(r, c, None, (N, M)))
        tA = tgrb.GBMatrix(TBitELL.from_coo(r, c, None, (N, M),
                                            device="cpu"))
    else:
        (jA, tA), _, _, _ = operands(fmt, 11)
    jm, tm = JS.__dict__[monoid.upper()], TS.__dict__[monoid.upper()]
    for axis in (None, 0, 1):
        want = np.asarray(jgrb.reduce(jA, jm, axis=axis))
        got = tgrb.reduce(tA, tm, axis=axis).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("fmt", ["bsr", "ell"])
def test_reduce_plus_is_exact_past_2_24(fmt):
    """Stored entries summing to 2^24 + 1001 (odd, so no float32 holds
    it): the float64 accumulation returns it exactly, and float32 results
    are its one rounding, in every row-sum / column-sum / total."""
    r = np.concatenate([[0, 0], np.arange(1001) % 90 + 1])
    c = np.concatenate([[0, 1], np.arange(1001) % 37 + 3])
    v = np.concatenate([[2.0 ** 23, 2.0 ** 23], np.ones(1001)])
    key = np.unique(r * 64 + c, return_index=True)[1]   # no duplicates
    r, c, v = r[key], c[key], v[key]
    exact = int(v.sum())
    assert exact > 2 ** 24 and exact % 2 == 1
    if fmt == "bsr":
        A = tgrb.GBMatrix(TBSR.from_coo(r, c, v, (100, 64), block=32,
                                        device="cpu"))
    else:
        A = tgrb.GBMatrix(TELL.from_coo(r, c, v, (100, 64), device="cpu"))
    assert int(tgrb.reduce(A, TS.PLUS, dtype=torch.float64)) == exact
    assert float(tgrb.reduce(A, TS.PLUS)) == float(np.float32(exact))
    rows = tgrb.reduce(A, TS.PLUS, axis=1, dtype=torch.float64).numpy()
    assert np.array_equal(rows, np.bincount(r, v, minlength=100))
    # many rows at 2^23 + 1 each: exact per-row sums, then the total
    r2 = np.repeat(np.arange(100), 3)
    c2 = np.tile([0, 1, 2], 100)
    v2 = np.tile([2.0 ** 22, 2.0 ** 22, 1.0], 100)
    B = tgrb.GBMatrix(TBSR.from_coo(r2, c2, v2, (100, 64), block=32,
                                    device="cpu"))
    assert int(tgrb.reduce(B, TS.PLUS, dtype=torch.float64)) == \
        int(v2.sum())
    cols = tgrb.reduce(B, TS.PLUS, axis=0, dtype=torch.float64).numpy()
    assert cols[2] == 100 and cols[0] == 100 * 2.0 ** 22


def test_bare_callables_raise_on_bsr_only():
    """A CUDA kernel cannot call a Python function: on BSR operands a bare
    callable raises TypeError naming the ops, on the CPU too; dense
    tensors and ELL take any callable, as in the JAX package."""
    for fmt in ("bsr", "ell", "dense"):
        (jA, tA), (jB, tB), _, _ = operands(fmt, 13)
        calls = [lambda: tgrb.ewise_add(tA, tB, lambda a, b: a + b),
                 lambda: tgrb.ewise_mult(tA, tB, lambda a, b: a * b),
                 lambda: tgrb.apply(lambda a: a * 2, tA),
                 lambda: tgrb.select(lambda a: a > 0, tA)]
        for call in calls:
            if fmt == "bsr":
                with pytest.raises(TypeError, match="named ops: binary"):
                    call()
            else:
                call()
        if fmt != "bsr":
            assert_result_same(jgrb.apply(lambda a: a * 2, jA),
                               tgrb.apply(lambda a: a * 2, tA))


def test_mixed_kinds_raise_like_jax():
    (jA, tA), _, _, _ = operands("bsr", 14)
    (jD, tD), _, _, _ = operands("dense", 14)
    with pytest.raises(TypeError):
        jgrb.ewise_add(jA, jD, JS.PLUS)
    with pytest.raises(TypeError, match="operand kinds must match"):
        tgrb.ewise_add(tA, tD, TS.PLUS)
    with pytest.raises(ValueError):
        tgrb.ewise_mult(tA, tgrb.extract(tA, range(10), None), TS.PLUS)
    with pytest.raises(ValueError, match="duplicate"):
        tgrb.extract(tA, [1, 1], None)
    # a dense tensor makes a dense handle, as in the JAX package; a kind
    # the port does not hold still raises
    assert tgrb.GBMatrix(tD).fmt == jgrb.GBMatrix(jD).fmt == "dense"
    with pytest.raises(NotImplementedError, match="not ported"):
        tgrb.GBMatrix(tD[0])
