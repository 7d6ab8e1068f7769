"""PyTorch port, core layer: bitmap words, ELL / BitELL storage and the two
word kernels' plain versions, held bit-identical against the JAX package.

Inputs come from numpy with fixed seeds and go through both packages.
Everything compared here is boolean or integer, so the tolerance is
bit-identity: words are compared as uint32 (``.numpy().view(np.uint32)``)
and include words with bit 31 set. The CUDA kernels themselves are
tested on the card by ``tests/test_torch_cuda.py``.
"""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitadj as jbitadj
from repro.core import bitmap as jbitmap
from repro.core import ops as jops
from repro.core.bitadj import BitELL as JBitELL
from repro.core.ell import ELL as JELL
from repro.kernels import bitadj_mxv as jbitadj_mxv
from repro.kernels import bitmap_mxv as jbitmap_mxv
from repro_torch.core import bitadj as tbitadj
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import ops as tops
from repro_torch.core.bitadj import BitELL as TBitELL
from repro_torch.core.ell import ELL as TELL
from repro_torch.graph.graph import GraphBuilder
from repro_torch.kernels import bitadj_mxv as tbitadj_mxv
from repro_torch.kernels import bitmap_mxv as tbitmap_mxv
from repro_torch.kernels import ops as tkops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def words(rng, n, w) -> np.ndarray:
    """Random uint32 words, about half of them with bit 31 set."""
    return rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def coo(rng, n, k, m, empty_rows=()):
    """Random edges with skewed panels: row 2 reaches every column tile,
    rows past the first 32-row panel keep to one column tile each, so the
    narrower panels end in sentinel slots."""
    r = rng.integers(0, n, size=m)
    c = rng.integers(0, k, size=m)
    C = -(-k // 32)
    own = np.minimum((r // 32 % C) * 32 + c % 32, k - 1)
    c = np.where(r >= 32, own, c)
    hub = np.arange(0, k, 3)
    r, c = np.concatenate([r, np.full(len(hub), 2)]), np.concatenate([c, hub])
    keep = ~np.isin(r, list(empty_rows))
    return r[keep], c[keep]


# -- the port imports nothing of JAX -----------------------------------------
def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # every submodule loaded


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    hits = []
    for p in paths:
        with open(p) as f:
            hits += [(p, m.group(0)) for m in pat.finditer(f.read())]
    assert len(paths) > 20 and not hits, hits


def test_build_defaults_to_cuda():
    b = GraphBuilder(4).add_edges("R", [0, 1], [1, 2])
    if torch.cuda.is_available():
        assert b.build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            b.build()


# -- bitmap words ---------------------------------------------------------------
@pytest.mark.parametrize("f", [1, 5, 31, 32, 33, 64, 100])
def test_pack_unpack_match_reference(f):
    rng = np.random.default_rng(f)
    x = (rng.random((37, f)) < 0.5).astype(np.float32)
    x[:, f - 1] = 1.0                       # the last column, bit 31 at f=32
    want = np.asarray(jbitmap.pack(jnp.asarray(x)))
    got = tbitmap.pack(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(
        tbitmap.unpack(got, f).numpy(),
        np.asarray(jbitmap.unpack(jnp.asarray(want), f)))
    assert tbitmap.n_words(f) == jbitmap.n_words(f)


def test_word_algebra_and_popcount_match_reference():
    rng = np.random.default_rng(0)
    a, b = words(rng, 64, 3), words(rng, 64, 3)
    a[0, :] = [0xFFFFFFFF, 0x80000000, 0]
    ta, tb = (torch.from_numpy(v.view(np.int32)) for v in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for tf, jf in [(tbitmap.word_or, jbitmap.word_or),
                   (tbitmap.word_and, jbitmap.word_and),
                   (tbitmap.word_andnot, jbitmap.word_andnot)]:
        np.testing.assert_array_equal(u32(tf(ta, tb)), np.asarray(jf(ja, jb)))
    np.testing.assert_array_equal(tbitmap.popcount(ta).numpy(),
                                  np.asarray(jbitmap.popcount(ja)))
    assert tbitmap.popcount(ta)[0].tolist() == [32, 1, 0]


# -- storage layouts --------------------------------------------------------------
@pytest.mark.parametrize("n,k,m", [(45, 70, 300), (64, 64, 900),
                                   (100, 33, 50)])
def test_ell_layout_matches_reference(n, k, m):
    rng = np.random.default_rng(n + k)
    r, c = coo(rng, n, k, m, empty_rows=(0, 3))
    v = rng.random(len(r)).astype(np.float32)
    je = JELL.from_coo(r, c, v, (n, k))
    te = TELL.from_coo(r, c, v, (n, k), device="cpu")
    assert te.shape == je.shape and te.nnz == je.nnz
    for name in ("indices", "mask", "values"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)))
    jt, tt = je.transpose(), te.transpose()
    assert tt.shape == jt.shape and tt.nnz == jt.nnz
    for name in ("indices", "mask", "values"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    np.testing.assert_array_equal(te.to_dense().numpy(),
                                  np.asarray(je.to_dense()))
    for a, b in zip(te.to_coo(), je.to_coo()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,k,m", [(45, 70, 300), (64, 64, 900),
                                   (100, 33, 50), (200, 200, 4000)])
def test_bitell_layout_matches_reference(n, k, m):
    rng = np.random.default_rng(n * k)
    r, c = coo(rng, n, k, m, empty_rows=(1, 40))
    r[:3], c[:3] = 5, [31, 31, 3]            # a duplicate edge, bit 31 set
    jb = JBitELL.from_coo(r, c, None, (n, k))
    tb = TBitELL.from_coo(r, c, None, (n, k), device="cpu")
    assert tb.nnz == jb.nnz and tb.shape == jb.shape
    np.testing.assert_array_equal(u32(tb.tiles), np.asarray(jb.tiles))
    np.testing.assert_array_equal(tb.cols.numpy(), np.asarray(jb.cols))
    assert (tb.cols.numpy() == tb.n_ctiles).any()      # sentinel slots exist
    jt, tt = jb.transpose(), tb.transpose()
    np.testing.assert_array_equal(u32(tt.tiles), np.asarray(jt.tiles))
    np.testing.assert_array_equal(tt.cols.numpy(), np.asarray(jt.cols))
    je, te = jb.to_ell(), tb.to_ell()
    for name in ("indices", "mask", "values"):
        np.testing.assert_array_equal(getattr(te, name).numpy(),
                                      np.asarray(getattr(je, name)))
    with pytest.raises(TypeError, match="weights"):
        TBitELL.from_coo(r, c, np.full(len(r), 2.0), (n, k), device="cpu")


@pytest.mark.parametrize("n,k,m", [(45, 70, 300), (100, 33, 50),
                                   (200, 200, 4000)])
def test_kernel_operands_put_valid_slots_first(n, k, m):
    """The CUDA kernels stop at a row's (ELL) or panel's (BitELL) first
    sentinel slot, so their cached operands hold the valid slots first:
    as stored for ``from_coo`` builds, reordered within the row or panel
    for storage in any other slot order."""
    rng = np.random.default_rng(n + m)
    r, c = coo(rng, n, k, m, empty_rows=(0, 3))
    te = TELL.from_coo(r, c, None, (n, k), device="cpu")
    tb = TBitELL.from_coo(r, c, None, (n, k), device="cpu")
    np.testing.assert_array_equal(
        te.sentinel_indices().numpy(),
        np.where(te.mask.numpy(), te.indices.numpy(), k))
    assert tb.occupied_first()[0] is tb.tiles
    assert tb.occupied_first()[1] is tb.cols
    # the same structures with their slots shuffled
    oe = torch.from_numpy(np.argsort(rng.random(te.indices.shape), axis=1))
    se = TELL(te.shape, te.indices.gather(1, oe), te.mask.gather(1, oe),
              te.values.gather(1, oe), te.nnz)
    ob = torch.from_numpy(np.argsort(rng.random(tb.cols.shape), axis=1))
    sb = TBitELL(tb.shape, tb.tiles.gather(1, ob[:, :, None].expand(
        -1, -1, 32)), tb.cols.gather(1, ob), tb.nnz)
    idx = se.sentinel_indices().numpy()
    deg = te.mask.numpy().sum(axis=1)
    for i in range(n):
        np.testing.assert_array_equal(np.sort(idx[i, :deg[i]]),
                                      np.sort(te.indices[i, :deg[i]].numpy()))
        assert (idx[i, deg[i]:] == k).all()
    tiles, cols = sb.occupied_first()
    occ = (tb.cols < tb.n_ctiles).sum(dim=1).numpy()
    for p in range(tb.n_panels):
        o = occ[p]
        got = sorted(zip(cols[p, :o].tolist(), tiles[p, :o].tolist()))
        want = sorted(zip(tb.cols[p, :o].tolist(), tb.tiles[p, :o].tolist()))
        assert got == want
        assert (cols[p, o:] == tb.n_ctiles).all()
    xw = torch.from_numpy(words(rng, k, 3).view(np.int32))
    assert torch.equal(tbitadj.panels_mxm_words(tiles, cols, xw, k),
                       tbitadj.panels_mxm_words(tb.tiles, tb.cols, xw, k))


def test_with_impl_is_a_no_op():
    from repro_torch.core import grb
    A = grb.GBMatrix(TELL.from_coo([0, 1], [1, 2], None, (3, 3),
                                   device="cpu"), name="R")
    assert A.with_impl("xla") is A and A.with_impl("pallas") is A
    assert repr(A) == "GBMatrix 'R' 3x3 fmt=ell nvals=2"


def _rmat(scale, seed=0):
    from repro.graph.datagen import rmat_edges
    src, dst, n = rmat_edges(scale, seed=seed)
    key = np.unique(src * n + dst)
    return key // n, key % n, n


@pytest.mark.parametrize("case", ["rmat8", "rmat11", "diag", "hub", "block"])
def test_auto_policy_matches_reference(case):
    if case.startswith("rmat"):
        r, c, n = _rmat(int(case[4:]))
        shape = (n, n)
    elif case == "diag":
        n = 256
        r = c = np.arange(n)
        shape = (n, n)
    elif case == "hub":
        c = np.arange(0, 32 * (jbitadj.AUTO_BITADJ_MAX_SLOTS + 1), 32)
        r = np.zeros_like(c)
        shape = (c[-1] + 1, c[-1] + 1)
    else:                                    # a dense 128-block, weighted
        r, c = np.nonzero(np.ones((128, 128)))
        shape = (512, 512)
    vals = np.full(len(r), 2.0, np.float32) if case == "block" else None
    assert tbitadj.auto_bitadj_ok(r, c, vals, shape) == \
        jbitadj.auto_bitadj_ok(r, c, vals, shape)
    assert tbitadj._tile_stats(r, c, shape) == jbitadj._tile_stats(r, c, shape)
    want = type(jops.auto_format(r, c, vals, shape)).__name__
    got = tops.auto_format(r, c, vals, shape, device="cpu")
    assert type(got).__name__ == want


# -- the kernels' plain versions against the JAX references and Pallas -----------
KERNEL_CASES = [(45, 70, 1), (45, 70, 16), (64, 64, 1), (100, 33, 16),
                (33, 100, 2)]


@pytest.mark.parametrize("n,k,w", KERNEL_CASES)
def test_ell_packed_matches_reference_and_pallas(n, k, w):
    rng = np.random.default_rng(n * 7 + w)
    r, c = coo(rng, n, k, 4 * n, empty_rows=(0, n - 1))
    xw = words(rng, k, w)
    je = JELL.from_coo(r, c, None, (n, k))
    te = TELL.from_coo(r, c, None, (n, k), device="cpu")
    want = np.asarray(jops.ell_mxm_packed(je, jnp.asarray(xw)))
    pallas = np.asarray(jbitmap_mxv.ell_mxv_packed(je, jnp.asarray(xw),
                                                   interpret=True))
    np.testing.assert_array_equal(pallas, want)
    xt = torch.from_numpy(xw.view(np.int32))
    np.testing.assert_array_equal(u32(tops.ell_mxm_packed(te, xt)), want)
    before = tbitmap_mxv.launches
    np.testing.assert_array_equal(u32(tkops.ell_mxv_packed(te, xt)), want)
    assert tbitmap_mxv.launches == before     # CPU tensors: plain version
    assert not want[0].any() and not want[n - 1].any()     # empty rows


@pytest.mark.parametrize("n,k,w", KERNEL_CASES)
def test_bitadj_panels_match_reference_and_pallas(n, k, w):
    rng = np.random.default_rng(n * 11 + w)
    r, c = coo(rng, n, k, 4 * n, empty_rows=(0, n - 1))
    xw = words(rng, k, w)
    jb = JBitELL.from_coo(r, c, None, (n, k))
    tb = TBitELL.from_coo(r, c, None, (n, k), device="cpu")
    assert (tb.cols.numpy() == tb.n_ctiles).any()      # sentinel tile read
    want = np.asarray(jbitadj.mxm_words(jb, jnp.asarray(xw)))
    pallas = np.asarray(jbitadj_mxv.bitadj_mxv_packed(jb, jnp.asarray(xw),
                                                      interpret=True))
    np.testing.assert_array_equal(pallas, want)
    xt = torch.from_numpy(xw.view(np.int32))
    np.testing.assert_array_equal(
        u32(tbitadj.panels_mxm_words(tb.tiles, tb.cols, xt, k)[:n]), want)
    np.testing.assert_array_equal(
        u32(tbitadj.panels_mxm_words(tb.tiles, tb.cols, xt, k,
                                     slot_chunk=3)[:n]), want)
    before = tbitadj_mxv.launches
    np.testing.assert_array_equal(u32(tkops.bitadj_mxv_packed(tb, xt)), want)
    assert tbitadj_mxv.launches == before     # CPU tensors: plain version


@pytest.mark.parametrize("rows", [60, 100, 200])
def test_bitadj_pad_query_tiles_truncate_then_pad(rows):
    rng = np.random.default_rng(rows)
    xw = words(rng, rows, 2)
    want = np.asarray(jbitadj._pad_query_tiles(jnp.asarray(xw), 70))
    got = tbitadj._pad_query_tiles(torch.from_numpy(xw.view(np.int32)), 70)
    np.testing.assert_array_equal(u32(got), want)
