"""Masked dot-product SpGEMM: C<M> = A (x) B evaluated at each stored entry
(i, j) of a structural mask M as the dot product of A's row i and B's
column j (GraphBLAS's "dot3" method), over row CSRs, with no tile made.

No Pallas kernel of the JAX package computes this: its SpGEMM is the tile
product (``kernels.bsr_spgemm``), which this route replaces where the mask
is not complemented and the operands' tiles are sparse (``core.grb``'s
route rule). ``masked_dot(A, Bt, m_rows, m_cols, sr)`` takes A's row CSR,
the row CSR of B's transpose (B's columns) and the mask's entries, and
returns one float32 per mask entry, in the mask's order, and the work: the
sum over the mask's entries of the shorter list's length. On CUDA tensors
it launches the hand-written ``csrc/bsr_spgemm_dot.cu``; on CPU tensors it
takes the plain version, ``masked_dot_plain``. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import semiring as S
from repro_torch.core import xfer
from repro_torch.core.bsr import SPGEMM_MODES, RowCSR, csr_rows
from repro_torch.kernels import KernelError

launches = 0          # kernel launches since import (plain calls excluded)

CHUNK = 128           # walked elements per unit in the 0/1 modes (the
#                       kernel's CHUNK)
_MODES = {"dot": 0, "dot_indicator": 1, "dot_pair": 2, "dot_first": 3}
_VALUED = ("dot", "dot_first")
# (entry, walked element) pairs of one chunk of the plain version
_CHUNK_PAIRS = 1 << 24
_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("bsr_spgemm_dot").bsr_spgemm_dot
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def _lengths(A: RowCSR, Bt: RowCSR, m_rows, m_cols):
    """(E,) int64 each: the lengths of A's row and of B's column behind
    every mask entry."""
    i, j = m_rows.long(), m_cols.long()
    return (A.indptr[i + 1] - A.indptr[i], Bt.indptr[j + 1] - Bt.indptr[j])


def _check(A: RowCSR, Bt: RowCSR, m_rows, m_cols, sr, what: str):
    if sr.mode not in SPGEMM_MODES:
        raise NotImplementedError(f"{what}: mode {sr.mode!r}")
    if m_rows.shape != m_cols.shape:
        raise ValueError(f"{what}: {tuple(m_rows.shape)} mask rows against "
                         f"{tuple(m_cols.shape)} columns")


def _walk(out, W, O, w_list, o_list, ent, width, term_of):
    """Adds, for each mask entry ``ent[e]``, the terms of the matches of
    list ``w_list[e]`` of ``W`` (walked) among list ``o_list[e]`` of ``O``
    (``searchsorted`` on O's row-major keys) into ``out``, over chunks of
    walked elements. ``term_of(wpos, opos)`` gives the matches' float64
    terms."""
    dev = out.device
    okeys = csr_rows(O) * width + O.cols.long()
    lw = W.indptr[w_list + 1] - W.indptr[w_list]
    ends = torch.cumsum(lw, 0)
    E = int(ent.shape[0])
    lo = 0
    while lo < E and okeys.numel():
        start = int(ends[lo - 1]) if lo else 0
        hi = max(int(torch.searchsorted(ends, start + _CHUNK_PAIRS,
                                        right=True)), lo + 1)
        n_pairs = int(lw[lo:hi].sum())
        seg = torch.arange(lo, hi, device=dev)
        e = torch.repeat_interleave(seg, lw[lo:hi], output_size=n_pairs)
        wpos = (W.indptr[w_list[e]] - (ends[e] - lw[e])
                + torch.arange(start, start + n_pairs, device=dev))
        want = o_list[e] * width + W.cols[wpos].long()
        opos = torch.searchsorted(okeys, want).clamp_(max=okeys.numel() - 1)
        hit = okeys[opos] == want
        out.index_add_(0, ent[e[hit]], term_of(wpos[hit], opos[hit]))
        lo = hi


def masked_dot_plain(A: RowCSR, Bt: RowCSR, m_rows: torch.Tensor,
                     m_cols: torch.Tensor, sr: S.Semiring) -> torch.Tensor:
    """The kernel's work in plain torch: for each mask entry (i, j) the
    shorter of A's row i and B's column j (A's row on a tie) is walked and
    each of its columns looked up in the other list, the matches' terms
    summed per mask entry in float64 and rounded to float32, over chunks
    of walked elements. Returns (E,) float32."""
    _check(A, Bt, m_rows, m_cols, sr, "masked_dot_plain")
    dev = m_rows.device
    E = int(m_rows.shape[0])
    out = torch.zeros(E, dtype=torch.float64, device=dev)
    if E == 0:
        return out.to(torch.float32)
    width = max(int(A.cols.max()) + 1 if A.entries else 1,
                int(Bt.cols.max()) + 1 if Bt.entries else 1)
    i, j = m_rows.long(), m_cols.long()
    la, lb = _lengths(A, Bt, m_rows, m_cols)
    walk_a = la <= lb
    for W, O, wl, ol, sel, w_is_a in ((A, Bt, i, j, walk_a, True),
                                      (Bt, A, j, i, ~walk_a, False)):
        def term_of(wpos, opos, W=W, O=O, w_is_a=w_is_a):
            if sr.mode == "dot":
                return W.vals[wpos].double() * O.vals[opos].double()
            if sr.mode == "dot_first":
                return (W.vals[wpos] if w_is_a else O.vals[opos]).double()
            return torch.ones(wpos.shape[0], dtype=torch.float64,
                              device=dev)
        ent = torch.nonzero(sel).flatten()
        _walk(out, W, O, wl[ent], ol[ent], ent, width, term_of)
    if sr.mode == "dot_indicator":
        out = (out > 0).to(torch.float64)
    return out.to(torch.float32)


def masked_dot(A: RowCSR, Bt: RowCSR, m_rows: torch.Tensor,
               m_cols: torch.Tensor, sr: S.Semiring
               ) -> Tuple[torch.Tensor, int]:
    """C's value at each mask entry (m_rows[e], m_cols[e]), (E,) float32
    in the mask's order, and the work: the sum over the entries of
    min(|A(i,:)|, |B(:,j)|). On CUDA the kernel runs; its units are laid
    out here in torch on the card, and one copy of two counts crosses to
    the host (``core.xfer``, tag ``dot``). The values of a valued mode
    (dot, dot_first) must be finite: the caller routes others to the tile
    route."""
    global launches
    _check(A, Bt, m_rows, m_cols, sr, "masked_dot")
    dev = m_rows.device
    E = int(m_rows.shape[0])
    la, lb = _lengths(A, Bt, m_rows, m_cols)
    walk = torch.minimum(la, lb)
    if dev.type == "cpu":
        return (masked_dot_plain(A, Bt, m_rows, m_cols, sr),
                int(walk.sum()))
    tensors = [A.indptr, A.cols, Bt.indptr, Bt.cols, m_cols]
    if not all(t.device == dev for t in tensors):
        raise ValueError(f"masked_dot: tensors on "
                         f"{[str(t.device) for t in tensors]}; all must lie "
                         f"on one CUDA device (or all on the CPU)")
    if E >= 2 ** 31:
        raise ValueError(f"masked_dot: {E} mask entries; the kernel indexes "
                         f"them in 32 bits")
    c = torch.zeros(E, dtype=torch.float32, device=dev)
    if E == 0:
        return c, 0
    per = ((walk > 0).to(torch.int64) if sr.mode in _VALUED
           else -(-walk // CHUNK))
    counts = torch.stack([per.sum(), walk.sum()])
    units, work = (int(v) for v in xfer.to_host(counts, "dot"))
    if units == 0:
        return c, work
    unit_entry = torch.repeat_interleave(
        torch.arange(E, dtype=torch.int32, device=dev), per,
        output_size=units)
    unit_chunk = (torch.arange(units, device=dev) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per, output_size=units)).to(torch.int32)
    m_rows = m_rows.to(torch.int32).contiguous()
    m_cols = m_cols.to(torch.int32).contiguous()
    rc = _fn()(A.indptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(),
               Bt.indptr.data_ptr(), Bt.cols.data_ptr(), Bt.vals.data_ptr(),
               m_rows.data_ptr(), m_cols.data_ptr(), unit_entry.data_ptr(),
               unit_chunk.data_ptr(), units, c.data_ptr(),
               _MODES[sr.mode], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"bsr_spgemm_dot: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    return c, work
