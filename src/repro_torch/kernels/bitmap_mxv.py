"""Packed or_and gather-OR over ELL rows: Yw = A_ell (|) Xw.

Port of ``repro.kernels.bitmap_mxv`` (the Pallas TPU kernel
``ell_mxv_packed``). The kernel is hand-written CUDA C++ for ``sm_90a``,
``csrc/ell_mxv_packed.cu``; its source notes what bounds it and why it is
shaped as it is. It reads the handle's valid ids as a CSR
(``ELL.row_csr``) split into items of L ids (``ELL.item_plan``), one warp
an item, so a hub row is spread over many warps.

``ell_mxv_packed(A, Xw)`` launches the kernel when its tensors lie on a
CUDA device and takes the plain version, ``core.ops.ell_mxm_packed``, when
they lie on the CPU. ``launches`` counts kernel launches.
``ell_mxv_items`` launches it on a given CSR and plan;
``ell_mxv_items_plain`` is the same item-wise evaluation in plain torch,
which the tests hold against the JAX package. ``launch_cost`` is the work
one launch needs, the count its bound is taken from.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ell import (ELL, FIRST_EDGE, LAST_EDGE, ROW_BITS,
                                  ItemPlan, RowCSR)
from repro_torch.kernels import KernelError
from repro_torch.core.ops import ell_mxm_packed  # the plain version

launches = 0          # kernel launches since import (plain calls excluded)

_bound = None


def _fn():
    global _bound
    if _bound is None:
        from repro_torch.kernels import build
        fn = build.load("ell_mxv_packed").ell_mxv_packed
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound = fn
    return _bound


def launch_cost(rows: int, slots: int, words: int, cols: int, valid=None):
    """``(bytes, int32 operations)`` one launch needs over ``rows`` ELL rows
    of ``slots`` padded slots against a ``(cols, words)`` frontier: each
    row's valid ids and the sentinel that ends it (rows are valid-first,
    so ``min(valid + 1, slots)`` ids), the frontier and the ``(rows,
    words)`` output, each read or written once at 4 bytes; one OR a valid
    slot and word. ``valid``: each row's valid slots (a tensor); None
    counts every slot valid (the dry-run, which has no data)."""
    if valid is None:
        ids = edges = rows * slots
    else:
        ids = int(torch.clamp(valid + 1, max=slots).sum())
        edges = int(valid.sum())
    return ids * 4 + cols * words * 4 + rows * words * 4, edges * words


def ell_mxv_items(csr: RowCSR, plan: ItemPlan, Xw: torch.Tensor
                  ) -> torch.Tensor:
    """Launch the kernel over ``plan``'s items of ``csr``: (n, W) words
    from the contiguous (k, W) int32 frontier ``Xw`` on one CUDA device."""
    global launches
    n = csr.row_ptr.shape[0] - 1
    if not (Xw.is_cuda and Xw.dim() == 2 and Xw.dtype == torch.int32
            and Xw.is_contiguous() and csr.ids.device == Xw.device
            and plan.edge_rows.device == Xw.device
            and plan.edge_rows.shape == csr.ids.shape):
        raise ValueError("ell_mxv_items: Xw must be contiguous (k, W) int32 "
                         "words on the CUDA device of the CSR and its plan")
    W = Xw.shape[1]
    y = torch.empty((n, W), dtype=torch.int32, device=Xw.device)
    vec = W % 4 == 0 and Xw.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    rc = _fn()(csr.ids.data_ptr(), plan.edge_rows.data_ptr(),
               plan.zero_rows.data_ptr(), plan.zero_rows.shape[0],
               Xw.data_ptr(), y.data_ptr(), csr.ids.shape[0], plan.L, W,
               int(vec), torch.cuda.current_stream(Xw.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"ell_mxv_packed: kernel launch failed, "
                          f"cudaError {rc}")
    launches += 1
    return y


def ell_mxv_packed(A: ELL, Xw: torch.Tensor) -> torch.Tensor:
    """Yw[i] = OR_{j in adj(i)} Xw[j] over int32 words (uint32 bit
    pattern). A: ELL adjacency (only the structure is used); Xw: (k, W)
    packed frontier, k = A.shape[1]. Returns (n, W) words."""
    n, k = A.shape
    if Xw.dim() != 2 or Xw.shape[0] != k:
        raise ValueError(f"ell_mxv_packed: Xw must be (k={k}, W), got "
                         f"{tuple(Xw.shape)}")
    if Xw.dtype != torch.int32:
        raise TypeError(f"ell_mxv_packed: Xw must be int32 words, got "
                        f"{Xw.dtype}")
    if A.device.type == "cpu" and Xw.device.type == "cpu":
        return ell_mxm_packed(A, Xw)
    if not (A.device.type == "cuda" and Xw.device == A.device):
        raise ValueError(f"ell_mxv_packed: A on {A.device}, Xw on "
                         f"{Xw.device}; both must lie on one CUDA device "
                         f"(or both on the CPU)")
    if A.indices.dtype != torch.int32:
        raise TypeError("ell_mxv_packed: ELL indices must be int32")
    return ell_mxv_items(A.row_csr(), A.item_plan(), Xw.contiguous())


def ell_mxv_items_plain(csr: RowCSR, plan: ItemPlan, Xw: torch.Tensor
                        ) -> torch.Tensor:
    """The kernel's item-wise evaluation in plain torch: the output starts
    all ones (so a row that nothing writes shows), ``plan.zero_rows`` are
    zeroed, each item ORs its rows' ids, and a row whole inside one item is
    stored while a row cut by an item boundary is ORed in."""
    n = csr.row_ptr.shape[0] - 1
    k, W = Xw.shape
    dev = Xw.device
    y = torch.full((n, W), -1, dtype=torch.int32, device=dev)
    y[plan.zero_rows.long()] = 0
    nnz = csr.ids.shape[0]
    if nnz == 0:
        return y
    word = plan.edge_rows.long() & 0xFFFFFFFF
    row = word & ((1 << ROW_BITS) - 1)
    first = (word & FIRST_EDGE) != 0
    last = (word & LAST_EDGE) != 0
    e = torch.arange(nnz, device=dev)
    # a segment: one row's ids inside one item
    opens = first | (e % plan.L == 0)
    seg = torch.cumsum(opens.long(), dim=0) - 1
    start = torch.nonzero(opens).flatten()
    end = torch.cat([start[1:], start.new_tensor([nnz])]) - 1
    pos = e - start[seg]
    pad = torch.full((start.shape[0], int(pos.max()) + 1), k,
                     dtype=torch.int64, device=dev)
    pad[seg, pos] = csr.ids.long()
    Xe = torch.cat([Xw, Xw.new_zeros((1, W))])     # row k: the zero row
    vals = torch.zeros((start.shape[0], W), dtype=Xw.dtype, device=dev)
    for s in range(pad.shape[1]):
        vals |= Xe.index_select(0, pad[:, s])
    rows = row[start]
    whole = first[start] & last[end]
    y[rows[whole]] = vals[whole]
    cut_rows, cut_vals = rows[~whole], vals[~whole]   # rows ascend
    rank = torch.arange(cut_rows.shape[0], device=dev) - torch.searchsorted(
        cut_rows, cut_rows)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == r
        y[cut_rows[sel]] |= cut_vals[sel]
    return y
