"""Bitmap-packed boolean frontiers: 32 queries per 32-bit word.

Port of ``repro.core.bitmap``: the bit lanes, and the nibble lanes the
mesh's transposed product sums across row shards. An (n, F) boolean
frontier becomes
an (n, ceil(F/32)) word array; bit b of word w of row i is
``x[i, 32*w + b] != 0``, the reference's layout bit for bit.

Words are stored as ``torch.int32`` holding the uint32 bit pattern: torch
on the CPU has no ``>>``, ``~`` or shifts for ``uint32``. So every right
shift is followed by a mask (``>>`` on int32 is arithmetic), and sums that
could reach bit 31 run in int64. CUDA kernels read the same storage as
``uint32_t``; tests compare with ``.numpy().view(np.uint32)``.
"""
from __future__ import annotations

import torch

WORD_BITS = 32          # bit lanes per word (the frontier form)
NIBBLE_LANES = 8        # 4-bit lanes per word (the summable form)
# 4-bit lanes hold sums up to 15: a psum of at most this many 0/1 nibble
# words never carries into the next lane
NIBBLE_MAX_SHARDS = 15

# -- observability: how many times a frontier was packed ----------------------
_pack_calls = [0]


def pack_calls() -> int:
    """Total :func:`pack` invocations so far (policy-pin counter)."""
    return _pack_calls[0]


def n_words(f: int) -> int:
    """Words per frontier row for an F-column boolean frontier."""
    return max(-(-int(f) // WORD_BITS), 1)


def _to_int32_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors with the same 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def payload_bytes(rows: int, f: int, packed: bool) -> int:
    """Bytes of one (rows, F) frontier: float32 indicators (4 bytes an
    entry) unpacked, 32-bit words packed."""
    if packed:
        return rows * n_words(f) * 4
    return rows * f * 4


def payload_reduction(f: int) -> float:
    """Unpacked over packed bytes of an F-wide frontier (-> 32x as F
    grows; >= 8x from F = 8)."""
    return payload_bytes(1, f, packed=False) / payload_bytes(1, f, packed=True)


def pack(x: torch.Tensor) -> torch.Tensor:
    """(n, F) anything-numeric -> (n, ceil(F/32)) int32 words (uint32 bit
    pattern). Distinct bit weights sum in int64, then wrap to int32."""
    _pack_calls[0] += 1
    return _pack_words(x)


def _pack_words(x: torch.Tensor) -> torch.Tensor:
    """:func:`pack` without the policy counter (products that re-pack
    their own partial results)."""
    n, f = x.shape
    w = n_words(f)
    bits = torch.zeros((n, w * WORD_BITS), dtype=torch.int64, device=x.device)
    bits[:, :f] = (x != 0).to(torch.int64)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=x.device) << \
        torch.arange(WORD_BITS, dtype=torch.int64, device=x.device)
    return _to_int32_words((bits.reshape(n, w, WORD_BITS) * weights).sum(dim=2))


def unpack(xw: torch.Tensor, f: int) -> torch.Tensor:
    """(n, W) words -> (n, f) float32 0/1 indicators."""
    n, w = xw.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=xw.device)
    bits = (xw[:, :, None] >> shifts) & 1
    return bits.reshape(n, w * WORD_BITS)[:, :f].to(torch.float32)


# -- word-wise boolean algebra (mask / complement / visited blends) -----------
def word_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Frontier union — the or_and add monoid on words."""
    return a | b


def word_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`C<M>` mask keep on words."""
    return a & b


def word_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`C<!M>` complement-mask keep on words: a & ~b (the BFS visited
    blend)."""
    return a & ~b


def popcount(xw: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count (SWAR in int64), int32 words in -> int32 out."""
    x = xw.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def reduce_or_columns(xw: torch.Tensor, f: int) -> torch.Tensor:
    """(n, W) words -> (f,) float32 per-query reached counts (the packed
    ``grb.reduce(plus, axis=0)`` of an indicator frontier). A popcount
    counts a word's 32 queries of one row; this counts one query's rows,
    bit by bit in int64, so the counts stay exact past 2^24 rows (the JAX
    package sums float32, equal below that)."""
    n, w = xw.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=xw.device)
    bits = (xw[:, :, None] >> shifts) & 1                   # (n, W, 32)
    per = bits.sum(dim=0, dtype=torch.int64).reshape(w * WORD_BITS)
    return per[:f].to(torch.float32)


# -- nibble lanes: the summable packing for add-only collectives --------------
def pack_nibbles(bits: torch.Tensor) -> torch.Tensor:
    """(n, F) 0/1 partials -> (n, ceil(F/8)) int32 words (uint32 bit
    pattern), 4 bits a lane: lane l of word w is ``bits[:, 8*w + l] !=
    0`` at bit 4*l. Sums of at most NIBBLE_MAX_SHARDS such words never
    carry across lanes: the psum_scatter payload of the transposed packed
    mxm."""
    n, f = bits.shape
    w = max(-(-f // NIBBLE_LANES), 1)
    b = torch.zeros((n, w * NIBBLE_LANES), dtype=torch.int64,
                    device=bits.device)
    b[:, :f] = (bits != 0).to(torch.int64)
    weights = torch.ones(NIBBLE_LANES, dtype=torch.int64,
                         device=bits.device) << (4 * torch.arange(
                             NIBBLE_LANES, dtype=torch.int64,
                             device=bits.device))
    return _to_int32_words((b.reshape(n, w, NIBBLE_LANES) * weights)
                           .sum(dim=2))


def unpack_nibbles(xw: torch.Tensor, f: int) -> torch.Tensor:
    """(n, Wn) summed nibble words (int32 or int64) -> (n, f) bool "any
    shard contributed": each lane saturates with > 0, restoring the OR the
    sum stood in for."""
    n, w = xw.shape
    shifts = 4 * torch.arange(NIBBLE_LANES, dtype=xw.dtype, device=xw.device)
    lanes = (xw[:, :, None] >> shifts) & 0xF
    return lanes.reshape(n, w * NIBBLE_LANES)[:, :f] > 0
