"""Rounding to a lower precision than a configuration states: the
benchmark's control computes its reference this way and has to come out
not correct."""
from __future__ import annotations

import numpy as np


def exact(x):
    """No rounding: the reference itself."""
    return x


def bfloat16(x):
    """Each value rounded (to nearest, ties to even) to bfloat16's 8-bit
    significand, returned as float32: what holding it in bfloat16 keeps."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    b = a.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).reshape(a.shape)
