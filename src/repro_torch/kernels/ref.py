"""The densify oracle for the BSR product: port of ``repro.kernels.ref``.

``bsr_mxm_ref`` densifies the handle and runs ``semiring.dense_mxm``, an
implementation independent of both of ``kernels.bsr_mxm``'s kernels and of
their plain versions (``core.ops.bsr_mxm_plain``,
``kernels.bsr_mxm.bsr_mxm_entry_plain``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import semiring as S
from repro_torch.core.bsr import BSR


def bsr_mxm_ref(A: BSR, X: torch.Tensor, sr: S.Semiring, *,
                mask: Optional[torch.Tensor] = None,
                complement: bool = False) -> torch.Tensor:
    y = S.dense_mxm(S.structural_dense(A.to_dense(), sr), X, sr)
    if mask is not None:
        keep = (mask == 0) if complement else (mask != 0)
        y = torch.where(keep, y, torch.full_like(y, sr.identity))
    return y
