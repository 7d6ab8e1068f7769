#!/usr/bin/env python3
"""The SpGEMM dispatch on non-finite payloads, on one NVIDIA GPU: the
inputs of ``tests/test_torch_cuda.py::
test_bsr_spgemm_non_finite_payload_takes_the_tile_kernel`` (an inf or a
NaN in B's tile next to a stored 0 and an absent entry of A's under
plus_times; in A against B's absent entries under plus_first) through
``kernels.bsr_spgemm.spgemm_blocks`` of the port found under SRC (default
the checkout's ``src``; give another tree's ``src`` to check an older
dispatch), on tile stacks as every version takes them. Prints, for each
case, the entry-kernel launches and the NaN count of the result against
that of the plain version, and whether the two agree, NaN positions
included. Run from the repository root:

    python3 tools/spgemm_nonfinite.py [SRC]
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1
                else os.path.join(ROOT, "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("spgemm_nonfinite: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.core import semiring as S
    from repro_torch.core.bsr import BSR, spgemm_symbolic
    from repro_torch.kernels import bsr_spgemm as K
    b = 32
    for srname in ("plus_times", "plus_first"):
        for bad in (np.inf, np.nan):
            va = np.array([0.0, 2.0, 1.0, 3.0])
            vb = np.array([bad, 1.0, 2.0, 1.0, 1.0])
            if srname == "plus_first":
                va = np.array([0.0, bad, 1.0, 3.0])
                vb = np.array([1.0, 1.0, 2.0, 1.0, 1.0])
            A = BSR.from_coo(np.array([0, 0, 1, 2]), np.array([0, 1, 1, 3]),
                             va, (b, b), block=b, device="cuda")
            B = BSR.from_coo(np.array([0, 1, 1, 3, 5]),
                             np.array([4, 4, 6, 6, 7]), vb, (b, b), block=b,
                             device="cuda")
            plan = spgemm_symbolic(A, B)
            sr = S.get(srname)
            e0 = K.launches_entry
            got = K.spgemm_blocks(A.blocks, B.blocks, plan, sr)
            want = K.spgemm_blocks_plain(A.blocks, B.blocks, plan, sr)
            torch.cuda.synchronize()
            same = bool(((got == want)
                         | (torch.isnan(got) & torch.isnan(want))).all())
            print(json.dumps({
                "semiring": srname, "bad": str(bad),
                "entry_launches": K.launches_entry - e0,
                "nan": int(torch.isnan(got).sum()),
                "nan_plain": int(torch.isnan(want).sum()),
                "equal_to_plain": same,
                "picked": getattr(K, "picked", None)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
