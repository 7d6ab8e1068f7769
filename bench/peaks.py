"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates, 700 W), the denominators of every roofline share. Frozen here so
that no change to the program can move them."""

HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
FP32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
HBM_BYTES = 80e9                # device memory


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time the card could take for ``nbytes`` moved and
    ``flops`` float32 operations: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
