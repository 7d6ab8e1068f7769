// Element-wise ops and modes shared by the BSR element-wise kernels
// (bsr_ewise.cu on whole tiles, bsr_ewise_entry.cu on stored entries).
//
// The op is a code and one fp32 scalar (repro_torch.core.semiring.ewise;
// the codes are its _EWISE table's). Arithmetic uses the _rn intrinsics so
// that no multiply and add are fused: every result is the one fp32 rounding
// torch computes. min / max are fminf / fmaxf, which differ from
// torch.minimum / maximum only on NaN.
//
// Modes, as _tile_fn defines them; absent == 0:
//   0 union      both stored ? op(a, b) : a + b
//   1 intersect  both stored ? op(a, b) : 0
//   2 apply      a stored ? op(a) : 0
//   3 select     a stored and op(a) ? a : 0
//   4 mask       b stored ? a : 0
//   5 mask_c     b absent ? a : 0
#pragma once

__device__ __forceinline__ float eval_op(int op, float a, float b, float s) {
  switch (op) {
    case 0: return __fadd_rn(a, b);          // plus
    case 1: return __fmul_rn(a, b);          // times
    case 2: return fminf(a, b);              // min
    case 3: return fmaxf(a, b);              // max
    case 4: return a;                        // first
    case 5: return b;                        // second
    case 6: return 1.0f;                     // pair
    case 7: return __fsub_rn(a, b);          // minus
    case 8: return a;                        // identity
    case 9: return -a;                       // ainv
    case 10: return fabsf(a);                // abs
    case 11: return 1.0f;                    // one
    case 12: return __fmul_rn(a, s);         // mul(s)
    case 13: return __fadd_rn(a, s);         // add(s)
    case 14: return a >= s ? 1.0f : 0.0f;    // ge(s)
    case 15: return a > s ? 1.0f : 0.0f;     // gt(s)
    case 16: return a <= s ? 1.0f : 0.0f;    // le(s)
    case 17: return a < s ? 1.0f : 0.0f;     // lt(s)
    case 18: return a == s ? 1.0f : 0.0f;    // eq(s)
    default: return a != s ? 1.0f : 0.0f;    // ne(s)
  }
}

template <int MODE>
__device__ __forceinline__ float tile_fn(float a, float b, int op, float s) {
  if (MODE == 0) return (a != 0.0f && b != 0.0f) ? eval_op(op, a, b, s)
                                                 : __fadd_rn(a, b);
  if (MODE == 1) return (a != 0.0f && b != 0.0f) ? eval_op(op, a, b, s)
                                                 : 0.0f;
  if (MODE == 2) return a != 0.0f ? eval_op(op, a, 0.0f, s) : 0.0f;
  if (MODE == 3) return (a != 0.0f && eval_op(op, a, 0.0f, s) != 0.0f)
                            ? a : 0.0f;
  if (MODE == 4) return b != 0.0f ? a : 0.0f;
  return b == 0.0f ? a : 0.0f;
}

