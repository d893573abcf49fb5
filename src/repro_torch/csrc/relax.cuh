// Device functions shared by the relaxation kernels: the NaN-aware compares of
// a first-index argmin and first-index argmax, the relaxation of one (parent
// row, child class) cell written once with its pinned rounding (a correctly
// rounded divide, explicit round-to-nearest adds and multiplies, the
// reference's operation order, the multiply by off), the correctly rounded
// Markstein divide that edge_relax_superstep.cu and seg_level share, and the
// packed keys through which blocks combine a first-max.
//
// NaN follows the reference (jnp.min / jnp.argmin / jnp.argmax, torch.min /
// torch.max): a NaN candidate wins the minimum or the maximum, the first NaN
// in scan order is the index, and once a NaN has won it is kept.  Ties among
// values that are not NaN keep the first index.
#pragma once
#include <stdint.h>

// c replaces best in a first-index argmin scan: smaller, or the first NaN
__device__ __forceinline__ bool takes_min(float c, float best) {
  return !(c >= best) && best == best;
}

// c replaces best in a first-index argmax scan: larger, or the first NaN
__device__ __forceinline__ bool takes_max(float c, float best) {
  return c > best || (c != c && best == best);
}

// (v, i) comes before (best, best_i) in a first-max over unordered pieces:
// a larger value (NaN above all), or the same value (NaN equal to NaN) at a
// smaller index
__device__ __forceinline__ bool first_max_before(float v, int i, float best, int best_i) {
  const bool same = v == best || (v != v && best != best);
  return takes_max(v, best) || (same && i < best_i);
}

// The divide without a MUFU per candidate (Markstein): with rb = RN(1/b),
// q0 = RN(d * rb), rem = fma(-q0, b, d) is exact and fma(rem, rb, q0) is
// RN(d / b), as long as no operand or intermediate leaves the normal range.
// Callers check every b once and each d once against the exponent window
// below (d may also be +0) and use __fdiv_rn outside it.  The window's
// biased exponents: d and bw within 2^+-62 keep the quotient, the remainder
// and RN(1/bw) normal.
#define SS_EXP_LO (127 - 62)
#define SS_EXP_HI (127 + 62)

__device__ __forceinline__ bool markstein_num(float d) {
  const uint32_t u = __float_as_uint(d);
  const uint32_t e = (u >> 23) & 0xFFu;
  return u == 0u || (e >= SS_EXP_LO && e <= SS_EXP_HI);
}

__device__ __forceinline__ bool markstein_den(float b) {
  const uint32_t e = __float_as_uint(b) >> 23;  // the sign bit must be clear
  return e >= SS_EXP_LO && e <= SS_EXP_HI;
}

// RN(d / b) from rb = RN(1 / b), for d and b inside the window
__device__ __forceinline__ float div_markstein(float d, float b, float rb) {
  const float q0 = __fmul_rn(d, rb);
  const float rem = __fmaf_rn(-q0, b, d);
  return __fmaf_rn(rem, rb, q0);
}

// the working type's rounding of a float32 result: none for float32 data
struct NoRound {
  static __device__ __forceinline__ float round(float x) { return x; }
};

// min over l of pv_row[l] + comm(l, j | d), and the first l attaining it.
// Each operation is computed in float32 and rounded by R to the working type
// before the next one (R = NoRound: the float32 arithmetic itself).
template <typename R = NoRound>
__device__ __forceinline__ void relax_cell(const float* pv_row, float d, const float* sL,
                                           const float* sbw, int P, int j, float& best,
                                           int& arg) {
  best = 0.0f;
  arg = 0;
  for (int l = 0; l < P; ++l) {
    const float off = (l == j) ? 0.0f : 1.0f;
    const float q = R::round(__fdiv_rn(d, sbw[l * P + j]));
    const float comm = R::round(__fmul_rn(R::round(__fadd_rn(sL[l], q)), off));
    const float c = R::round(__fadd_rn(pv_row[l], comm));
    if (l == 0 || takes_min(c, best)) {
      best = c;
      arg = l;
    }
  }
}

// order-preserving map of a float's bits onto unsigned integers; every NaN
// maps to the bits of one canonical NaN, which sit above +inf
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t u = v != v ? 0x7FC00000u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// (value, index, class) as one key: a larger value (NaN above all) wins, then
// a smaller index (index < 2^24 and P <= 256, checked by the callers); 0 is
// below every key
__device__ __forceinline__ unsigned long long pack_key(float v, int e, int l) {
  const uint32_t lo = ((0xFFFFFFu - (uint32_t)e) << 8) | (uint32_t)l;
  return ((unsigned long long)ordered_bits(v) << 32) | lo;
}

__device__ __forceinline__ int32_t key_index(uint32_t lo) {
  return (int32_t)(0xFFFFFFu - (lo >> 8));
}

__device__ __forceinline__ int32_t key_class(uint32_t lo) { return (int32_t)(lo & 0xFFu); }
