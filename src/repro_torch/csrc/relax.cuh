// Device functions shared by the relaxation kernels: the NaN-aware compares of
// a first-index argmin and first-index argmax, the relaxation of one (parent
// row, child class) cell written once with its pinned rounding (a correctly
// rounded divide, explicit round-to-nearest adds and multiplies, the
// reference's operation order, the multiply by off), the correctly rounded
// Markstein divide that edge_relax_superstep.cu and edge_relax.cu share, the
// class loop split across lanes that edge_relax.cu's two kernels share (the
// staged j-chunk of the machine, the lanes' scan, and the combine that leaves
// each lane its own edges), and the packed keys through which blocks combine
// a first-max.
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

// The class loop split across lanes.  G lanes (a power of two) share one
// (edge, j) cell; lane g scans the contiguous classes l0 = g * lpt .. l0 +
// lpt - 1 (lpt = ceil(P / G)), and the lanes combine their ranges in l order.
// A block stages a j-chunk of the machine once as float4 entries (bw[l, j],
// RN(1 / bw[l, j]), L[l], off[l, j]): class j's entries start at sq + c * S
// (c = j - j0) and lane g's class l0 + i sits at index i * G + g, so that the
// lanes of a quarter-warp read distinct 16-byte banks.

// staged entries between two classes j: at least G * lpt, so that the
// lanes of one quarter-warp reading entries (8 / G classes j, G lanes each)
// land on distinct 16-byte banks, and for G >= 8 (one j a quarter-warp) one
// more, so that lanes staging one class l for consecutive j do too
__host__ __device__ __forceinline__ int lane_stride(int G, int lpt) {
  return G >= 8 ? G * lpt + 1 : G * lpt + ((G - G * lpt) & 7);
}

// Stage classes j0 .. j0 + nj - 1 of plane bwb = bw + b P^2 (j-chunks of JC =
// 2^jcs, lps = log2(lpt) for PT > 0) into sq, NSTAGE entries a thread with
// every load issued before any reciprocal; returns whether each bw this
// thread staged lies inside the Markstein window.
template <int PT, int NSTAGE>
__device__ __forceinline__ bool stage_pairs(const float* bwb, const float* Lb, int P, int j0,
                                            int nj, int JC, int jcs, int G, int lpt, int lps,
                                            int S, float4* sq) {
  bool ok = true;
  for (int i0 = threadIdx.x; i0 < P * JC; i0 += NSTAGE * blockDim.x) {
    float bv[NSTAGE], lv[NSTAGE];
#pragma unroll
    for (int u = 0; u < NSTAGE; ++u) {  // every load first
      const int i = i0 + u * blockDim.x, c = i & (JC - 1), l = i >> jcs;
      const bool in = i < P * JC && c < nj;
      bv[u] = in ? bwb[l * P + c] : 1.0f;
      lv[u] = in ? Lb[l] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < NSTAGE; ++u) {
      const int i = i0 + u * blockDim.x, c = i & (JC - 1), l = i >> jcs;
      if (i < P * JC && c < nj) {
        ok = ok && markstein_den(bv[u]);
        const int li = PT > 0 ? (l & (lpt - 1)) * G + (l >> lps) : (l % lpt) * G + l / lpt;
        sq[c * S + li] = make_float4(bv[u], __frcp_rn(bv[u]), lv[u], l == j0 + c ? 0.0f : 1.0f);
      }
    }
  }
  return ok;
}

// one lane's scan of classes l0 .. l0 + nl - 1 for EPT edges and one class
// j, two classes at a time: edge k's row is pv + k * P from class l0 on (rows
// past the tile hold garbage, and are not written), its data d[k]; sq points
// at the lane's first staged entry (class l0 + i at sq[i * G]).  It starts
// from (+inf, l0): a candidate equal to +inf then keeps l0, as the serial
// scan keeps its first.  FAST: every d and bw inside the Markstein window.
template <int PT, bool FAST, int EPT>
__device__ __forceinline__ void relax_lanes(const float* pv, int P, const float (&d)[EPT],
                                            const float4* sq, int G, int l0, int nl,
                                            float (&best)[EPT], int (&arg)[EPT]) {
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    best[k] = __int_as_float(0x7F800000);
    arg[k] = l0;
  }
#pragma unroll 4
  for (int i0 = 0; i0 < nl; i0 += 2) {
    float2 x[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (PT > 0) {  // nl is even and the row 8-byte aligned
        x[k] = *(const float2*)(pv + k * P + i0);
      } else {
        x[k].x = pv[k * P + i0];
        x[k].y = i0 + 1 < nl ? pv[k * P + i0 + 1] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (PT == 0 && i0 + u >= nl) break;
      const float4 q = sq[(i0 + u) * G];  // (bw[l, j], RN(1 / bw[l, j]), L[l], off[l, j])
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        // pv + (L + q) * off in one rounding: the product by off (0 or 1) is
        // exact, so the FMA rounds exactly as the multiply and then the add do
        const float qt = FAST ? div_markstein(d[k], q.x, q.y) : __fdiv_rn(d[k], q.x);
        const float c = __fmaf_rn(__fadd_rn(q.z, qt), q.w, u ? x[k].y : x[k].x);
        if (takes_min(c, best[k])) {
          best[k] = c;
          arg[k] = l0 + i0 + u;
        }
      }
    }
  }
}

// Combine the G lanes' ranges (G <= EPT, both powers of two; lane g = this
// lane's index among them) in l order, as a reduce-scatter: in the round at
// distance o the pair g, g ^ o holds adjacent ranges, the lane of the lower
// range keeps the lower half of its edges and the other the upper half, each
// sends the partner the half the partner keeps, and the upper range replaces
// the lower where takes_min says so (smaller, or the first NaN).  Lane g ends
// with edges k0 .. k0 + EPT / G - 1 in best[0 ..] and returns k0; a round
// moves half the edges of the last, so the lanes shuffle EPT - EPT / G values
// of each kind, not EPT log2(G).
template <int EPT>
__device__ __forceinline__ int scatter_lanes(float (&best)[EPT], int (&arg)[EPT], int G, int g) {
  int k0 = 0;
#pragma unroll
  for (int r = 0; (EPT >> (r + 1)) > 0; ++r) {
    const int o = 1 << r, h = EPT >> (r + 1);
    if (o >= G) break;
    const bool up = (g & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep_b = up ? best[i + h] : best[i], send_b = up ? best[i] : best[i + h];
      const int keep_a = up ? arg[i + h] : arg[i], send_a = up ? arg[i] : arg[i + h];
      const float got_b = __shfl_xor_sync(0xFFFFFFFFu, send_b, o);
      const int got_a = __shfl_xor_sync(0xFFFFFFFFu, send_a, o);
      const float lo_b = up ? got_b : keep_b, hi_b = up ? keep_b : got_b;
      const int lo_a = up ? got_a : keep_a, hi_a = up ? keep_a : got_a;
      const bool t = takes_min(hi_b, lo_b);
      best[i] = t ? hi_b : lo_b;
      arg[i] = t ? hi_a : lo_a;
    }
    if (up) k0 += h;
  }
  return k0;
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
