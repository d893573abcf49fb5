// Stacked edge relaxation over a fused run's (R, E, P) edge tables.
//
//   minl[r, e, j] = min_l  pv[r, e, l] + (L[l] + pdata[r, e] / bw[l, j]) * off[l, j]
//   argl[r, e, j] = the first l that attains the minimum
//
// with off[l, j] = 0.0 on the diagonal and 1.0 elsewhere.  Replaces the Pallas
// kernel src/repro/kernels/ceft_relax.py:_edge_relax_superstep_kernel (entry
// edge_relax_superstep_pallas).  The edge data is per (r, e): each level of the
// run has its own edges; L and bw are one machine, shared by every level.
//
// Bound: issue slots.  The work is R * E * P^2 candidates of float32 scalar
// arithmetic (a divide, three adds and multiplies, a NaN-aware compare and two
// selects: about 12 instructions each in the unrolled loop), with no
// tensor-core form, and its bytes are a few per candidate.
// A correctly rounded __fdiv_rn costs a MUFU reciprocal, Newton steps, a range
// check and a branch per candidate, so the design takes the divide apart:
//
//   * Persistent blocks, a few per SM: each block stages L and (bw, RN(1/bw))
//     once, then walks tiles of (r, edge block) with a grid-stride loop.
//   * A thread keeps one child class j for SS_EPT edges of the tile, so each
//     (bw, 1/bw) pair it reads from shared memory serves SS_EPT candidates,
//     and the edges' chains of compares run side by side.
//   * The tile's pv rows are one contiguous range; they and the tile's edge
//     data are copied into shared memory with cp.async (16-byte copies where
//     aligned), double-buffered, so the next tile loads while this one is
//     relaxed.  A warp's threads share an edge and read its pv row by
//     broadcast.
//   * P is a template parameter for 8, 16, 32 and 64, so the class loop
//     unrolls (by kUnroll: a fully unrolled P = 64 loop outgrows the
//     instruction cache); one instance with a run-time P takes every other
//     width.
//   * Machines wider than SS_MAX_STAGED_P: P^2 bw floats alone fill most of
//     a block's shared memory, so a second kernel stages bw and L only,
//     reads each edge's pv row from global memory (every thread of the
//     block reads the same address: one broadcast load a class) and
//     divides with __fdiv_rn.  It takes P up to 240, where bw and L fill
//     the 227 KB a block may hold.
//   * The divide without a MUFU per candidate (Markstein): with
//     rb = RN(1/b), q0 = RN(d * rb), rem = fma(-q0, b, d) is exact and
//     fma(rem, rb, q0) is RN(d / b), as long as no operand or intermediate
//     leaves the normal range.  The staging checks every bw once and each
//     edge's d once against an exponent window that guarantees that (d may
//     also be +0, the padding edges' value); a thread whose edges or machine
//     fall outside it relaxes its tile with __fdiv_rn (the window and the
//     divide live in relax.cuh, shared with seg_level).  Either way the
//     quotient is the correctly rounded one, and the card tests hold it to
//     the plain version's CUDA division on about 2^26 adversarial pairs.
//
// Everything after the divide is pinned exactly as in edge_relax.cu, so every
// slice r is bit-equal to edge_relax on that level and to the plain PyTorch
// version: __fadd_rn and __fmul_rn (no FMA contraction outside the divide
// step), the reference's operation order, the multiply by off in place of a
// diagonal special case, and relax.cuh's NaN-aware first-index argmin.  Never
// build this file with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "relax.cuh"

#define SS_THREADS 256
#define SS_EPT 8  // edges a thread relaxes in a tile
// the widest machine whose two pv tiles and (bw, 1/bw) pairs fit in shared
// memory; wider ones take edge_relax_superstep_wide_kernel
#define SS_MAX_STAGED_P 160
constexpr int kUnroll = 4;  // unrolling of the class loop (a pragma takes no macro)

struct Tile {
  int r, e0, ne, sh;  // level, first edge, edges, floats before a 16-byte boundary
};

__device__ __forceinline__ Tile tile_of(long long t, int n_eb, int TE, int E, int P,
                                        const float* pv) {
  Tile tl;
  tl.r = (int)(t / n_eb);
  tl.e0 = (int)(t % n_eb) * TE;
  tl.ne = min(TE, E - tl.e0);
  const size_t g0 = ((size_t)tl.r * E + tl.e0) * P;
  tl.sh = (int)(((uintptr_t)pv / 4 + g0) & 3);
  return tl;
}

// copy tile tl's pv rows to dst[sh + i] (so global and shared addresses share
// their 16-byte alignment) and its edge data to dd
__device__ __forceinline__ void load_tile(const Tile& tl, const float* pv, const float* pdata,
                                          int E, int P, float* dst, float* dd) {
  const size_t g0 = ((size_t)tl.r * E + tl.e0) * P;
  const float* src = pv + g0;
  float* out = dst + tl.sh;
  const int n = tl.ne * P;
  const int head = min((4 - tl.sh) & 3, n);
  const int nc = (n - head) / 4;
  for (int i = threadIdx.x; i < head; i += SS_THREADS) cp_async4(out + i, src + i);
  for (int c = threadIdx.x; c < nc; c += SS_THREADS)
    cp_async16(out + head + 4 * c, src + head + 4 * c);
  for (int i = head + 4 * nc + threadIdx.x; i < n; i += SS_THREADS) cp_async4(out + i, src + i);
  const float* dsrc = pdata + (size_t)tl.r * E + tl.e0;
  for (int i = threadIdx.x; i < tl.ne; i += SS_THREADS) cp_async4(dd + i, dsrc + i);
}

// one thread: class j of edges el + S k (k < SS_EPT) of a staged tile.  The
// scan starts from (+inf, 0): the class-0 candidate then always takes it
// under takes_min (+inf itself ties and keeps class 0), exactly as taking
// class 0 unconditionally would, so the loop needs no l == 0 case.  The
// class loop is unrolled by kUnroll, not fully, so that the loop body
// stays in the instruction cache; the rare path outside the Markstein
// window is not unrolled at all.
template <int PT, bool FAST>
__device__ __forceinline__ void relax_edges(const float* tpv, const float* d, const float2* sbq,
                                            const float* sL, int P_rt, int j, int el, int ne,
                                            float* minl, int32_t* argl, size_t row0) {
  const int P = PT > 0 ? PT : P_rt;
  const int S = SS_THREADS / P;
  float best[SS_EPT];
  int arg[SS_EPT];
#pragma unroll
  for (int k = 0; k < SS_EPT; ++k) {
    best[k] = __int_as_float(0x7F800000);
    arg[k] = 0;
  }
  const float* prow = tpv + el * P;
  constexpr int unroll = FAST ? kUnroll : 1;
#pragma unroll unroll
  for (int l = 0; l < P; ++l) {
    const float2 q = sbq[l * P + j];  // (bw[l, j], RN(1 / bw[l, j]))
    const float Ll = sL[l];
    const float off = (l == j) ? 0.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < SS_EPT; ++k) {
      const float qt = FAST ? div_markstein(d[k], q.x, q.y) : __fdiv_rn(d[k], q.x);
      const float comm = __fmul_rn(__fadd_rn(Ll, qt), off);
      const float c = __fadd_rn(prow[k * S * P + l], comm);
      if (takes_min(c, best[k])) {
        best[k] = c;
        arg[k] = l;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < SS_EPT; ++k) {
    const int e = el + S * k;
    if (e < ne) {
      minl[row0 + (size_t)e * P + j] = best[k];
      argl[row0 + (size_t)e * P + j] = arg[k];
    }
  }
}

template <int PT>
__global__ void __launch_bounds__(SS_THREADS) edge_relax_superstep_kernel(
    const float* __restrict__ pv,     // (R, E, P)
    const float* __restrict__ pdata,  // (R, E)
    const float* __restrict__ L,      // (P,)
    const float* __restrict__ bw,     // (P, P)
    float* __restrict__ minl,         // (R, E, P)
    int32_t* __restrict__ argl,       // (R, E, P)
    int R, int E, int P_rt) {
  const int P = PT > 0 ? PT : P_rt;
  const int S = SS_THREADS / P;            // edge-lanes
  const int TE = S * SS_EPT;               // edges of a tile
  const int TF = ((TE * P + 3) & ~3) + 4;  // floats of a pv buffer
  extern __shared__ float4 smem4[];
  float* spv = (float*)smem4;              // (2, TF) pv rows
  float2* sbq = (float2*)(spv + 2 * TF);   // (P, P) bw and its reciprocal
  float* sL = (float*)(sbq + P * P);       // (P,)
  float* sd = sL + P;                      // (2, TE) edge data

  bool ok = true;
  for (int i = threadIdx.x; i < P * P; i += SS_THREADS) {
    const float b = bw[i];
    sbq[i] = make_float2(b, __frcp_rn(b));
    ok = ok && markstein_den(b);
  }
  for (int i = threadIdx.x; i < P; i += SS_THREADS) sL[i] = L[i];
  const bool bw_window = __syncthreads_and(ok);

  const int n_eb = (E + TE - 1) / TE;
  const long long n_tiles = (long long)R * n_eb;
  const int j = threadIdx.x % P, el = threadIdx.x / P;
  load_tile(tile_of(blockIdx.x, n_eb, TE, E, P, pv), pv, pdata, E, P, spv, sd);
  cp_async_commit();
  int buf = 0;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const long long next = t + gridDim.x;
    if (next < n_tiles)
      load_tile(tile_of(next, n_eb, TE, E, P, pv), pv, pdata, E, P, spv + (buf ^ 1) * TF,
                sd + (buf ^ 1) * TE);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t have landed
    __syncthreads();     // and everyone else's
    if (el < S) {
      const Tile tl = tile_of(t, n_eb, TE, E, P, pv);
      const float* td = sd + buf * TE;
      float d[SS_EPT];
      bool fast = bw_window;
#pragma unroll
      for (int k = 0; k < SS_EPT; ++k) {
        const int e = el + S * k;
        d[k] = e < tl.ne ? td[e] : 0.0f;
        fast = fast && markstein_num(d[k]);
      }
      const float* tpv = spv + buf * TF + tl.sh;
      const size_t row0 = ((size_t)tl.r * E + tl.e0) * P;
      if (fast)
        relax_edges<PT, true>(tpv, d, sbq, sL, P, j, el, tl.ne, minl, argl, row0);
      else
        relax_edges<PT, false>(tpv, d, sbq, sL, P, j, el, tl.ne, minl, argl, row0);
    }
    __syncthreads();  // buffer buf is free for the copy after next
  }
}

// P > SS_MAX_STAGED_P (at most SS_THREADS): thread j keeps class j for the
// SS_EPT edges of a tile, with bw and L in shared memory and the edges' pv
// rows and data read from global memory.  Same scan, same rounding, same
// NaN rule as relax_edges; the divide is always __fdiv_rn.
__global__ void __launch_bounds__(SS_THREADS) edge_relax_superstep_wide_kernel(
    const float* __restrict__ pv, const float* __restrict__ pdata,
    const float* __restrict__ L, const float* __restrict__ bw, float* __restrict__ minl,
    int32_t* __restrict__ argl, int R, int E, int P) {
  extern __shared__ float4 smem4[];
  float* sbw = (float*)smem4;  // (P, P)
  float* sL = sbw + P * P;     // (P,)
  for (int i = threadIdx.x; i < P * P; i += SS_THREADS) sbw[i] = bw[i];
  for (int i = threadIdx.x; i < P; i += SS_THREADS) sL[i] = L[i];
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= P) return;  // no barrier follows
  const int n_eb = (E + SS_EPT - 1) / SS_EPT;
  const long long n_tiles = (long long)R * n_eb;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int r = (int)(t / n_eb), e0 = (int)(t % n_eb) * SS_EPT;
    const int ne = min(SS_EPT, E - e0);
    const size_t row0 = ((size_t)r * E + e0) * P;
    float d[SS_EPT], best[SS_EPT];
    int arg[SS_EPT];
#pragma unroll
    for (int k = 0; k < SS_EPT; ++k) {  // edges past the tile repeat its last
      d[k] = pdata[(size_t)r * E + e0 + min(k, ne - 1)];
      best[k] = __int_as_float(0x7F800000);
      arg[k] = 0;
    }
    for (int l = 0; l < P; ++l) {
      const float b = sbw[l * P + j];
      const float Ll = sL[l];
      const float off = (l == j) ? 0.0f : 1.0f;
#pragma unroll
      for (int k = 0; k < SS_EPT; ++k) {
        const float comm = __fmul_rn(__fadd_rn(Ll, __fdiv_rn(d[k], b)), off);
        const float c = __fadd_rn(pv[row0 + (size_t)min(k, ne - 1) * P + l], comm);
        if (takes_min(c, best[k])) {
          best[k] = c;
          arg[k] = l;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SS_EPT; ++k) {
      if (k < ne) {
        minl[row0 + (size_t)k * P + j] = best[k];
        argl[row0 + (size_t)k * P + j] = arg[k];
      }
    }
  }
}

// a few resident blocks on each of the n_sm SMs, or one a tile if fewer
template <typename Kernel>
static int persistent_launch(Kernel kernel, size_t smem, long long n_tiles, int n_sm,
                             cudaStream_t stream, const void* pv, const void* pdata,
                             const void* L, const void* bw, void* minl, void* argl, int R,
                             int E, int P) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SS_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = n_tiles < (long long)per_sm * n_sm ? n_tiles : (long long)per_sm * n_sm;
  kernel<<<(unsigned)grid, SS_THREADS, smem, stream>>>(
      (const float*)pv, (const float*)pdata, (const float*)L, (const float*)bw, (float*)minl,
      (int32_t*)argl, R, E, P);
  return (int)cudaGetLastError();
}

template <int PT>
static int superstep_launch(const void* pv, const void* pdata, const void* L, const void* bw,
                            void* minl, void* argl, int R, int E, int P, int n_sm,
                            cudaStream_t stream) {
  const int S = SS_THREADS / P;
  const int TE = S * SS_EPT;
  const int TF = ((TE * P + 3) & ~3) + 4;
  const size_t smem = sizeof(float) * (2 * (size_t)TF + 2 * (size_t)P * P + P + 2 * (size_t)TE);
  return persistent_launch(edge_relax_superstep_kernel<PT>, smem,
                           (long long)R * ((E + TE - 1) / TE), n_sm, stream, pv, pdata, L, bw,
                           minl, argl, R, E, P);
}

// R, E, P >= 1 and P <= 240 (bw and L fill a block's shared memory above),
// checked by the caller
extern "C" int edge_relax_superstep_f32(const void* pv, const void* pdata, const void* L,
                                        const void* bw, void* minl, void* argl, int R,
                                        int E, int P, int n_sm, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 8:
      return superstep_launch<8>(pv, pdata, L, bw, minl, argl, R, E, P, n_sm, s);
    case 16:
      return superstep_launch<16>(pv, pdata, L, bw, minl, argl, R, E, P, n_sm, s);
    case 32:
      return superstep_launch<32>(pv, pdata, L, bw, minl, argl, R, E, P, n_sm, s);
    case 64:
      return superstep_launch<64>(pv, pdata, L, bw, minl, argl, R, E, P, n_sm, s);
    default:
      if (P > SS_MAX_STAGED_P)
        return persistent_launch(edge_relax_superstep_wide_kernel,
                                 sizeof(float) * ((size_t)P * P + P),
                                 (long long)R * ((E + SS_EPT - 1) / SS_EPT), n_sm, s, pv, pdata,
                                 L, bw, minl, argl, R, E, P);
      return superstep_launch<0>(pv, pdata, L, bw, minl, argl, R, E, P, n_sm, s);
  }
}
