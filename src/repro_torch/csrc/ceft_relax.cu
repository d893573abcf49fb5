// Dense CEFT level relaxation for the padded sweep and the dense-layout runs.
//
//   cand[d, l]      = pv[b, w, d, l] + (L[b, l] + pdata[w, d] / bw[b, l, j]) * off[l, j]
//   maxk[b, w, j]   = max over parent slots d with validp[w, d] > 0 of min_l cand[d, l]
//   argk[b, w, j]   = the first slot d that attains the maximum
//   argl[b, w, j]   = that slot's first argmin class l
//
// Rows with no valid parent get maxk = -BIG and argk = argl = -1.  Replaces the
// Pallas kernel src/repro/kernels/ceft_relax.py:_relax_kernel (entry
// ceft_relax_pallas); b is the batch of cost planes / machines sharing one set
// of level tables.
//
// Bound: the valid slots' D * P^2 correctly rounded divides per (b, w).  The
// shapes range from many narrow tasks (the router's DAGs, P = 8) to one task
// with a wide fan-in (the star's sink: W = 1, D = 4096, P = 64), so the fan-in
// D is split across threads and blocks:
//
//   * a block takes one (b, w) and a chunk of D; its threads are P j-lanes
//     times S = 256 / P slot-lanes (4 at P = 64, 32 at P = 8);
//   * the block copies its pv rows (contiguous in memory) into a shared tile
//     with coalesced loads, L and bw are staged once;
//   * each thread folds its slots in ascending order from (-BIG, 0, 0) with
//     takes_max (relax.cuh), as the sequential scan does: a larger value or
//     the first NaN wins, and a NaN once taken is kept;
//   * the slot-lanes are combined in shared memory lexicographically (larger
//     value with NaN above all, then smaller d), which equals the first-max
//     sequential scan, including a tie with the initial -BIG;
//   * when D spans several blocks, each block with a valid slot posts a 64-bit
//     atomicMax of a packed key (order-preserving value bits, every NaN
//     mapped to one NaN above +inf, then the complement of d, then l), and
//     the last block of the (b, w) row to finish
//     decodes the key and resets it; a key left at 0 means no valid parent.
//     The scratch is zero between launches, so it needs no memset, and the
//     result does not depend on block order.
//
// The host picks the number of chunks from (B, W, D, P); a level whose fan-in
// fits one block takes one launch with no atomics.  Bit-exactness is pinned in
// relax.cuh's relax_cell and compares (shared with edge_relax.cu).  Never build this file with --use_fast_math.
//
// Two instances: float32 (ceft_relax_f32) and bf16 (ceft_relax_bf16; argk and
// argl stay int32).  The bf16 instance matches the plain version's bf16
// arithmetic, which rounds to bf16 after each operation: every operation is
// computed in float32 and rounded to bf16 (round to nearest even) before the
// next.  For +, -, * and / of two bf16 operands that double rounding equals
// one rounding of the exact result (24 >= 2 * 8 + 2), so the kernel is
// bit-equal to the plain version.  bf16 widens to float32 exactly, so shared
// memory, the compares and the packed keys stay float32 and the maximum is
// narrowed exactly on the way out; -BIG is 3.0e38 rounded to bf16, the value
// torch.tensor(-3.0e38, dtype=torch.bfloat16) holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relax.cuh"

#define CEFT_BIG 3.0e38f
#define CEFT_THREADS 256
#define TILE_ROUNDS 4  // a shared pv tile holds TILE_ROUNDS slots per slot-lane

// loads and stores of the data type, and the rounding of each operation
template <typename T>
struct Elem;
template <>
struct Elem<float> : NoRound {
  static __device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
  static __device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);  // exact: v is a bf16 value (or a NaN)
  }
};

template <typename T>
__global__ void __launch_bounds__(CEFT_THREADS) ceft_relax_kernel(
    const T* __restrict__ pv,          // (B, W, D, P)
    const T* __restrict__ pdata,       // (W, D)
    const T* __restrict__ validp,      // (W, D)
    const T* __restrict__ L,           // (B, P)
    const T* __restrict__ bw,          // (B, P, P)
    T* __restrict__ maxk,              // (B, W, P)
    int32_t* __restrict__ argk,        // (B, W, P)
    int32_t* __restrict__ argl,        // (B, W, P)
    unsigned long long* __restrict__ keys,  // (B, W, P) zero on entry and on exit
    int* __restrict__ counts,               // (B, W) zero on entry and on exit
    int W, int D, int P, int chunk) {
  const int S = blockDim.x / P;   // slot-lanes
  const int TS = TILE_ROUNDS * S;  // slots per shared tile
  extern __shared__ float smem[];
  float* sL = smem;                    // (P,)
  float* sbw = sL + P;                 // (P, P)
  float* spv = sbw + P * P;            // (TS, P)
  float* sdat = spv + TS * P;          // (TS,)
  float* sval = sdat + TS;             // (TS,)
  float* rv = sval + TS;               // (S, P) each slot-lane's fold
  int* rd = (int*)(rv + S * P);        // (S, P)
  int* rl = rd + S * P;                // (S, P)
  __shared__ int is_last;

  using E = Elem<T>;
  const float neg_big = E::round(-CEFT_BIG);
  const int b = blockIdx.z, w = blockIdx.y;
  const int j = threadIdx.x % P, sl = threadIdx.x / P;
  const int d0 = blockIdx.x * chunk, d1 = min(D, d0 + chunk);
  for (int i = threadIdx.x; i < P; i += blockDim.x) sL[i] = E::load(L, (size_t)b * P + i);
  for (int i = threadIdx.x; i < P * P; i += blockDim.x)
    sbw[i] = E::load(bw, (size_t)b * P * P + i);

  float run = neg_big;
  int run_d = 0, run_l = 0;
  bool any = false;
  const size_t task = (size_t)w * D;
  const T* pv_row = pv + ((size_t)b * W * D + task) * P;
  for (int t0 = d0; t0 < d1; t0 += TS) {
    const int n = min(TS, d1 - t0);
    __syncthreads();  // the previous tile is consumed (and L, bw are staged)
    for (int i = threadIdx.x; i < n * P; i += blockDim.x)
      spv[i] = E::load(pv_row, (size_t)t0 * P + i);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      sdat[i] = E::load(pdata, task + t0 + i);
      sval[i] = E::load(validp, task + t0 + i);
    }
    __syncthreads();
    for (int i = sl; i < n; i += S) {
      if (!(sval[i] > 0.0f)) continue;  // a padded slot contributes -BIG: never wins
      any = true;
      float best;
      int arg;
      relax_cell<E>(spv + i * P, sdat[i], sL, sbw, P, j, best, arg);
      if (takes_max(best, run)) {
        run = best;
        run_d = t0 + i;
        run_l = arg;
      }
    }
  }
  const bool block_any = __syncthreads_or(any);
  rv[sl * P + j] = run;
  rd[sl * P + j] = run_d;
  rl[sl * P + j] = run_l;
  __syncthreads();
  const size_t out = ((size_t)b * W + w) * P + j;
  if (sl == 0) {
    for (int s = 1; s < S; ++s) {
      const float v = rv[s * P + j];
      const int d = rd[s * P + j];
      if (first_max_before(v, d, run, run_d)) {
        run = v;
        run_d = d;
        run_l = rl[s * P + j];
      }
    }
    if (gridDim.x == 1) {
      E::store(maxk, out, run);
      argk[out] = block_any ? run_d : -1;
      argl[out] = block_any ? run_l : -1;
      return;
    }
    if (block_any) atomicMax(&keys[out], pack_key(run, run_d, run_l));
    __threadfence();
  }
  if (gridDim.x == 1) return;

  // the last block of row (b, w) to finish decodes the key
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counts[(size_t)b * W + w], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last || sl != 0) return;
  __threadfence();
  const unsigned long long key = atomicExch(&keys[out], 0ull);
  const uint32_t lo = (uint32_t)key;
  E::store(maxk, out, key ? from_ordered_bits((uint32_t)(key >> 32)) : neg_big);
  argk[out] = key ? key_index(lo) : -1;
  argl[out] = key ? key_class(lo) : -1;
  if (j == 0) counts[(size_t)b * W + w] = 0;
}

// chunk: parent slots a block takes; n_chunks = ceil(D / chunk) >= 1.  keys
// holds B * W * P and counts B * W zeros when n_chunks > 1, and are left zero.
template <typename T>
static int launch(const void* pv, const void* pdata, const void* validp, const void* L,
                  const void* bw, void* maxk, void* argk, void* argl, void* keys,
                  void* counts, int B, int W, int D, int P, int chunk, int n_chunks,
                  void* stream) {
  const int S = P >= CEFT_THREADS ? 1 : CEFT_THREADS / P;
  const int threads = S * P;
  const int TS = TILE_ROUNDS * S;
  const size_t smem = sizeof(float) * ((size_t)P + (size_t)P * P + (size_t)TS * P +
                                       2 * (size_t)TS + 3 * (size_t)S * P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ceft_relax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)n_chunks, (unsigned)W, (unsigned)B);
  ceft_relax_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)pv, (const T*)pdata, (const T*)validp, (const T*)L, (const T*)bw, (T*)maxk,
      (int32_t*)argk, (int32_t*)argl, (unsigned long long*)keys, (int*)counts, W, D, P,
      chunk);
  return (int)cudaGetLastError();
}

extern "C" int ceft_relax_f32(const void* pv, const void* pdata, const void* validp,
                              const void* L, const void* bw, void* maxk, void* argk,
                              void* argl, void* keys, void* counts, int B, int W, int D,
                              int P, int chunk, int n_chunks, void* stream) {
  return launch<float>(pv, pdata, validp, L, bw, maxk, argk, argl, keys, counts, B, W, D, P,
                       chunk, n_chunks, stream);
}

extern "C" int ceft_relax_bf16(const void* pv, const void* pdata, const void* validp,
                               const void* L, const void* bw, void* maxk, void* argk,
                               void* argl, void* keys, void* counts, int B, int W, int D,
                               int P, int chunk, int n_chunks, void* stream) {
  return launch<__nv_bfloat16>(pv, pdata, validp, L, bw, maxk, argk, argl, keys, counts, B,
                               W, D, P, chunk, n_chunks, stream);
}
