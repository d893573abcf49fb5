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
// Design: one thread per (b, w, j) output.  L[b] and bw[b] are staged in shared
// memory; each thread walks its task's D parent slots and, per slot, the P
// parent classes, folding every valid slot into a running maximum with a
// strict '>' (the first maximal parent wins, as in the reference's argmax).
// The (W, D, P, P) candidate tensor never leaves registers.  The bound is the
// D * P^2 divides per output; a wide fan-in level with few tasks (the star's
// sink: W = 1, D = 4096) gives only P threads, each with a long serial loop.
// Splitting D across warps with a (max, first index) reduction is the next
// step for that shape.  Bit-exactness is pinned as in edge_relax.cu: a
// correctly rounded divide, explicit round-to-nearest adds and multiplies, the
// reference's operation order, and strict comparisons.  Never build this file
// with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#define CEFT_BIG 3.0e38f

__global__ void ceft_relax_kernel(const float* __restrict__ pv,      // (B, W, D, P)
                                  const float* __restrict__ pdata,   // (W, D)
                                  const float* __restrict__ validp,  // (W, D)
                                  const float* __restrict__ L,       // (B, P)
                                  const float* __restrict__ bw,      // (B, P, P)
                                  float* __restrict__ maxk,          // (B, W, P)
                                  int32_t* __restrict__ argk,        // (B, W, P)
                                  int32_t* __restrict__ argl,        // (B, W, P)
                                  int W, int D, int P) {
  extern __shared__ float smem[];
  float* sL = smem;       // (P,)
  float* sbw = smem + P;  // (P, P)
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < P; i += blockDim.x) sL[i] = L[(size_t)b * P + i];
  for (int i = threadIdx.x; i < P * P; i += blockDim.x)
    sbw[i] = bw[(size_t)b * P * P + i];
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)W * P) return;
  const int w = (int)(idx / P);
  const int j = (int)(idx % P);
  float run_max = -CEFT_BIG;
  int run_k = 0, run_l = 0;
  bool has = false;
  for (int d = 0; d < D; ++d) {
    const size_t td = (size_t)w * D + d;
    if (!(validp[td] > 0.0f)) continue;  // a padded slot contributes -BIG: never wins
    has = true;
    const float dat = pdata[td];
    const size_t row = ((size_t)b * W * D + td) * P;
    float best = 0.0f;
    int arg = 0;
    for (int l = 0; l < P; ++l) {
      const float off = (l == j) ? 0.0f : 1.0f;
      const float comm = __fmul_rn(__fadd_rn(sL[l], __fdiv_rn(dat, sbw[l * P + j])), off);
      const float c = __fadd_rn(pv[row + l], comm);
      if (l == 0 || c < best) {
        best = c;
        arg = l;
      }
    }
    if (best > run_max) {
      run_max = best;
      run_k = d;
      run_l = arg;
    }
  }
  const size_t out = ((size_t)b * W + w) * P + j;
  maxk[out] = run_max;
  argk[out] = has ? run_k : -1;
  argl[out] = has ? run_l : -1;
}

extern "C" int ceft_relax_f32(const void* pv, const void* pdata, const void* validp,
                              const void* L, const void* bw, void* maxk, void* argk,
                              void* argl, int B, int W, int D, int P, void* stream) {
  const int threads = 128;
  const long long n = (long long)W * P;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)B);
  const size_t smem = sizeof(float) * ((size_t)P + (size_t)P * P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ceft_relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ceft_relax_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pv, (const float*)pdata, (const float*)validp, (const float*)L,
      (const float*)bw, (float*)maxk, (int32_t*)argk, (int32_t*)argl, W, D, P);
  return (int)cudaGetLastError();
}
