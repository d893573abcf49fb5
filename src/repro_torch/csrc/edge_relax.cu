// Edge-centric CEFT relaxation for the CSR sweep's segment-layout levels.
//
//   minl[b, e, j] = min_l  pv[b, e, l] + (L[b, l] + pdata[e] / bw[b, l, j]) * off[l, j]
//   argl[b, e, j] = the first l that attains the minimum
//
// with off[l, j] = 0.0 on the diagonal and 1.0 elsewhere.  Replaces the Pallas
// kernel src/repro/kernels/ceft_relax.py:_edge_relax_kernel (entry
// edge_relax_pallas); b is the batch of cost planes / machines that share one
// set of edge tables.
//
// Design: one thread per (b, e, j) output.  A block stages L[b] and bw[b] in
// shared memory once (16.6 KB at P = 64); each thread walks the P parent
// classes, so the (E, P, P) candidate tensor of the plain version never leaves
// registers.  The outputs must be bit-equal to the plain PyTorch version and
// to the JAX reference, so every operation is pinned: a correctly rounded
// divide (__fdiv_rn), explicit round-to-nearest adds and multiplies (no FMA
// contraction), the reference's operation order, the multiply by off in
// place of a diagonal special case, and a strict '<' for the first-index
// argmin.  Never build this file with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void edge_relax_kernel(const float* __restrict__ pv,     // (B, E, P)
                                  const float* __restrict__ pdata,  // (E,)
                                  const float* __restrict__ L,      // (B, P)
                                  const float* __restrict__ bw,     // (B, P, P)
                                  float* __restrict__ minl,         // (B, E, P)
                                  int32_t* __restrict__ argl,       // (B, E, P)
                                  int E, int P) {
  extern __shared__ float smem[];
  float* sL = smem;       // (P,)
  float* sbw = smem + P;  // (P, P)
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < P; i += blockDim.x) sL[i] = L[(size_t)b * P + i];
  for (int i = threadIdx.x; i < P * P; i += blockDim.x)
    sbw[i] = bw[(size_t)b * P * P + i];
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)E * P) return;
  const int e = (int)(idx / P);
  const int j = (int)(idx % P);
  const size_t row = ((size_t)b * E + e) * P;
  const float d = pdata[e];
  float best = 0.0f;
  int arg = 0;
  for (int l = 0; l < P; ++l) {
    const float off = (l == j) ? 0.0f : 1.0f;
    const float comm = __fmul_rn(__fadd_rn(sL[l], __fdiv_rn(d, sbw[l * P + j])), off);
    const float c = __fadd_rn(pv[row + l], comm);
    if (l == 0 || c < best) {
      best = c;
      arg = l;
    }
  }
  minl[row + j] = best;
  argl[row + j] = arg;
}

extern "C" int edge_relax_f32(const void* pv, const void* pdata, const void* L,
                              const void* bw, void* minl, void* argl, int B, int E,
                              int P, void* stream) {
  const int threads = 256;
  const long long n = (long long)E * P;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)B);
  const size_t smem = sizeof(float) * ((size_t)P + (size_t)P * P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        edge_relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  edge_relax_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pv, (const float*)pdata, (const float*)L, (const float*)bw,
      (float*)minl, (int32_t*)argl, E, P);
  return (int)cudaGetLastError();
}
