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
// Design: one launch per call, grid (ceil(E * P / 256), R), one thread per
// (r, e, j) output.  A block stages the shared L and bw in shared memory once
// (16.6 KB at P = 64); each thread walks the P parent classes in registers, so
// the (R, E, P, P) candidate tensor never reaches device memory.  The work is
// bound by its R * E * P^2 correctly rounded divides (float32, no tensor cores:
// a min/argmin scan).  The arithmetic is pinned exactly as in edge_relax.cu,
// so every slice r is bit-equal to edge_relax on that level and to the plain
// PyTorch version: __fdiv_rn, __fadd_rn and __fmul_rn (no FMA contraction),
// the reference's operation order, the multiply by off in place of a diagonal
// special case, and a strict '<' for the first-index argmin.  Never build this
// file with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void edge_relax_superstep_kernel(const float* __restrict__ pv,     // (R, E, P)
                                            const float* __restrict__ pdata,  // (R, E)
                                            const float* __restrict__ L,      // (P,)
                                            const float* __restrict__ bw,     // (P, P)
                                            float* __restrict__ minl,         // (R, E, P)
                                            int32_t* __restrict__ argl,       // (R, E, P)
                                            int E, int P) {
  extern __shared__ float smem[];
  float* sL = smem;       // (P,)
  float* sbw = smem + P;  // (P, P)
  for (int i = threadIdx.x; i < P; i += blockDim.x) sL[i] = L[i];
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) sbw[i] = bw[i];
  __syncthreads();

  const int r = blockIdx.y;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)E * P) return;
  const int e = (int)(idx / P);
  const int j = (int)(idx % P);
  const size_t re = (size_t)r * E + e;
  const size_t row = re * P;
  const float d = pdata[re];
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

extern "C" int edge_relax_superstep_f32(const void* pv, const void* pdata, const void* L,
                                        const void* bw, void* minl, void* argl, int R,
                                        int E, int P, void* stream) {
  const int threads = 256;
  const long long n = (long long)E * P;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)R);
  const size_t smem = sizeof(float) * ((size_t)P + (size_t)P * P);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(edge_relax_superstep_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  edge_relax_superstep_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pv, (const float*)pdata, (const float*)L, (const float*)bw,
      (float*)minl, (int32_t*)argl, E, P);
  return (int)cudaGetLastError();
}
