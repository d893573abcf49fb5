// Tropical (min-plus) matrix product.
//
//   C[i, j] = min(BIG, min_k A[i, k] + B[k, j]),   BIG = 3.0e38
//
// Replaces the Pallas kernel src/repro/kernels/minplus.py:_minplus_kernel (entry
// minplus_pallas), whose accumulator also starts at BIG.  A and B are float32
// or bf16; C has their type.
//
// Design: a classic tiled product with (min, +) in place of (+, *).  A block of
// 256 threads owns a 128 x 128 tile of C; each thread keeps an 8 x 8 micro-tile
// of running minima in registers (rows ty + 16 a, columns tx + 16 b, so the
// shared-memory reads of a warp broadcast on A and hit 16 distinct banks on B,
// and the stores of C are coalesced).  K is walked in slices of 8: the block
// stages an A slice (transposed, 8 x 128) and a B slice (8 x 128) in shared
// memory, converted to float32.  The ragged edge is masked in the kernel: rows
// and columns past M or N are loaded as 0 and never stored, and the last K
// slice runs only its real depth, so no padded copy of A or B is made.
// Sums and minima are taken in float32 and C is rounded to its type once at
// the end; for bf16 inputs the float32 sum of two bf16 values rounds to the
// same bf16 as a bf16 add would, and rounding is monotone, so
// round(min(sums)) == min(round(sums)).  The minimum is exact, so the result
// is bit-equal to the plain version whatever the order of K.  This is not a
// matrix product: the tensor cores have no (min, +) mode, so the bound is the
// float32 pipe at 2 M K N operations.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MP_BIG 3.0e38f
#define MP_BM 128
#define MP_BN 128
#define MP_BK 8
#define MP_TM 8
#define MP_TN 8
#define MP_THREADS 256

__device__ __forceinline__ float mp_load(const float* p) { return *p; }
__device__ __forceinline__ float mp_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void mp_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void mp_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(MP_THREADS)
minplus_kernel(const T* __restrict__ A,  // (M, K)
               const T* __restrict__ B,  // (K, N)
               T* __restrict__ C,        // (M, N)
               int M, int K, int N) {
  __shared__ float As[MP_BK][MP_BM + 4];  // A slice, transposed: As[k][i]
  __shared__ float Bs[MP_BK][MP_BN];      // B slice: Bs[k][j]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * MP_BM, n0 = blockIdx.x * MP_BN;

  float acc[MP_TM][MP_TN];
#pragma unroll
  for (int a = 0; a < MP_TM; ++a)
#pragma unroll
    for (int b = 0; b < MP_TN; ++b) acc[a][b] = MP_BIG;

  for (int k0 = 0; k0 < K; k0 += MP_BK) {
    // stage the slices: 1024 elements each, 4 per thread
#pragma unroll
    for (int q = 0; q < (MP_BM * MP_BK) / MP_THREADS; ++q) {
      const int el = tid + q * MP_THREADS;
      const int i = el / MP_BK, k = el % MP_BK;
      const int gi = m0 + i, gk = k0 + k;
      As[k][i] = (gi < M && gk < K) ? mp_load(A + (size_t)gi * K + gk) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < (MP_BN * MP_BK) / MP_THREADS; ++q) {
      const int el = tid + q * MP_THREADS;
      const int k = el / MP_BN, j = el % MP_BN;
      const int gk = k0 + k, gj = n0 + j;
      Bs[k][j] = (gk < K && gj < N) ? mp_load(B + (size_t)gk * N + gj) : 0.0f;
    }
    __syncthreads();
    const int depth = min(MP_BK, K - k0);  // the same for the whole block
    for (int k = 0; k < depth; ++k) {
      float av[MP_TM], bv[MP_TN];
#pragma unroll
      for (int a = 0; a < MP_TM; ++a) av[a] = As[k][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < MP_TN; ++b) bv[b] = Bs[k][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < MP_TM; ++a)
#pragma unroll
        for (int b = 0; b < MP_TN; ++b)
          acc[a][b] = fminf(acc[a][b], __fadd_rn(av[a], bv[b]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < MP_TM; ++a) {
    const int gi = m0 + ty + 16 * a;
    if (gi >= M) continue;
#pragma unroll
    for (int b = 0; b < MP_TN; ++b) {
      const int gj = n0 + tx + 16 * b;
      if (gj < N) mp_store(C + (size_t)gi * N + gj, acc[a][b]);
    }
  }
}

template <typename T>
static int minplus_launch(const void* A, const void* B, void* C, int M, int K, int N,
                          void* stream) {
  const dim3 grid((unsigned)((N + MP_BN - 1) / MP_BN), (unsigned)((M + MP_BM - 1) / MP_BM));
  minplus_kernel<T><<<grid, MP_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)B, (T*)C, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" int minplus_f32(const void* A, const void* B, void* C, int M, int K, int N,
                           void* stream) {
  return minplus_launch<float>(A, B, C, M, K, N, stream);
}

extern "C" int minplus_bf16(const void* A, const void* B, void* C, int M, int K, int N,
                            void* stream) {
  return minplus_launch<__nv_bfloat16>(A, B, C, M, K, N, stream);
}
