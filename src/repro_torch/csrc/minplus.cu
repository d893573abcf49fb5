// Tropical (min-plus) matrix product.
//
//   C[i, j] = min(BIG, min_k A[i, k] + B[k, j]),   BIG = 3.0e38
//
// Replaces the Pallas kernel src/repro/kernels/minplus.py:_minplus_kernel (entry
// minplus_pallas), whose accumulator also starts at BIG.  A and B are float32
// or bf16; C has their type.  The minimum propagates NaN, as jnp.minimum and
// torch.minimum do (min.NaN, never fminf).
//
// Bound: issue slots.  There is no tensor-core (min, +) and no fused min-add
// before sm_100, so float32 costs one FADD and one FMNMX per (i, k, j): at
// 132 SMs x 128 lanes the floor is 2 M K N / (16896 f_SM), 4.1 ms at 4096^3
// and 1.98 GHz.  bf16 runs on packed pairs (add.rn.bf16x2, min.NaN.bf16x2),
// two (i, k, j) a lane per instruction, which halves that floor.
//
// Design: a block of 256 threads owns a 128 x 128 tile of C; each thread
// keeps an 8 x 8 micro-tile of running minima in registers: rows ty*4 + {0..3}
// and 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}, so a
// thread's A rows and B columns are two 16-byte runs in shared memory (four
// LDS.128 a k-step for 64 pairs, none of them bank-conflicted) and the stores
// of C are 16-byte and coalesced.  K is walked in slices of 16, double-
// buffered: the next B slice is copied with cp.async (16-byte copies where a
// row's start is aligned, element by element where it is not) and the next
// A slice is loaded into registers while this slice is computed, then stored
// transposed (A_s[k][i]) so that a thread's rows are contiguous; one
// __syncthreads a slice.  For bf16 each A element is stored as the pair
// (a, a), so a k-step's eight rows are two LDS.128 and every add and min is a
// packed one.  The ragged edge is masked in the kernel: k past K reads +inf
// in both A and B (their sum, +inf, never wins, and +inf pairs only with
// +inf), rows and columns past M or N read 0 and are never stored, so no
// padded copy of A or B is made.
//
// Exactness: the minimum is exact, so the result does not depend on the order
// of K.  float32 sums are __fadd_rn.  bf16: the plain version adds in float32,
// takes the minimum and rounds to bf16 once; the kernel rounds every sum to
// bf16 (one bf16 add) and takes the minimum in bf16.  The two agree bit for
// bit: rounding a float32 sum of two bf16 values to bf16 equals the bf16 add
// (24 >= 2 * 8 + 2, so the double rounding is harmless, overflow included),
// rounding is monotone and the minimum is exact; the accumulator starts at
// RN_bf16(BIG) = the plain version's rounded BIG.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

#define MP_BIG 3.0e38f
#define MP_BM 128
#define MP_BN 128
#define MP_BK 16
#define MP_THREADS 256

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A_s element: a float32, or a bf16 pair (a, a)
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using pair = float;
  static __device__ __forceinline__ float inf() { return __int_as_float(0x7F800000); }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float dup(float a) { return a; }
};
template <>
struct Elem<__nv_bfloat16> {
  using pair = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat16 inf() { return __ushort_as_bfloat16(0x7F80); }
  static __device__ __forceinline__ __nv_bfloat16 zero() { return __ushort_as_bfloat16(0); }
  static __device__ __forceinline__ __nv_bfloat162 dup(__nv_bfloat16 a) {
    return __bfloat162bfloat162(a);
  }
};

__device__ __forceinline__ __nv_bfloat162 as_pair(uint32_t u) {
  union {
    uint32_t u;
    __nv_bfloat162 p;
  } x;
  x.u = u;
  return x.p;
}

__device__ __forceinline__ __nv_bfloat16 half_of(uint32_t u, int hi) {
  return __ushort_as_bfloat16((unsigned short)(hi ? u >> 16 : u & 0xFFFFu));
}

// 8 elements from a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 v0 = ((const float4*)p)[0], v1 = ((const float4*)p)[1];
  r[0] = v0.x, r[1] = v0.y, r[2] = v0.z, r[3] = v0.w;
  r[4] = v1.x, r[5] = v1.y, r[6] = v1.z, r[7] = v1.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, __nv_bfloat16 (&r)[8]) {
  const uint4 v = *(const uint4*)p;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 8; ++q) r[q] = half_of(w[q / 2], q % 2);
}

// this thread's 8 elements of the A slice at k0: row m0 + tid % 128, k from
// k0 + (tid / 128) * 8; +inf past K, 0 past M
template <typename T>
__device__ __forceinline__ void load_a(const T* __restrict__ A, int M, int K, int m0, int k0,
                                       bool vec, T (&r)[8]) {
  const int i = m0 + (int)threadIdx.x % MP_BM;
  const int kb = k0 + ((int)threadIdx.x / MP_BM) * 8;
  if (i >= M) {
#pragma unroll
    for (int q = 0; q < 8; ++q) r[q] = Elem<T>::zero();
    return;
  }
  const T* row = A + (size_t)i * K + kb;
  if (vec && kb + 8 <= K) {
    load8(row, r);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) r[q] = kb + q < K ? row[q] : Elem<T>::inf();
  }
}

template <typename T>
__device__ __forceinline__ void store_a(const T (&r)[8], typename Elem<T>::pair* As) {
  const int i = (int)threadIdx.x % MP_BM, kb = ((int)threadIdx.x / MP_BM) * 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) As[(kb + q) * MP_BM + i] = Elem<T>::dup(r[q]);
}

// the B slice at k0 into Bs[k][j]: 16-byte cp.async where the row is aligned
// and in range, else element by element (+inf past K, 0 past N)
template <typename T>
__device__ __forceinline__ void load_b(const T* __restrict__ B, int K, int N, int k0, int n0,
                                       bool vec, T* Bs) {
  constexpr int V = 16 / sizeof(T);
  constexpr int ROW = MP_BN / V;
  for (int c = threadIdx.x; c < MP_BK * ROW; c += MP_THREADS) {
    const int k = c / ROW, jj = (c % ROW) * V;
    const int gk = k0 + k, gj = n0 + jj;
    T* dst = Bs + k * MP_BN + jj;
    const T* src = B + (size_t)gk * N + gj;
    if (gk < K && vec && gj + V <= N) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        dst[v] = gk >= K ? Elem<T>::inf() : (gj + v < N ? src[v] : Elem<T>::zero());
    }
  }
}

// one k-step on the micro-tile
__device__ __forceinline__ void kstep(float (&acc)[8][8], const float* As, const float* Bs,
                                      int tx, int ty) {
  const float4 a0 = *(const float4*)&As[ty * 4], a1 = *(const float4*)&As[64 + ty * 4];
  const float4 b0 = *(const float4*)&Bs[tx * 4], b1 = *(const float4*)&Bs[64 + tx * 4];
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = min_nan(acc[a][b], __fadd_rn(av[a], bv[b]));
}

__device__ __forceinline__ void kstep(__nv_bfloat162 (&acc)[8][4], const __nv_bfloat162* As,
                                      const __nv_bfloat16* Bs, int tx, int ty) {
  const uint4 a0 = *(const uint4*)&As[ty * 4], a1 = *(const uint4*)&As[64 + ty * 4];
  const uint2 b0 = *(const uint2*)&Bs[tx * 4], b1 = *(const uint2*)&Bs[64 + tx * 4];
  const __nv_bfloat162 av[8] = {as_pair(a0.x), as_pair(a0.y), as_pair(a0.z), as_pair(a0.w),
                                as_pair(a1.x), as_pair(a1.y), as_pair(a1.z), as_pair(a1.w)};
  const __nv_bfloat162 bv[4] = {as_pair(b0.x), as_pair(b0.y), as_pair(b1.x), as_pair(b1.y)};
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[a][p] = __hmin2_nan(acc[a][p], __hadd2(av[a], bv[p]));
}

// columns h * 64 + tx * 4 + {0..3} of micro-tile row a at C row gi (one 16-
// or 8-byte store when aligned and in range)
__device__ __forceinline__ void store_c(float* C, int N, int gi, int gj,
                                        const float (&acc)[8][8], int a, int h, bool vec) {
  float* out = C + (size_t)gi * N + gj;
  const float v[4] = {acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2], acc[a][4 * h + 3]};
  if (vec && gj + 4 <= N) {
    *(float4*)out = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (gj + q < N) out[q] = v[q];
  }
}

__device__ __forceinline__ void store_c(__nv_bfloat16* C, int N, int gi, int gj,
                                        const __nv_bfloat162 (&acc)[8][4], int a, int h,
                                        bool vec) {
  __nv_bfloat16* out = C + (size_t)gi * N + gj;
  const __nv_bfloat162 lo = acc[a][2 * h], hi = acc[a][2 * h + 1];
  if (vec && gj + 4 <= N) {
    *(__nv_bfloat162*)out = lo;
    *(__nv_bfloat162*)(out + 2) = hi;
  } else {
    const __nv_bfloat16 v[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (gj + q < N) out[q] = v[q];
  }
}

template <typename T>
struct Acc;
template <>
struct Acc<float> {
  using tile = float[8][8];
};
template <>
struct Acc<__nv_bfloat16> {
  using tile = __nv_bfloat162[8][4];
};

__device__ __forceinline__ void init_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = MP_BIG;
}

__device__ __forceinline__ void init_acc(__nv_bfloat162 (&acc)[8][4]) {
  const __nv_bfloat162 big = __bfloat162bfloat162(__float2bfloat16_rn(MP_BIG));
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[a][p] = big;
}

template <typename T>
__global__ void __launch_bounds__(MP_THREADS, 2)
minplus_kernel(const T* __restrict__ A,  // (M, K)
               const T* __restrict__ B,  // (K, N)
               T* __restrict__ C,        // (M, N)
               int M, int K, int N, int vec_a, int vec_b, int vec_c) {
  using P2 = typename Elem<T>::pair;
  __shared__ __align__(16) P2 As[2][MP_BK * MP_BM];  // A slice, transposed: As[k][i]
  __shared__ __align__(16) T Bs[2][MP_BK * MP_BN];   // B slice: Bs[k][j]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * MP_BM, n0 = blockIdx.x * MP_BN;

  typename Acc<T>::tile acc;
  init_acc(acc);

  T ar[8];
  load_a(A, M, K, m0, 0, vec_a, ar);
  store_a(ar, As[0]);
  load_b(B, K, N, 0, n0, vec_b, Bs[0]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int n_slices = (K + MP_BK - 1) / MP_BK;
  for (int s = 0; s < n_slices; ++s) {
    const int buf = s & 1;
    const bool more = s + 1 < n_slices;
    if (more) {  // the next slice loads while this one is computed
      load_a(A, M, K, m0, (s + 1) * MP_BK, vec_a, ar);
      load_b(B, K, N, (s + 1) * MP_BK, n0, vec_b, Bs[buf ^ 1]);
      cp_async_commit();
    }
#pragma unroll
    for (int k = 0; k < MP_BK; ++k)
      kstep(acc, &As[buf][k * MP_BM], &Bs[buf][k * MP_BN], tx, ty);
    if (more) {
      store_a(ar, As[buf ^ 1]);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int gi = m0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (gi >= M) continue;
    store_c(C, N, gi, n0 + tx * 4, acc, a, 0, vec_c);
    store_c(C, N, gi, n0 + 64 + tx * 4, acc, a, 1, vec_c);
  }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
static int minplus_launch(const void* A, const void* B, void* C, int M, int K, int N,
                          void* stream) {
  const int V = 16 / (int)sizeof(T);
  const int vec_a = aligned16(A) && K % V == 0;
  const int vec_b = aligned16(B) && N % V == 0;
  const int vec_c = aligned16(C) && N % 4 == 0;
  const dim3 grid((unsigned)((N + MP_BN - 1) / MP_BN), (unsigned)((M + MP_BM - 1) / MP_BM));
  minplus_kernel<T><<<grid, MP_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)A, (const T*)B, (T*)C, M, K, N, vec_a, vec_b, vec_c);
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
