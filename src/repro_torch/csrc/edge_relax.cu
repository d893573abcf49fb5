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
// Two entries share the arithmetic (relax_cell in relax.cuh, which ceft_relax.cu
// uses too):
//
//   edge_relax_f32  the (B, E, P) contract of the Pallas kernel: one thread per
//                   (b, e, j) output, L[b] and bw[b] staged in shared memory
//                   (16.6 KB at P = 64).
//   seg_level_f32   a whole segment-layout level of the sweep in one launch:
//                   it gathers each edge's parent row from the carry, relaxes
//                   it, takes each child's max over its contiguous segment of
//                   edges (the first maximal edge in edge order wins), adds
//                   comp and writes ceft, pred_task and pred_proc into the
//                   carry rows of the level's tasks.  A block takes a tile of
//                   edges: it stages the tile's parent rows in shared memory,
//                   relaxes each (edge, j) cell on a thread of its own (1024
//                   threads, 16 edges at P = 64) into a shared tile, and folds
//                   each segment piece of the tile (takes_max: a larger
//                   value or the first NaN wins, as in the reference).  A
//                   segment that lies inside one tile is written at once; one
//                   that crosses a tile boundary (heavy-tailed fan-in has
//                   segments of thousands of edges) goes through a 64-bit
//                   atomicMax on a packed (value, first edge, class) key, and
//                   the block that finishes last decodes those keys and resets
//                   them, so the scratch stays zero between launches and needs
//                   no memset.  The result does not depend on block order.
//
// A level reads only parent rows (lower levels) and writes only its own tasks'
// rows, so updating the carry in place inside one launch is race-free.
//
// Bound: the level's E·P² correctly rounded divides.  The sweep's levels are
// small (about 400 real edges at P = 64 for the paper's n = 16384 graph), so
// the twenty-odd launches of the plain version's gathers, segment reduction
// and scatters cost more than the arithmetic; one launch does it all.  Each
// thread's chain of P dependent divides then sets the kernel's time while a
// level fills only a few of the card's SMs.  The outputs must be bit-equal to
// the plain PyTorch versions and to the JAX reference, so every operation is
// pinned: a correctly rounded divide (__fdiv_rn), explicit round-to-nearest
// adds and multiplies (no FMA contraction), the reference's operation order,
// the multiply by off in place of a diagonal special case, and the NaN-aware
// first-index compares of relax.cuh for the argmin and the argmax.  Never build this file
// with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "relax.cuh"

__device__ __forceinline__ void stage_machine(const float* L, const float* bw, int b, int P,
                                              float* sL, float* sbw) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) sL[i] = L[(size_t)b * P + i];
  for (int i = threadIdx.x; i < P * P; i += blockDim.x) sbw[i] = bw[(size_t)b * P * P + i];
}

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
  stage_machine(L, bw, b, P, sL, sbw);
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)E * P) return;
  const int e = (int)(idx / P);
  const int j = (int)(idx % P);
  const size_t row = ((size_t)b * E + e) * P;
  float best;
  int arg;
  relax_cell(pv + row, pdata[e], sL, sbw, P, j, best, arg);
  minl[row + j] = best;
  argl[row + j] = arg;
}

// a block relaxes one (edge, j) cell a thread: a tile is SEG_THREADS / P edges
#define SEG_THREADS 1024

__global__ void __launch_bounds__(SEG_THREADS, 2) seg_level_kernel(
    float* __restrict__ ceft,                // (B, V, P) carry, updated in place
    int32_t* __restrict__ ptask,             // (B, V, P)
    int32_t* __restrict__ pproc,             // (B, V, P)
    const float* __restrict__ comp,          // (B, V, P)
    const float* __restrict__ L,             // (B, P)
    const float* __restrict__ bw,            // (B, P, P)
    const int64_t* __restrict__ tasks,       // (w,) carry rows of the level's tasks
    const int64_t* __restrict__ esrc,        // (E_b,) parent row of each edge
    const float* __restrict__ edata,         // (E_b,)
    const int64_t* __restrict__ eseg,        // (E_b,) child slot of each edge, ascending
    unsigned long long* __restrict__ keys,   // (B, W, P) zero on entry and on exit
    int* __restrict__ counts,                // (B,) zero on entry and on exit
    int V, int P, int W, int e_real, int tile_e) {
  extern __shared__ float smem[];
  float* sL = smem;                     // (P,)
  float* sbw = sL + P;                  // (P, P)
  float* spv = sbw + P * P;             // (tile_e, P) parent rows
  float* sval = spv + tile_e * P;       // (tile_e, P) relaxed values
  int* sarg = (int*)(sval + tile_e * P);  // (tile_e, P) their argmin classes
  int* sseg = sarg + tile_e * P;        // (tile_e,)
  __shared__ int is_last;

  const int b = blockIdx.y;
  const int e0 = blockIdx.x * tile_e;
  const int ne = min(tile_e, e_real - e0);
  const size_t plane = (size_t)b * V * P;
  stage_machine(L, bw, b, P, sL, sbw);
  for (int i = threadIdx.x; i < ne; i += blockDim.x) sseg[i] = (int)eseg[e0 + i];
  for (int i = threadIdx.x; i < ne * P; i += blockDim.x)
    spv[i] = ceft[plane + (size_t)esrc[e0 + i / P] * P + i % P];
  __syncthreads();

  for (int i = threadIdx.x; i < ne * P; i += blockDim.x) {
    const int e = i / P;
    float best;
    int arg;
    relax_cell(spv + e * P, edata[e0 + e], sL, sbw, P, i % P, best, arg);
    sval[i] = best;
    sarg[i] = arg;
  }
  __syncthreads();

  // one thread per (segment piece, j): fold the piece in edge order
  for (int i = threadIdx.x; i < ne * P; i += blockDim.x) {
    const int e = i / P, j = i % P, s = sseg[e];
    if (e > 0 && sseg[e - 1] == s) continue;  // not the first edge of its piece
    float v = sval[i];
    int ae = e, al = sarg[i];
    int k = e + 1;
    for (; k < ne && sseg[k] == s; ++k) {
      const float c = sval[k * P + j];
      if (takes_max(c, v)) {
        v = c;
        ae = k;
        al = sarg[k * P + j];
      }
    }
    const bool starts = e > 0 || e0 == 0 || eseg[e0 - 1] != s;
    const bool ends = k < ne || e0 + k == e_real || eseg[e0 + k] != s;
    if (starts && ends) {
      const size_t o = plane + (size_t)tasks[s] * P + j;
      ceft[o] = __fadd_rn(comp[o], v);
      ptask[o] = (int32_t)esrc[e0 + ae];
      pproc[o] = al;
    } else {
      atomicMax(&keys[((size_t)b * W + s) * P + j], pack_key(v, e0 + ae, al));
    }
  }
  if (gridDim.x == 1) return;

  // the last block of plane b to finish decodes the crossing segments' keys
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&counts[b], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < ((int)gridDim.x - 1) * P; i += blockDim.x) {
    const int t = i / P + 1, j = i % P;     // tile boundary t: edge t * tile_e
    const int be = t * tile_e, ps = be - tile_e;
    const int s = (int)eseg[be];
    if (eseg[be - 1] != s) continue;          // no segment crosses it
    if (ps > 0 && eseg[ps - 1] == s) continue;  // decoded at an earlier boundary
    const unsigned long long key = atomicExch(&keys[((size_t)b * W + s) * P + j], 0ull);
    const uint32_t lo = (uint32_t)key;
    const size_t o = plane + (size_t)tasks[s] * P + j;
    ceft[o] = __fadd_rn(comp[o], from_ordered_bits((uint32_t)(key >> 32)));
    ptask[o] = (int32_t)esrc[key_index(lo)];
    pproc[o] = key_class(lo);
  }
  if (threadIdx.x == 0) counts[b] = 0;
}

static int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

extern "C" int edge_relax_f32(const void* pv, const void* pdata, const void* L,
                              const void* bw, void* minl, void* argl, int B, int E,
                              int P, void* stream) {
  const int threads = 256;
  const long long n = (long long)E * P;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)B);
  const size_t smem = sizeof(float) * ((size_t)P + (size_t)P * P);
  const int err = set_smem((const void*)edge_relax_kernel, smem);
  if (err != 0) return err;
  edge_relax_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)pv, (const float*)pdata, (const float*)L, (const float*)bw,
      (float*)minl, (int32_t*)argl, E, P);
  return (int)cudaGetLastError();
}

// One segment-layout level over the first e_real edges (e_real >= 1); keys
// holds B * W * P and counts B zeros, and are left zero.
extern "C" int seg_level_f32(void* ceft, void* ptask, void* pproc, const void* comp,
                             const void* L, const void* bw, const void* tasks,
                             const void* esrc, const void* edata, const void* eseg,
                             void* keys, void* counts, int B, int V, int P, int W,
                             int e_real, void* stream) {
  const int tile_e = P >= SEG_THREADS ? 1 : SEG_THREADS / P;
  const dim3 grid((unsigned)((e_real + tile_e - 1) / tile_e), (unsigned)B);
  const size_t smem = sizeof(float) * ((size_t)P + (size_t)P * P + 3 * (size_t)tile_e * P +
                                       (size_t)tile_e);
  const int err = set_smem((const void*)seg_level_kernel, smem);
  if (err != 0) return err;
  seg_level_kernel<<<grid, SEG_THREADS, smem, (cudaStream_t)stream>>>(
      (float*)ceft, (int32_t*)ptask, (int32_t*)pproc, (const float*)comp, (const float*)L,
      (const float*)bw, (const int64_t*)tasks, (const int64_t*)esrc, (const float*)edata,
      (const int64_t*)eseg, (unsigned long long*)keys, (int*)counts, V, P, W, e_real,
      tile_e);
  return (int)cudaGetLastError();
}
