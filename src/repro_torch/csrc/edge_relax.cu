// Edge-centric CEFT relaxation for the CSR sweep's segment-layout levels.
//
//   minl[b, e, j] = min_l  pv[b, e, l] + (L[b, l] + pdata[e] / bw[b, l, j]) * off[l, j]
//   argl[b, e, j] = the first l that attains the minimum
//
// with off[l, j] = 0.0 on the diagonal and 1.0 elsewhere.  Replaces the Pallas
// kernel src/repro/kernels/ceft_relax.py:_edge_relax_kernel (entry
// edge_relax_pallas); b is the batch of cost planes / machines that share one
// set of edge tables.  Two entries:
//
//   edge_relax_f32  the (B, E, P) contract of the Pallas kernel, off the
//                   sweep: the relaxation alone, with no gather, segment max
//                   or carry writes around it.
//   seg_level_f32   a whole segment-layout level of the sweep in one launch:
//                   it gathers each edge's parent row from the carry, relaxes
//                   it, takes each child's max over its contiguous segment of
//                   edges (the first maximal edge in edge order wins), adds
//                   comp and writes ceft, pred_task and pred_proc into the
//                   carry rows of the level's tasks.
//
// Both are bound by issue slots: B * E * P^2 candidates of float32 scalar
// arithmetic (a divide, two adds, a multiply by off, a NaN-aware compare and
// two selects) with no tensor-core form and a few bytes each.  Both split the
// class loop across lanes and divide by Markstein's form (relax.cuh:
// stage_pairs, relax_lanes).  edge_relax's design:
//
//   * The launch, from the host (kernels/edge_relax.py:edge_relax_grid, a
//     rule chosen by timing every launch shape on the H100): a block takes a
//     tile of TE edges of one plane and a j-chunk of JC classes; G lanes
//     split each (edge, j) cell's class loop, the fewest that still give
//     every SM threads (2 at (1, 1024, 64), 1 at (1, 2048, 64) and for a
//     batch of 8): each lane more shortens a thread's loop and adds a
//     combine round; a tile takes as many passes as keep the grid within
//     what the card holds at once.
//   * One memory round trip before the arithmetic: the tile's pv rows (one
//     contiguous range) and edge data by cp.async, and while they land the
//     j-chunk's (bw, RN(1/bw), L, off) entries, every load issued before any
//     reciprocal, each bw checked against the Markstein window; a thread
//     whose edges or machine leave the window relaxes its pass with
//     __fdiv_rn.  Only the j-chunk is staged, so every width fits: P up to
//     2048 in the staged kernel, any wider machine in a kernel that reads L
//     and bw from global memory.
//   * ER_EPT = 4 edges a thread for one class j, so that each staged entry
//     serves 4 candidates and their chains run side by side (8 took 80
//     registers and spilled).
//   * The lanes combine by a reduce-scatter (relax.cuh: scatter_lanes): each
//     round halves the edges a lane holds, so a lane shuffles ER_EPT -
//     ER_EPT / G values of each kind, not ER_EPT log2(G), and every lane ends
//     with its own cells and stores them.
//   * P is a template parameter for 8, 16, 32 and 64 (a 16-byte aligned pv),
//     one instance with a run-time P takes every other width.  argl is int32
//     and nothing is packed, so no key limits P.
//
// seg_level's design.  A level is B * e_real * P^2 candidates.  The sweep's
// levels are small (385 real edges on average, 1611 at
// most, at P = 64 for the paper's n = 16384 graph), so a level must also
// spread over every SM, and a block's chain of dependent memory round trips
// counts as much as its arithmetic.  The design:
//
//   * The whole card.  The host (kernels/edge_relax.py:seg_level_grid) picks
//     the launch from the level's size and the SM count: a block takes a
//     tile of edges and JC of the P child classes (a j-chunk; splitting j
//     costs nothing in the segment max, which is per class), grid (tiles x
//     j-chunks, B); a tile takes as many passes as keep the grid within what
//     the card holds at once, and a small level halves its block instead.
//   * The class loop split across lanes.  G lanes (8 for a single level at
//     P = 64, fewer for a batch of planes, where the threads are plenty)
//     share one (edge, j) cell, each scanning a contiguous range of classes
//     l, two at a time, and combine in l order with warp shuffles
//     (takes_min: the upper range replaces the lower only if smaller or the
//     first NaN), which is the serial first-index scan exactly.
//   * SEG_EPT edges a thread for one j, so that each staged (bw, RN(1/bw),
//     L, off) entry read from shared memory serves SEG_EPT candidates and
//     their chains run side by side.
//   * The divide without a MUFU per candidate: the block stages its j-chunk's
//     (bw, RN(1/bw)) once (every load issued before any reciprocal) and
//     checks every bw and each edge's d against relax.cuh's exponent window;
//     inside it the divide is relax.cuh's Markstein form, outside it
//     __fdiv_rn, and either is correctly rounded.
//   * Three memory round trips before the arithmetic, not one a phase: the
//     first brings a window of the edge tables and the machine, and moves
//     each tile boundary on to the next segment start within SEG_SNAP edges
//     (a warp ballot), so that few segments cross tiles; the second brings
//     the tile's parent rows by cp.async (16 bytes where aligned) and each
//     segment's task row; the third, each segment's comp row, lands while the
//     block relaxes.
//   * Segments: each segment piece of a tile is folded in edge order in shared
//     memory, four edges a step (takes_max: a larger value or the first NaN
//     wins).  A segment inside one tile is written at once; one that crosses
//     a tile boundary goes through a 64-bit atomicMax on a packed (value,
//     first edge, class) key, and the tile that arrives last at that segment
//     (a 64-bit counter per segment and j-chunk counts arrivals and records
//     the first and last tile, so the last arrival knows it is last) decodes
//     its keys and resets them and the counter.  The scratch stays zero
//     between launches and needs no memset; the result does not depend on
//     block order.
//
// A level reads only parent rows (lower levels) and writes only its own tasks'
// rows, so updating the carry in place inside one launch is race-free.
//
// The outputs must be bit-equal to the plain PyTorch versions and to the JAX
// reference, so every operation is pinned: a correctly rounded divide,
// explicit round-to-nearest adds (the one FMA outside the divide adds pv to
// (L + q) * off, a product by 0 or 1 that is exact, so it rounds as the
// multiply and then the add do), the reference's operation order, the
// multiply by off in place of a diagonal special case, and the NaN-aware
// first-index compares of relax.cuh for the argmin and the argmax.  Never
// build this file with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "relax.cuh"

__host__ __device__ __forceinline__ size_t align16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

#define ER_MAX_THREADS 256
#define ER_BLOCKS_PER_SM 3  // resident blocks an SM (launch bounds: 85 registers)
#define ER_EPT 4            // edges a thread relaxes for one class j in a pass
#define ER_MAX_LANES ER_EPT  // the combine leaves each lane ER_EPT / G edges
#define ER_STAGE 4          // machine entries a thread loads before it computes any

// an edge_relax block's shared memory, each array 16-byte aligned: the
// j-chunk's staged machine entries, the tile's pv rows (4 floats more, so that
// they keep their 16-byte phase in global memory) and its edge data
struct ErSmem {
  size_t sq, spv, sd, total;
  __host__ __device__ ErSmem(int P, int G, int JC, int TE) {
    const int lpt = (P + G - 1) / G;
    sq = 0;                                                      // (JC, S) float4
    spv = sq + align16(16 * (size_t)JC * lane_stride(G, lpt));   // (TE, P) + 4
    sd = spv + align16(4 * ((size_t)TE * P + 4));                // (TE,)
    total = sd + align16(4 * (size_t)TE);
  }
};

// PT: P for the 8, 16, 32 and 64 instances (pv 16-byte aligned), 0 for the
// one with a run-time P.  Block blockIdx.x = (b n_tiles + tile) n_jc + jc
// takes TE edges of plane b from e0 = tile TE on, and the JC classes j of
// j-chunk jc.  A group of G * JC consecutive threads (a power of two up to
// the block) is G lanes of a warp for each of its JC classes j; a block's
// groups take ER_EPT edges each in a pass.
template <int PT>
__global__ void __launch_bounds__(ER_MAX_THREADS, ER_BLOCKS_PER_SM) edge_relax_kernel(
    const float* __restrict__ pv,     // (B, E, P)
    const float* __restrict__ pdata,  // (E,)
    const float* __restrict__ L,      // (B, P)
    const float* __restrict__ bw,     // (B, P, P)
    float* __restrict__ minl,         // (B, E, P)
    int32_t* __restrict__ argl,       // (B, E, P)
    int E, int P_rt, int G, int JC, int n_jc, int n_tiles, int TE) {
  const int P = PT > 0 ? PT : P_rt;
  const int lpt = (P + G - 1) / G, S = lane_stride(G, lpt);
  const int EP = blockDim.x / (G * JC) * ER_EPT;  // edges a pass
  const int jc = blockIdx.x % n_jc, bt = blockIdx.x / n_jc;
  const int b = bt / n_tiles, e0 = bt % n_tiles * TE, ne = min(TE, E - e0);
  const int j0 = jc * JC, nj = min(JC, P - j0);
  const int jcs = __ffs(JC) - 1, lps = __ffs(lpt) - 1;  // JC, G and (for PT > 0) lpt: powers of two
  const int gl = threadIdx.x & (G - 1);                 // this thread's lane of its cell
  const int cj = (threadIdx.x / G) & (JC - 1);          // its class j - j0
  const int grp = threadIdx.x / (G * JC);               // its edge group

  extern __shared__ float4 smem4[];
  const ErSmem lay(P, G, JC, TE);
  char* base = (char*)smem4;
  float4* sq = (float4*)(base + lay.sq);  // (bw, RN(1/bw), L, off) of the j-chunk
  float* sd = (float*)(base + lay.sd);

  // one round trip before the arithmetic: the tile's pv rows (one contiguous
  // range: 16-byte copies between a head and a tail) and edge data by
  // cp.async, and, while they land, the machine's j-chunk
  const size_t row0 = ((size_t)b * E + e0) * P;
  const float* src = pv + row0;
  const int sh = (int)(((uintptr_t)src >> 2) & 3);  // 0 for PT > 0
  float* rows = (float*)(base + lay.spv) + sh;
  const int n = ne * P, head = min((4 - sh) & 3, n), n16 = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) cp_async4(rows + i, src + i);
  for (int c = threadIdx.x; c < n16; c += blockDim.x)
    cp_async16(rows + head + 4 * c, src + head + 4 * c);
  for (int i = head + 4 * n16 + threadIdx.x; i < n; i += blockDim.x) cp_async4(rows + i, src + i);
  for (int i = threadIdx.x; i < ne; i += blockDim.x) cp_async4(sd + i, pdata + e0 + i);
  cp_async_commit();
  const bool staged_ok = stage_pairs<PT, ER_STAGE>(
      bw + (size_t)b * P * P + j0, L + (size_t)b * P, P, j0, nj, JC, jcs, G, lpt, lps, S, sq);
  cp_async_wait<0>();
  const bool machine_in_window = __syncthreads_and(staged_ok);

  // relax the tile's edges, ER_EPT a thread a pass; the lanes' combine leaves
  // lane gl with ER_EPT / G of them, which it stores
  const int l0 = gl * lpt, nl = max(0, min(lpt, P - l0));
  const float4* sqc = sq + cj * S + gl;
  const size_t out0 = row0 + j0 + cj;
  for (int p0 = 0; p0 < ne; p0 += EP) {
    const int r0 = p0 + grp * ER_EPT;
    float d[ER_EPT];
    bool fast = machine_in_window;
#pragma unroll
    for (int k = 0; k < ER_EPT; ++k) {  // past the tile: its last edge's data
      d[k] = sd[min(r0 + k, ne - 1)];
      fast = fast && markstein_num(d[k]);
    }
    float best[ER_EPT];
    int arg[ER_EPT];
    if (fast)
      relax_lanes<PT, true>(rows + r0 * P + l0, P, d, sqc, G, l0, nl, best, arg);
    else
      relax_lanes<PT, false>(rows + r0 * P + l0, P, d, sqc, G, l0, nl, best, arg);
    const int k0 = scatter_lanes(best, arg, G, gl);
    if (cj < nj) {
#pragma unroll
      for (int i = 0; i < ER_EPT; ++i) {
        const int r = r0 + k0 + i;
        if (i < ER_EPT / G && r < ne) {
          minl[out0 + (size_t)r * P] = best[i];
          argl[out0 + (size_t)r * P] = arg[i];
        }
      }
    }
  }
}

// Machines too wide for any staged launch (edge_relax_grid: P above 2048):
// one thread per (b, e, j) output through relax.cuh's relax_cell, reading L
// and bw from global memory, with __fdiv_rn.
__global__ void __launch_bounds__(ER_MAX_THREADS) edge_relax_global_kernel(
    const float* __restrict__ pv, const float* __restrict__ pdata, const float* __restrict__ L,
    const float* __restrict__ bw, float* __restrict__ minl, int32_t* __restrict__ argl, int B,
    int E, int P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * E * P) return;
  const long long be = idx / P;  // b E + e
  const int j = (int)(idx % P), e = (int)(be % E), b = (int)(be / E);
  float best;
  int arg;
  relax_cell(pv + be * P, pdata[e], L + (size_t)b * P, bw + (size_t)b * P * P, P, j, best, arg);
  minl[idx] = best;
  argl[idx] = arg;
}

#define SEG_MAX_THREADS 256
#define SEG_BLOCKS_PER_SM 3  // resident blocks an SM (launch bounds: 85 registers)
#define SEG_EPT 8            // edges a thread relaxes for one class j in a pass
#define SEG_SNAP 16          // the farthest a tile boundary moves on to a segment start
static_assert(SEG_SNAP == 16, "the snap takes half a warp for each tile boundary");
#define SEG_STAGE 4          // machine entries a thread loads before it computes any
// a crossing segment's arrival counter: arrivals in the high word; the low
// word gains SEG_TILE_BIG - t from its first tile t0 and SEG_TILE_BIG + t from
// its last tile t1, so it holds 2 SEG_TILE_BIG + t1 - t0 once both arrived
#define SEG_TILE_BIG (1u << 24)

// a block's shared memory, each array 16-byte aligned, in kernel order; EP
// is the edges of a pass
struct SegSmem {
  size_t sq, spv, ssrc, sdat, sseg, stask, sval, sarg, scomp, total;
  __host__ __device__ SegSmem(int P, int G, int JC, int TE, int EP) {
    const int lpt = (P + G - 1) / G;
    const size_t cap = (size_t)TE + SEG_SNAP, nwin = cap + 1;
    sq = 0;                                                    // (JC, S) float4
    // (cap + EP, P) parent rows: a pass past the tile reads rows it does not write
    spv = sq + align16(16 * (size_t)JC * lane_stride(G, lpt));
    ssrc = spv + align16(4 * (cap + EP) * P);                  // (nwin,) window's esrc
    sdat = ssrc + align16(8 * nwin);                           // (nwin,) edata
    sseg = sdat + align16(4 * nwin);                           // (nwin,) eseg, -1 outside
    stask = sseg + align16(4 * nwin);                          // (cap,) piece starts' rows
    sval = stask + align16(4 * cap);                           // (cap, JC) cell minima
    sarg = sval + align16(4 * cap * JC);                       // (cap, JC) their classes
    scomp = sarg + align16(4 * cap * JC);                      // (cap, JC) piece starts' comp
    total = scomp + align16(4 * cap * JC);
  }
};

// PT: P for the 8, 16, 32 and 64 instances, 0 for the one with a run-time P.
// Block (tile, j-chunk) of plane blockIdx.y.  An edge group is G * JC
// consecutive threads (a power of two up to the block): G lanes of a warp for
// each of its JC classes j; the groups of a block take SEG_EPT edges each in
// a pass.
template <int PT>
__global__ void __launch_bounds__(SEG_MAX_THREADS, SEG_BLOCKS_PER_SM) seg_level_kernel(
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
    unsigned long long* __restrict__ cnt,    // (B, W, n_jc) zero on entry and on exit
    int V, int P_rt, int W, int e_real, int G, int JC, int n_jc, int TE) {
  const int P = PT > 0 ? PT : P_rt;
  const int lpt = (P + G - 1) / G;
  const int S = lane_stride(G, lpt);
  const int EP = blockDim.x / (G * JC) * SEG_EPT;  // edges a pass
  const int b = blockIdx.y, tile = blockIdx.x / n_jc, jc = blockIdx.x % n_jc;
  const int j0 = jc * JC, nj = min(JC, P - j0);
  const size_t plane = (size_t)b * V * P;
  const int tid = threadIdx.x, lane = tid % 32;
  const int jcs = __ffs(JC) - 1, lps = __ffs(lpt) - 1;  // JC, G and (for PT > 0) lpt: powers of two
  const int g = lane & (G - 1), jl = (tid / G) & (JC - 1), eg = tid / (G * JC);

  extern __shared__ float4 smem4[];
  const SegSmem lay(P, G, JC, TE, EP);
  char* base = (char*)smem4;
  float4* sq = (float4*)(base + lay.sq);        // (bw, RN(1/bw), L, off) of the j-chunk
  float* spv = (float*)(base + lay.spv);
  int64_t* ssrc = (int64_t*)(base + lay.ssrc);
  float* sdat = (float*)(base + lay.sdat);
  int* sseg = (int*)(base + lay.sseg);
  int* stask = (int*)(base + lay.stask);
  float* sval = (float*)(base + lay.sval);
  int* sarg = (int*)(base + lay.sarg);
  float* scomp = (float*)(base + lay.scomp);
  __shared__ int snap[2], cross[2], crossr[2], decode[2];

  // the edge tables of the window [x0 - 1, x0 + TE + SEG_SNAP), the j-chunk
  // of the machine, and where the tile starts and ends: each nominal boundary
  // x moves on to the first segment start in [x, x + SEG_SNAP), so that few
  // segments cross tiles (warp 0: lanes 0-15 the start, 16-31 the end; a
  // boundary without a segment start in its window stays where it was; a
  // tile may end up empty)
  const int x0 = tile * TE, w0 = x0 - 1, nwin = TE + SEG_SNAP + 1;
  const int side = lane / 16, y = x0 + side * TE + lane % 16;
  int64_t sy = -1, sy1 = -1;  // warp 0: the slots of edges y and y - 1, loaded first
  if (tid < 32 && y < e_real) {
    sy = eseg[y];
    if (y > 0) sy1 = eseg[y - 1];
  }
  for (int i = tid; i < nwin; i += blockDim.x) {
    const int e = w0 + i;
    const bool in = e >= 0 && e < e_real;
    ssrc[i] = in ? esrc[e] : 0;
    sdat[i] = in ? edata[e] : 0.0f;
    sseg[i] = in ? (int)eseg[e] : -1;
  }
  const bool ok = stage_pairs<PT, SEG_STAGE>(bw + (size_t)b * P * P + j0, L + (size_t)b * P,
                                             P, j0, nj, JC, jcs, G, lpt, lps, S, sq);
  if (tid < 32) {
    const unsigned m = __ballot_sync(0xFFFFFFFFu, y < e_real && sy != sy1) >> (16 * side) & 0xFFFFu;
    if (lane % 16 == 0) snap[side] = m ? y + __ffs(m) - 1 : y;
  }
  if (tid < 2) cross[tid] = -1;
  const bool bw_window = __syncthreads_and(ok);
  const int e0 = snap[0], e1 = min(snap[1], e_real);
  const int ne = e1 - e0, at0 = e0 - w0;  // window index of edge e0

  // the parent rows (cp.async, 16 bytes where aligned); each piece's task row
  // and, behind it, its comp row
  const bool vec = P % 4 == 0 && (((uintptr_t)ceft | (uintptr_t)comp) & 15) == 0;
  if (vec) {
    const int n4 = P / 4;
    for (int i = tid; i < ne * n4; i += blockDim.x) {
      const int r = i / n4, q = i % n4;
      cp_async16(spv + r * P + 4 * q, ceft + plane + (size_t)ssrc[at0 + r] * P + 4 * q);
    }
  } else {
    for (int i = tid; i < ne * P; i += blockDim.x)
      cp_async4(spv + i, ceft + plane + (size_t)ssrc[at0 + i / P] * P + i % P);
  }
  cp_async_commit();
  for (int r = tid; r < ne; r += blockDim.x) {
    if (r > 0 && sseg[at0 + r - 1] == sseg[at0 + r]) continue;
    const int t = (int)tasks[sseg[at0 + r]];
    stask[r] = t;
    const float* crow = comp + plane + (size_t)t * P + j0;
    float* dst = scomp + (r << jcs);
    if (vec && JC % 4 == 0 && nj % 4 == 0) {
      for (int c = 0; c < nj; c += 4) cp_async16(dst + c, crow + c);
    } else {
      for (int c = 0; c < nj; ++c) cp_async4(dst + c, crow + c);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();  // this thread's parent rows have landed
  __syncthreads();     // and everyone's

  // relax the tile's edges, SEG_EPT a thread a pass
  const int l0 = g * lpt, nl = max(0, min(lpt, P - l0));
  const float4* sqc = sq + jl * S + g;
  for (int p0 = 0; p0 < ne; p0 += EP) {
    const int r0 = p0 + eg * SEG_EPT;
    float d[SEG_EPT];
    bool fast = bw_window;
#pragma unroll
    for (int k = 0; k < SEG_EPT; ++k) {  // past the tile: its last edge's data
      d[k] = sdat[at0 + min(r0 + k, ne - 1)];
      fast = fast && markstein_num(d[k]);
    }
    float best[SEG_EPT];
    int arg[SEG_EPT];
    if (fast)
      relax_lanes<PT, true>(spv + r0 * P + l0, P, d, sqc, G, l0, nl, best, arg);
    else
      relax_lanes<PT, false>(spv + r0 * P + l0, P, d, sqc, G, l0, nl, best, arg);
    // combine the G lanes' contiguous ranges in l order: lane g (a multiple
    // of 2o) takes lane g + o's range, the upper one, where takes_min says so
    for (int o = 1; o < G; o <<= 1) {
#pragma unroll
      for (int k = 0; k < SEG_EPT; ++k) {
        const float ob = __shfl_down_sync(0xFFFFFFFFu, best[k], o);
        const int oa = __shfl_down_sync(0xFFFFFFFFu, arg[k], o);
        if (takes_min(ob, best[k])) {
          best[k] = ob;
          arg[k] = oa;
        }
      }
    }
    if (g == 0 && jl < nj) {
#pragma unroll
      for (int k = 0; k < SEG_EPT; ++k) {
        const int r = p0 + eg * SEG_EPT + k;
        if (r < ne) {
          sval[(r << jcs) + jl] = best[k];
          sarg[(r << jcs) + jl] = arg[k];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // one thread per (segment piece, j): fold the piece in edge order, four
  // edges a step
  for (int i = tid; i < ne * JC; i += blockDim.x) {
    const int r = i >> jcs, c = i & (JC - 1), s = sseg[at0 + r];
    if (c >= nj || (r > 0 && sseg[at0 + r - 1] == s)) continue;  // not a piece's first edge
    float v = sval[i];
    int ar = r, al = sarg[i], k = r + 1;  // k: one past the piece
    for (bool more = true; more;) {
      int sk[4];
      float xv[4];
      int xa[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = min(k + u, ne - 1);
        sk[u] = k + u < ne ? sseg[at0 + q] : -1;
        xv[u] = sval[(q << jcs) + c];
        xa[u] = sarg[(q << jcs) + c];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        more = more && sk[u] == s;
        if (more) {
          if (takes_max(xv[u], v)) {
            v = xv[u];
            ar = k;
            al = xa[u];
          }
          ++k;
        }
      }
    }
    const bool starts = sseg[at0 - 1] != s || r > 0, ends = k < ne || sseg[at0 + ne] != s;
    const int j = j0 + c;
    if (starts && ends) {
      const size_t o = plane + (size_t)stask[r] * P + j;
      ceft[o] = __fadd_rn(scomp[i], v);
      ptask[o] = (int32_t)ssrc[at0 + ar];
      pproc[o] = al;
    } else {
      atomicMax(&keys[((size_t)b * W + s) * P + j], pack_key(v, e0 + ar, al));
      __threadfence();
      if (c == 0) {  // a crossing piece is the tile's first or last
        cross[r == 0 ? 0 : 1] = s;
        crossr[r == 0 ? 0 : 1] = r;
      }
    }
  }
  __syncthreads();

  // the tile that arrives last at a crossing segment decodes it
  if (tid < 2) {
    const int s = cross[tid];
    decode[tid] = -1;
    if (s >= 0) {
      const bool first = sseg[at0 - 1] != s, last = sseg[at0 + ne] != s;
      const unsigned long long add = (1ull << 32) + (first ? SEG_TILE_BIG - tile : 0u) +
                                     (last ? SEG_TILE_BIG + tile : 0u);
      unsigned long long* ct = &cnt[((size_t)b * W + s) * n_jc + jc];
      const unsigned long long now = atomicAdd(ct, add) + add;
      const uint32_t lo = (uint32_t)now, hi = (uint32_t)(now >> 32);
      if (lo >= 2 * SEG_TILE_BIG && hi - 1 == lo - 2 * SEG_TILE_BIG) {
        *ct = 0ull;
        decode[tid] = s;
      }
    }
  }
  __syncthreads();
  for (int t = 0; t < 2; ++t) {
    const int s = decode[t], r = crossr[t];
    if (s < 0) continue;
    __threadfence();
    for (int c = tid; c < nj; c += blockDim.x) {
      const unsigned long long key = atomicExch(&keys[((size_t)b * W + s) * P + j0 + c], 0ull);
      const uint32_t lo = (uint32_t)key;
      const size_t o = plane + (size_t)stask[r] * P + j0 + c;
      ceft[o] = __fadd_rn(scomp[(r << jcs) + c], from_ordered_bits((uint32_t)(key >> 32)));
      ptask[o] = (int32_t)esrc[key_index(lo)];
      pproc[o] = key_class(lo);
    }
  }
}

static int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// The (B, E, P) relaxation, B, E, P >= 1, with the launch shape
// edge_relax_grid chose: G lanes a cell (a power of two up to ER_MAX_LANES
// and P, P / G even for P = 8, 16, 32, 64), JC classes a block (G * JC a
// power of two up to the block), `threads` threads (whole warps, at most
// ER_MAX_THREADS), TE edges a tile (whole passes); G = 0 takes the kernel
// that stages nothing.
extern "C" int edge_relax_f32(const void* pv, const void* pdata, const void* L,
                              const void* bw, void* minl, void* argl, int B, int E, int P,
                              int G, int JC, int threads, int TE, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (G == 0) {
    const long long n = (long long)B * E * P;
    edge_relax_global_kernel<<<(unsigned)((n + ER_MAX_THREADS - 1) / ER_MAX_THREADS),
                               ER_MAX_THREADS, 0, s>>>(
        (const float*)pv, (const float*)pdata, (const float*)L, (const float*)bw, (float*)minl,
        (int32_t*)argl, B, E, P);
    return (int)cudaGetLastError();
  }
  const bool templated = (P == 8 || P == 16 || P == 32 || P == 64) && ((uintptr_t)pv & 15) == 0;
  const int grp = G * JC;
  if (G < 1 || G > ER_MAX_LANES || G > P || (G & (G - 1)) != 0 || JC < 1 ||
      (grp & (grp - 1)) != 0 || threads > ER_MAX_THREADS || threads % 32 != 0 ||
      threads % grp != 0 || TE < 1 || TE % (threads / grp * ER_EPT) != 0 ||
      ((P == 8 || P == 16 || P == 32 || P == 64) && (P / G) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const int n_jc = (P + JC - 1) / JC, n_tiles = (E + TE - 1) / TE;
  const long long blocks = (long long)B * n_tiles * n_jc;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = ErSmem(P, G, JC, TE).total;
#define ER_LAUNCH(PT)                                                                       \
  do {                                                                                      \
    const int err = set_smem((const void*)edge_relax_kernel<PT>, smem);                     \
    if (err != 0) return err;                                                               \
    edge_relax_kernel<PT><<<(unsigned)blocks, threads, smem, s>>>(                          \
        (const float*)pv, (const float*)pdata, (const float*)L, (const float*)bw,           \
        (float*)minl, (int32_t*)argl, E, P, G, JC, n_jc, n_tiles, TE);                      \
  } while (0)
  switch (templated ? P : 0) {
    case 8: ER_LAUNCH(8); break;
    case 16: ER_LAUNCH(16); break;
    case 32: ER_LAUNCH(32); break;
    case 64: ER_LAUNCH(64); break;
    default: ER_LAUNCH(0); break;
  }
#undef ER_LAUNCH
  return (int)cudaGetLastError();
}

// One segment-layout level over the first e_real edges (e_real >= 1), with the
// launch shape seg_level_grid chose: G lanes a cell (a power of two up to 32
// and P, P / G even for P = 8, 16, 32, 64), JC classes a block (G * JC a
// power of two up to the block), `threads` threads (whole warps, at most
// SEG_MAX_THREADS), TE edges a tile before snapping (whole passes).  keys
// holds B * W * P zeros and then B * W * n_jc zeros for the counters, and is
// left zero.
extern "C" int seg_level_f32(void* ceft, void* ptask, void* pproc, const void* comp,
                             const void* L, const void* bw, const void* tasks,
                             const void* esrc, const void* edata, const void* eseg,
                             void* keys, int B, int V, int P, int W, int e_real, int G,
                             int JC, int threads, int TE, void* stream) {
  const bool templated = P == 8 || P == 16 || P == 32 || P == 64;
  const int grp = G * JC;
  if (G < 1 || G > 32 || G > P || (G & (G - 1)) != 0 || JC < 1 || (grp & (grp - 1)) != 0 ||
      threads > SEG_MAX_THREADS || threads % 32 != 0 || threads % grp != 0 || TE < 1 ||
      TE % (threads / grp * SEG_EPT) != 0 || (templated && (P / G) % 2 != 0))
    return (int)cudaErrorInvalidValue;
  const int n_jc = (P + JC - 1) / JC;
  const dim3 grid((unsigned)(((e_real + TE - 1) / TE) * n_jc), (unsigned)B);
  const size_t smem = SegSmem(P, G, JC, TE, threads / grp * SEG_EPT).total;
  unsigned long long* k = (unsigned long long*)keys;
  unsigned long long* cnt = k + (size_t)B * W * P;
  const cudaStream_t s = (cudaStream_t)stream;
#define SEG_LAUNCH(PT)                                                                     \
  do {                                                                                     \
    const int err = set_smem((const void*)seg_level_kernel<PT>, smem);                     \
    if (err != 0) return err;                                                              \
    seg_level_kernel<PT><<<grid, threads, smem, s>>>(                                      \
        (float*)ceft, (int32_t*)ptask, (int32_t*)pproc, (const float*)comp, (const float*)L, \
        (const float*)bw, (const int64_t*)tasks, (const int64_t*)esrc, (const float*)edata, \
        (const int64_t*)eseg, k, cnt, V, P, W, e_real, G, JC, n_jc, TE);                    \
  } while (0)
  switch (P) {
    case 8: SEG_LAUNCH(8); break;
    case 16: SEG_LAUNCH(16); break;
    case 32: SEG_LAUNCH(32); break;
    case 64: SEG_LAUNCH(64); break;
    default: SEG_LAUNCH(0); break;
  }
#undef SEG_LAUNCH
  return (int)cudaGetLastError();
}
