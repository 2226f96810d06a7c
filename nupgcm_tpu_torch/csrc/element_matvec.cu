// Element-local matvec kernels for Hopper (sm_90a):
//
//     y = sum_e P_e^T A_e P_e x
//
// over the canonical element tensors (nc, rows, cols) with the
// node-major velocity layout dof = ncomp*node + comp.
//
// block_matvec_kernel replaces nupgcm_tpu/ops/window.py::saddle_matvec
// (Pallas body _saddle_kernel) in all four of its modes, and, as the
// "uu" pattern with one component, window.py::scalar_matvec (Pallas
// body _scalar_kernel).  Its pinned instantiation replaces the
// "compute" variant of tools/profile_matvec.py:200-216 (a BlockSpec
// that pins every grid step to block 0's tensors): cell c reads the
// tensors of cell c mod 128 (the tensors hold the first min(nc, 128)
// cells) and its own dof tables, so the tensors stay in cache and the
// time left is compute, gathers and scatters.
//
// Bound: memory bandwidth.  Every application streams each element
// tensor once -- 1,140 values (4.5 KB in f32) per P2-P1 tet for mode
// "full" -- at 2 flops per value, far below the H100's ~20 flops/byte
// balance point against 3.35 TB/s of HBM.  The gathered x and the
// scattered y are a few values per cell and stay in L2.
//
// Design.  Cells are cut into blocks of B contiguous cells (in the RCM
// order of models/fedata.py, so a block's cells share most of their
// nodes).  ops/blocks.py builds, once per dof table and B, each block's
// sorted list of unique dofs (at a fixed stride, after a header with
// its count) and each (cell, local slot)'s index into that list: the
// port's counterpart of the TPU kernel's per-block dof window (w0, W1).
// One CTA of 256 threads walks blocks persistently (a grid of as many
// CTAs as fit on the SMs) through two stages of shared memory:
//   1. thread 0 streams the next block's slice of every tensor the mode
//      reads, its dof lists and its slot tables into the free stage
//      with one bulk asynchronous copy each (cp.async.bulk global ->
//      shared, completion counted in bytes on the stage's mbarrier);
//      every address follows from the block index, so the copies are
//      issued a block ahead with no device-memory read first;
//   2. on the current stage, the threads gather each unique x value of
//      the block once into a shared x tile (the one device-memory load
//      of the chain) and expand it to each cell's x in element order;
//   3. one thread per (cell, element row) -- velocity rows, then
//      pressure rows -- takes the dot product of the row with its cell's
//      x, both in shared memory with vector loads, and adds it into a
//      shared y tile with a shared-memory atomic;
//   4. the y tile goes to global y with one atomic per unique dof and is
//      left zero for the next block.
// Against one thread per (cell, row) reading its row from device memory
// and re-gathering its cell's x (the first port), a P2-P1 "full" cell
// now costs a few gathers and atomics instead of ~2,300 gathers and 34
// atomics.  y must arrive zeroed: each launch zeroes, beside its work,
// the buffer its caller passes as y next time (ops/kernels.py), so no
// separate zero fill runs per application.  Local sizes are
// compile-time: P2-P1 and P1-P1 tets (10/4, 4/4), P2-P1 and P1-P1
// triangles (6/3, 3/3), and scalar spaces with 10, 6, 4 or 3 nodes;
// anything else is refused at preparation.  Padded cells carry zero
// tensors and add exact zeros.  The atomics sum in a different order on
// every run, so results agree with a sequential sum only to rounding.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// One prepared launch, filled by ops/kernels.py (ctypes mirror
// _LaunchParams) and completed by nupgcm_em_prepare.
struct EmLaunch {
  const void* a[4];      // uu, up, pu, pp element tensors (null where unused)
  const short* slot_u;   // per block, each cell's nodes' indices into its list
  const short* slot_p;
  const int* lists_u;    // per block: count, 0, 0, 0, sorted unique dofs, padding
  const int* lists_p;
  long long nc;          // cells
  long long n_tensor;    // cells the tensors hold (pinned: min(nc, 128))
  long long u_len;       // length of the velocity part of x and y
  long long y_len;       // length of y
  int nblk, cells;       // blocks, cells per block
  int ls_u, ls_p;        // list entries per block (multiples of 4)
  int sp_u, sp_p;        // slot entries per block (multiples of 8)
  int mode, nlu, nlp, f64, pinned, device;
  int grid, smem;        // set by nupgcm_em_prepare
  void* launcher;        // set by nupgcm_em_prepare
};

namespace {

constexpr int kThreads = 256;
constexpr long long kPinCells = 128;  // one TPU grid block of cells
constexpr int kHeader = 4;            // list entries before a block's dofs
constexpr int kNoKernel = -1;         // no instantiation for these sizes
constexpr int kTooLarge = -2;         // a block does not fit in shared memory

enum Mode { kFull = 0, kFullPP = 1, kUU = 2, kUP = 3, kScalar = 4 };

// ---------------------------------------------------------------------
// PTX wrappers: mbarrier and the 1-D bulk asynchronous copy (TMA)
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A copy that never completes (a fault) traps after ~10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__host__ __device__ constexpr size_t round16(size_t b) { return (b + 15) & ~size_t(15); }

// ---------------------------------------------------------------------
// compile-time shape of one instantiation
// ---------------------------------------------------------------------

// MODE in {kFull, kFullPP, kUU, kUP}; NC components per velocity node
// (3; 1 for a scalar space, which runs as kUU); NLU velocity nodes and
// NLP pressure dofs per cell.
template <typename T, int MODE, int NC, int NLU, int NLP>
struct Shape {
  static constexpr int NU = NC * NLU;  // velocity columns per cell
  static constexpr bool UU = MODE == kFull || MODE == kFullPP || MODE == kUU;
  static constexpr bool UP = MODE != kUU;
  static constexpr bool PU = MODE == kFull || MODE == kFullPP;
  static constexpr bool PP = MODE == kFullPP;
  static constexpr bool GU = MODE != kUP;  // gathers velocity x
  static constexpr bool GP = MODE != kUU;  // gathers pressure x
  static constexpr bool SP = PU;           // scatters pressure y
  // values per cell of tensor t (0 where the mode does not read it)
  __host__ __device__ static constexpr int vals(int t) {
    return t == 0 ? (UU ? NU * NU : 0)
         : t == 1 ? (UP ? NU * NLP : 0)
         : t == 2 ? (PU ? NLP * NU : 0)
                  : (PP ? NLP * NLP : 0);
  }
  __host__ __device__ static constexpr int before(int t) {
    return t == 0 ? 0 : before(t - 1) + vals(t - 1);
  }
  static constexpr int CELL_VALS = before(4);
};

// Byte offsets of the shared-memory regions: four mbarriers (32 B), two
// stages (the block's tensor slices, dof lists and slot tables, all
// streamed in), the y tiles, the x tiles (one value per unique dof) and
// the cells' expanded x (each cell's x in element order).
template <class S, typename T, int NC, int NLU, int NLP>
struct Layout {
  static constexpr int XU = (NC * NLU + 3) & ~3;  // expanded x per cell, padded
  static constexpr int XP = (NLP + 3) & ~3;
  size_t tens, ul_u, ul_p, sl_u, sl_p, stride, ys_u, ys_p, xs_u, xs_p, xe_u, xe_p, total;
  __host__ __device__ Layout(int cells, int ls_u, int ls_p, int sp_u, int sp_p) {
    const bool lp = S::GP || S::SP;
    const size_t max_u = ls_u - kHeader, max_p = lp ? ls_p - kHeader : 0;
    size_t o = 0;
    tens = o;
    o += round16((size_t)cells * S::CELL_VALS * sizeof(T));
    ul_u = o;
    o += round16((size_t)ls_u * sizeof(int));
    ul_p = o;
    o += round16(lp ? (size_t)ls_p * sizeof(int) : 0);
    sl_u = o;
    o += round16((size_t)sp_u * sizeof(short));
    sl_p = o;
    o += round16(lp ? (size_t)sp_p * sizeof(short) : 0);
    stride = o;
    o = 32 + 2 * stride;
    ys_u = o;
    o += round16(max_u * NC * sizeof(T));
    ys_p = o;
    o += round16(S::SP ? max_p * sizeof(T) : 0);
    xs_u = o;
    o += round16(S::GU ? max_u * NC * sizeof(T) : 0);
    xs_p = o;
    o += round16(S::GP ? max_p * sizeof(T) : 0);
    xe_u = o;
    o += round16(S::GU ? (size_t)cells * XU * sizeof(T) : 0);
    xe_p = o;
    o += round16(S::GP ? (size_t)cells * XP * sizeof(T) : 0);
    total = o;
  }
};

template <typename T>
struct Args {
  const T* a[4];
  const short* slot_u;
  const short* slot_p;
  const int* lists_u;
  const int* lists_p;
  const T* xu;
  const T* xp;
  T* yu;
  T* yp;
  T* y_next;  // zeroed here for the caller's next call (may be null)
  long long nc, n_tensor, y_len;
  int nblk, cells, ls_u, ls_p, sp_u, sp_p;
};

// A block's cells [c0, c0 + n) of one tensor as at most two runs of
// tensor cells (the pinned tensors wrap at n_tensor).
struct Runs {
  long long src[2];
  int n[2];
};

template <bool PIN>
__device__ __forceinline__ Runs cell_runs(long long c0, int n, long long n_tensor) {
  Runs r;
  r.src[0] = PIN ? c0 % kPinCells : c0;
  r.src[1] = 0;
  const long long room = PIN ? n_tensor - r.src[0] : n;
  r.n[0] = n < room ? n : (int)room;
  r.n[1] = n - r.n[0];
  return r;
}

__device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// Thread 0: arm the stage's two mbarriers with the bytes to come and
// issue the bulk copies of the block's dof lists and slot tables (on
// bar_l, first, so that the gather can start early) and of its tensor
// slices (on bar_t); every address follows from the block index alone.
// A tensor slice whose length is not a multiple of 16 bytes (the last
// block of a triangle mesh) leaves its last < 16 bytes to copy_tails.
template <class S, typename T, int NLU, int NLP, bool PIN, class Lay>
__device__ __forceinline__ void issue_block(const Args<T>& g, int blk, unsigned char* st,
                                            const Lay& L, uint32_t bar_l, uint32_t bar_t) {
  const long long c0 = (long long)blk * g.cells;
  const int n = (int)(g.nc - c0 < g.cells ? g.nc - c0 : g.cells);
  const Runs r = cell_runs<PIN>(c0, n, g.n_tensor);
  const bool lp = S::GP || S::SP;
  uint32_t lbytes = (uint32_t)(g.ls_u * sizeof(int) + round8(n * NLU) * sizeof(short));
  if (lp) lbytes += (uint32_t)(g.ls_p * sizeof(int) + round8(n * NLP) * sizeof(short));
  mbar_expect_tx(bar_l, lbytes);
  bulk_g2s(smem_u32(st + L.ul_u), g.lists_u + (long long)blk * g.ls_u, g.ls_u * sizeof(int),
           bar_l);
  bulk_g2s(smem_u32(st + L.sl_u), g.slot_u + (long long)blk * g.sp_u,
           round8(n * NLU) * sizeof(short), bar_l);
  if (lp) {
    bulk_g2s(smem_u32(st + L.ul_p), g.lists_p + (long long)blk * g.ls_p,
             g.ls_p * sizeof(int), bar_l);
    bulk_g2s(smem_u32(st + L.sl_p), g.slot_p + (long long)blk * g.sp_p,
             round8(n * NLP) * sizeof(short), bar_l);
  }
  uint32_t bytes = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (S::vals(t) == 0) continue;
    for (int k = 0; k < 2; ++k)
      bytes += (uint32_t)(((size_t)r.n[k] * S::vals(t) * sizeof(T)) & ~size_t(15));
  }
  mbar_expect_tx(bar_t, bytes);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (S::vals(t) == 0) continue;
    unsigned char* dst = st + L.tens + (size_t)g.cells * S::before(t) * sizeof(T);
    for (int k = 0; k < 2; ++k) {
      const size_t len = (size_t)r.n[k] * S::vals(t) * sizeof(T);
      const size_t tma = len & ~size_t(15);
      if (tma) bulk_g2s(smem_u32(dst), g.a[t] + r.src[k] * S::vals(t), (uint32_t)tma, bar_t);
      dst += len;
    }
  }
}

// All threads: the < 16-byte tensor tails issue_block left out.
template <class S, typename T, bool PIN>
__device__ __forceinline__ void copy_tails(const Args<T>& g, int blk, unsigned char* tens) {
  const long long c0 = (long long)blk * g.cells;
  const int n = (int)(g.nc - c0 < g.cells ? g.nc - c0 : g.cells);
  const Runs r = cell_runs<PIN>(c0, n, g.n_tensor);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (S::vals(t) == 0) continue;
    T* dst = (T*)(tens + (size_t)g.cells * S::before(t) * sizeof(T));
    for (int k = 0; k < 2; ++k) {
      const int len = r.n[k] * S::vals(t);
      const int tma = (int)((((size_t)len * sizeof(T)) & ~size_t(15)) / sizeof(T));
      const T* src = g.a[t] + r.src[k] * S::vals(t);
      for (int i = tma + threadIdx.x; i < len; i += kThreads) dst[i] = src[i];
      dst += len;
    }
  }
}

// Vector of V values for 16-, 8- or 4-byte shared-memory loads.
template <typename T, int V> struct Vec { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<double, 2> { using type = double2; };

// Widest vector (at most 16 bytes) that divides a row of LEN values.
template <typename T, int LEN>
__host__ __device__ constexpr int vec_width() {
  return (sizeof(T) == 4 && LEN % 4 == 0) ? 4 : (LEN % 2 == 0 && sizeof(T) * 2 <= 16) ? 2 : 1;
}

// Row a[0 : LEN] against the cell's expanded x (both in shared memory,
// both aligned to the vector width), summed in column order.
template <typename T, int LEN>
__device__ __forceinline__ T dot(const T* __restrict__ a, const T* __restrict__ x) {
  constexpr int V = vec_width<T, LEN>();
  using W = typename Vec<T, V>::type;
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < LEN; k += V) {
    const W av = *reinterpret_cast<const W*>(a + k);
    const W xv = *reinterpret_cast<const W*>(x + k);
    const T* ap = reinterpret_cast<const T*>(&av);
    const T* xp = reinterpret_cast<const T*>(&xv);
#pragma unroll
    for (int q = 0; q < V; ++q) acc += ap[q] * xp[q];
  }
  return acc;
}

template <typename T, int MODE, int NC, int NLU, int NLP, bool PIN>
__global__ void __launch_bounds__(kThreads) block_matvec_kernel(const Args<T> g) {
  using S = Shape<T, MODE, NC, NLU, NLP>;
  constexpr int NU = S::NU;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<S, T, NC, NLU, NLP> L(g.cells, g.ls_u, g.ls_p, g.sp_u, g.sp_p);
  unsigned char* const stage0 = smem + 32;  // stage s at stage0 + s * L.stride
  const uint32_t bar_l = smem_u32(smem);    // stage s: lists at bar_l + 8 s,
  const uint32_t bar_t = bar_l + 16;        // tensors at bar_t + 8 s
  T* ys_u = (T*)(smem + L.ys_u);
  T* ys_p = (T*)(smem + L.ys_p);
  T* xs_u = (T*)(smem + L.xs_u);
  T* xs_p = (T*)(smem + L.xs_p);
  T* xe_u = (T*)(smem + L.xe_u);
  T* xe_p = (T*)(smem + L.xe_p);
  constexpr int XU = Layout<S, T, NC, NLU, NLP>::XU, XP = Layout<S, T, NC, NLU, NLP>::XP;
  const int tid = threadIdx.x;

  for (int i = tid; i < (g.ls_u - kHeader) * NC; i += kThreads) ys_u[i] = T(0);
  if (S::SP)
    for (int i = tid; i < g.ls_p - kHeader; i += kThreads) ys_p[i] = T(0);
  int blk = blockIdx.x;
  if (tid == 0) {
    for (int b = 0; b < 4; ++b) mbar_init(bar_l + 8 * b, 1);
    fence_barrier_init();
    if (blk < g.nblk) issue_block<S, T, NLU, NLP, PIN>(g, blk, stage0, L, bar_l, bar_t);
  }
  // zero the next call's y (the caller's spare) while the copies fly
  if (g.y_next)
    for (long long i = (long long)blockIdx.x * kThreads + tid; i < g.y_len;
         i += (long long)gridDim.x * kThreads)
      g.y_next[i] = T(0);
  __syncthreads();

  for (int it = 0; blk < g.nblk; ++it, blk += gridDim.x) {
    const int s = it & 1;
    unsigned char* st = stage0 + s * L.stride;
    const int next = blk + gridDim.x;
    if (tid == 0 && next < g.nblk)
      issue_block<S, T, NLU, NLP, PIN>(g, next, stage0 + (s ^ 1) * L.stride, L,
                                       bar_l + 8 * (s ^ 1), bar_t + 8 * (s ^ 1));
    copy_tails<S, T, PIN>(g, blk, st + L.tens);
    const uint32_t parity = (uint32_t)((it >> 1) & 1);
    mbar_wait(bar_l + 8 * s, parity);

    // gather each unique x of the block once (the one device-memory
    // load of the chain)
    const long long c0 = (long long)blk * g.cells;
    const int n = (int)(g.nc - c0 < g.cells ? g.nc - c0 : g.cells);
    const int* ul_u = (const int*)(st + L.ul_u);
    const int* ul_p = (const int*)(st + L.ul_p);
    const int nu = ul_u[0], np = (S::GP || S::SP) ? ul_p[0] : 0;
    ul_u += kHeader;
    ul_p += kHeader;
    if (S::GU)
      for (int i = tid; i < nu * NC; i += kThreads)
        xs_u[i] = g.xu[(long long)NC * ul_u[i / NC] + i % NC];
    if (S::GP)
      for (int i = tid; i < np; i += kThreads) xs_p[i] = g.xp[ul_p[i]];
    __syncthreads();

    // each cell's x in element order, so that rows read it contiguously
    const short* sl_u = (const short*)(st + L.sl_u);
    const short* sl_p = (const short*)(st + L.sl_p);
    if (S::GU)
      for (int i = tid; i < n * NLU; i += kThreads) {
        const int c = i / NLU, j = i - c * NLU;
        const T* xn = xs_u + NC * sl_u[i];
#pragma unroll
        for (int q = 0; q < NC; ++q) xe_u[c * XU + NC * j + q] = xn[q];
      }
    if (S::GP)
      for (int i = tid; i < n * NLP; i += kThreads) {
        const int c = i / (NLP ? NLP : 1);
        xe_p[c * XP + i - c * NLP] = xs_p[sl_p[i]];
      }
    mbar_wait(bar_t + 8 * s, parity);
    __syncthreads();

    // one thread per (cell, row), rows from shared memory: velocity rows,
    // then pressure rows (two loops, so that no warp runs both kinds)
    const T* tens = (const T*)(st + L.tens);
    const T* a_uu = tens;
    const T* a_up = tens + (size_t)g.cells * S::before(1);
    const T* a_pu = tens + (size_t)g.cells * S::before(2);
    const T* a_pp = tens + (size_t)g.cells * S::before(3);
    for (int t = tid; t < n * NU; t += kThreads) {
      const int c = t / NU;
      const int r = t - c * NU;
      T acc = T(0);
      if (S::UU) acc += dot<T, NU>(a_uu + (size_t)t * NU, xe_u + c * XU);
      if (S::UP) acc += dot<T, NLP>(a_up + (size_t)t * NLP, xe_p + c * XP);
      atomicAdd(ys_u + NC * sl_u[c * NLU + r / NC] + r % NC, acc);
    }
    if (S::SP)
      for (int t = tid; t < n * NLP; t += kThreads) {
        const int c = t / (NLP ? NLP : 1);
        T acc = dot<T, NU>(a_pu + (size_t)t * NU, xe_u + c * XU);
        if (S::PP) acc += dot<T, NLP>(a_pp + (size_t)t * NLP, xe_p + c * XP);
        atomicAdd(ys_p + sl_p[t], acc);
      }
    __syncthreads();

    // one global atomic per unique dof of the block; the tile is left zero
    for (int i = tid; i < nu * NC; i += kThreads) {
      atomicAdd(g.yu + (long long)NC * ul_u[i / NC] + i % NC, ys_u[i]);
      ys_u[i] = T(0);
    }
    if (S::SP)
      for (int i = tid; i < np; i += kThreads) {
        atomicAdd(g.yp + ul_p[i], ys_p[i]);
        ys_p[i] = T(0);
      }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// host side: preparation and launch
// ---------------------------------------------------------------------

template <typename T, int MODE, int NC, int NLU, int NLP, bool PIN>
int launch(const EmLaunch* p, const void* x, void* y, void* y_next, cudaStream_t stream) {
  Args<T> g;
  for (int t = 0; t < 4; ++t) g.a[t] = (const T*)p->a[t];
  g.slot_u = p->slot_u;
  g.slot_p = p->slot_p;
  g.lists_u = p->lists_u;
  g.lists_p = p->lists_p;
  const T* xt = (const T*)x;
  T* yt = (T*)y;
  g.xu = MODE == kUP ? nullptr : xt;
  g.xp = MODE == kUP ? xt : (MODE == kUU ? nullptr : xt + p->u_len);
  g.yu = yt;
  g.yp = (MODE == kFull || MODE == kFullPP) ? yt + p->u_len : nullptr;
  g.y_next = (T*)y_next;
  g.nc = p->nc;
  g.n_tensor = p->n_tensor;
  g.y_len = p->y_len;
  g.nblk = p->nblk;
  g.cells = p->cells;
  g.ls_u = p->ls_u;
  g.ls_p = p->ls_p;
  g.sp_u = p->sp_u;
  g.sp_p = p->sp_p;
  block_matvec_kernel<T, MODE, NC, NLU, NLP, PIN><<<p->grid, kThreads, p->smem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int NC, int NLU, int NLP, bool PIN>
int prepare_t(EmLaunch* p) {
  using S = Shape<T, MODE, NC, NLU, NLP>;
  const Layout<S, T, NC, NLU, NLP> L(p->cells, p->ls_u, p->ls_p, p->sp_u, p->sp_p);
  auto kernel = block_matvec_kernel<T, MODE, NC, NLU, NLP, PIN>;
  p->smem = (int)L.total;
  int optin = 0, per_sm = 0, sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, p->device);
  if (err != cudaSuccess) return (int)err;
  if (L.total > (size_t)optin) return kTooLarge;
  // the limit, not this launch's size: launches prepared earlier with
  // more shared memory stay valid
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p->smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;  // does not fit an SM
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, p->device);
  if (err != cudaSuccess) return (int)err;
  const long long fit = (long long)per_sm * sms;
  p->grid = (int)(p->nblk < fit ? p->nblk : fit);
  p->launcher = (void*)&launch<T, MODE, NC, NLU, NLP, PIN>;
  return 0;
}

template <typename T, int NLU, int NLP>
int prepare_pair(EmLaunch* p) {
  switch (p->mode) {
    case kFull: return prepare_t<T, kFull, 3, NLU, NLP, false>(p);
    case kFullPP: return prepare_t<T, kFullPP, 3, NLU, NLP, false>(p);
    case kUP: return prepare_t<T, kUP, 3, NLU, NLP, false>(p);
  }
  return kNoKernel;
}

template <typename T, int NC, int NL>
int prepare_uu(EmLaunch* p) {
  return prepare_t<T, kUU, NC, NL, 0, false>(p);
}

template <typename T>
int prepare_dtype(EmLaunch* p) {
  const int u = p->nlu, q = p->nlp;
  if (p->pinned)
    return (p->mode == kFull && u == 10 && q == 4) ? prepare_t<T, kFull, 3, 10, 4, true>(p)
                                                   : kNoKernel;
  if (p->mode == kUU || p->mode == kScalar) {
    const bool scalar = p->mode == kScalar;
    switch (u) {
      case 10: return scalar ? prepare_uu<T, 1, 10>(p) : prepare_uu<T, 3, 10>(p);
      case 6: return scalar ? prepare_uu<T, 1, 6>(p) : prepare_uu<T, 3, 6>(p);
      case 4: return scalar ? prepare_uu<T, 1, 4>(p) : prepare_uu<T, 3, 4>(p);
      case 3: return scalar ? prepare_uu<T, 1, 3>(p) : prepare_uu<T, 3, 3>(p);
    }
    return kNoKernel;
  }
  if (u == 10 && q == 4) return prepare_pair<T, 10, 4>(p);
  if (u == 4 && q == 4) return prepare_pair<T, 4, 4>(p);
  if (u == 6 && q == 3) return prepare_pair<T, 6, 3>(p);
  if (u == 3 && q == 3) return prepare_pair<T, 3, 3>(p);
  return kNoKernel;
}

using Launcher = int (*)(const EmLaunch*, const void*, void*, void*, cudaStream_t);

}  // namespace

// Plain C interface (loaded with ctypes by ops/build.py).

extern "C" {

// Pick the instantiation for p's dtype, mode and local sizes, set its
// shared-memory limit and size the persistent grid; fills p->smem,
// p->grid and p->launcher.  Returns 0, a cudaError_t, -1 when no
// instantiation has these sizes or -2 when a block needs more shared
// memory than a CTA may have.  Runs once per prepared launch, on
// p->device.
int nupgcm_em_prepare(EmLaunch* p) {
  return p->f64 ? prepare_dtype<double>(p) : prepare_dtype<float>(p);
}

// y = A x for a prepared launch, on the given stream.  y must hold
// zeros; the kernel also zeroes y_next (when not null, y_len entries),
// the buffer the caller passes as y next time, so that no separate
// zero fill runs per call.  Returns cudaGetLastError().
int nupgcm_em_apply(const EmLaunch* p, const void* x, void* y, void* y_next, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != p->device && (err = cudaSetDevice(p->device)) != cudaSuccess) return (int)err;
  int rc;
  if (p->nblk > 0)
    rc = ((Launcher)p->launcher)(p, x, y, y_next, s);
  else
    rc = y_next ? (int)cudaMemsetAsync(y_next, 0, (size_t)p->y_len * (p->f64 ? 8 : 4), s) : 0;
  if (cur != p->device) cudaSetDevice(cur);
  return rc;
}

const char* nupgcm_error_string(int err) {
  if (err == kNoKernel) return "no kernel instantiation for these local sizes";
  if (err == kTooLarge) return "a block of cells does not fit in shared memory";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
