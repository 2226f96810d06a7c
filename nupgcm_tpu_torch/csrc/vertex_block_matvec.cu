// Assembled block matvec for Hopper (sm_90a): the operators of the
// iterative coarse level, the fine pressure coupling and the P1
// pressure mass,
//
//     y = sum_e P_e^T A_e P_e x,
//
// applied from their assembled form instead of their element tensors.
//
// The kernels replace nupgcm_tpu/ops/window.py::saddle_matvec (Pallas
// body _saddle_kernel) in three of its modes, each on the operators
// nupgcm_tpu/models/model.py blocks for it; the function is the same,
// only the data layout is the card's own:
//   * vblock_full_pp_kernel, vblock_up_kernel: modes "full_pp" and "up"
//     on the P1-P1 coarse saddle (_saddle_coarse_operator);
//   * vblock_uu_kernel: mode "uu" on the P1 vector velocity tensors of
//     the coarse level (its velocity block, its viscous smoother, and
//     the u-block two-grid's element coarse level);
//   * vblock_up_kernel again: mode "up" on the P2-P1 inversion
//     operator's pressure coupling (a rectangular pattern).
// and nupgcm_tpu/ops/window.py::scalar_matvec (Pallas body
// _scalar_kernel) on the P1 pressure mass Mp_e:
//   * vblock_scalar_kernel: mode "scalar", one value per vertex pair
//     (the pressure block of every block-Stokes preconditioner, fine
//     and coarse).
//
// Layout (ops/assembled.py builds it once per mesh; the model refills
// the values when the element tensors change).  Every pair (i, j) of a
// row node i and a column node j that share a cell is one block; blocks
// are sorted by row i, then column j, as in CSR: row_ptr (n_rows + 1,
// int32) and col (one int32 per block).  The rows and columns are the
// vertices (the P1 patterns) or the P2 velocity nodes against the
// vertices (the P2-P1 coupling).
//   "full_pp": a 4x4 block per pair, rows [u_x, u_y, u_z, p] of vertex i
//              against the same columns of vertex j (64 B in f32, 128 B
//              in f64); x, y = [u (3 n_rows, node-major) | p (n_rows)].
//   "up":      the 3x1 pressure-gradient column of each block, rows
//              u_x, u_y, u_z of row node i against the pressure of
//              vertex j (12 B or 24 B), contiguous per block; x = p
//              (n_cols), y = u rows (3 n_rows).
//   "uu":      a 3x3 velocity block, rows u_x, u_y, u_z of vertex i
//              against the same columns of vertex j, row-major (value
//              (r, s) at vals[9 k + 3 r + s]: 36 B or 72 B a block); x,
//              y = u (3 n_rows, node-major).
//   "scalar":  one value per block (4 B or 8 B), the scalar operator's
//              entry (i, j); x, y = p (n_rows).
// Nine values make a 36-byte block, which 16-byte vector loads cannot
// reach in place (a block starts 16-byte aligned only at every fourth
// index).  A lane reads its block with nine scalar loads instead: the 8
// lanes of a row read 288 consecutive bytes over those nine loads, so
// the sectors the first load brings are reused from L1 by the next
// eight, and the kernel streams the 36 bytes a block needs and no more.
// Padding each block to 12 values (three 16-byte loads) would stream
// 33% more bytes; nine planes of one value each (one coalesced scalar
// load a plane) would need a transposition at every fill.
//
// Bound: memory bandwidth.  Each application reads each block once and
// does 2 flops per value, far below the H100's ~20 flops/byte balance
// point against 3.35 TB/s of HBM.  At the 0.87M-DoF bowl (36,096
// vertices, 517,438 vertex blocks) "full_pp" moves 33.1 MB of f32
// values, 2.1 MB of column ids, 0.14 MB of row pointers and 1.2 MB of
// x and y: 36.5 MB, against 203.6 MB of element tensors for the
// element-local kernel (csrc/element_matvec.cu) on the same operator --
// the assembled matrix holds each node pair once where the element
// tensors hold it once per cell sharing it (about 5.5 tets a vertex).
// "uu" moves 18.6 MB of values there (114.5 MB of element tensors);
// the P2-P1 "up" about 2.2M blocks of 12 B and their column ids;
// "scalar" 2.07 MB of f32 values, 2.07 MB of column ids, 0.14 MB of row
// pointers and 0.29 MB of x and y: 4.6 MB, about 0.0014 ms at 3.35 TB/s,
// against 12.7 MB of element tensors (and their dof table) for the
// element-local kernel on the same mass.
//
// Design, for a memory-bound SpMV with small blocks:
//   * a sub-warp of kGroup = 8 lanes per row (4, 8 and 16 were timed on
//     the card: 8 the fastest at the slice's and 8b's sizes, 16 within 2%
//     of it at the 0.87M bowl's 14.3 blocks a vertex row; a P2-P1 row
//     holds about 7 blocks at an edge node, 87% of the rows, and 14 at
//     a vertex node, so 8 lanes take an edge row in one pass); a warp
//     holds 4 rows, and warps walk the rows persistently (a grid of as
//     many CTAs as fit on the SMs).  "scalar" has its own lane count,
//     kScalarGroup: a 4-byte block leaves a lane little work, and 16
//     lanes take a 14.3-block vertex row in one pass where 8 take two
//     (16 and 8 timed on the card with tools/scalar_lanes.py: 16 the
//     faster by a few percent at the slice's, 8b's and the 0.87M
//     bowl's sizes);
//   * lane l takes blocks row_ptr[i] + l, + l + 8, ... (rows longer than
//     8 loop): "full_pp" loads each whole block with 16-byte vector
//     loads, "up", "uu" and "scalar" their three, nine or one values
//     with scalar loads, so adjacent lanes read adjacent blocks and a
//     row's lanes read consecutive memory;
//   * the streamed values and column ids are each read once per
//     application: they are loaded with the evict-first (streaming)
//     cache hint (ld.global.cs), so they do not push the reused x out of
//     the caches; the x gathers (x_u[3j..3j+2], x_p[j]: 0.58 MB at the
//     0.87M bowl) go through the read-only cached path (ld.global.nc);
//   * each lane sums its blocks in column order, the group's partial
//     sums are reduced with __shfl_xor_sync in a fixed order, and lanes
//     0-3 (0-2 in "up" and "uu", 0 in "scalar") write the row's 4 (3, 1)
//     outputs once.  No atomics:
//     y is bitwise reproducible run to run, and a row with no block (a
//     periodic slave, which no cell references) is written as zero, as
//     the element path leaves it.  y needs no zero fill before a launch.
// No shared-memory staging and no TMA: each value is used by one lane
// once and the accesses already coalesce, so staging would only add a
// copy.  The sums add in another order than the element path's, so the
// two agree to rounding, not bitwise.

#include <cuda_runtime.h>

// One prepared launch, filled by ops/kernels.py (ctypes mirror
// _VbParams) and completed by nupgcm_vb_prepare.  It stays outside the
// unnamed namespace: a type of internal linkage in the C interface's
// signatures would make those functions internal, and unexported.
struct VbLaunch {
  const void* vals;     // (n_blocks, 16) "full_pp", (n_blocks, 3) "up", (n_blocks, 9) "uu",
                        // (n_blocks, 1) "scalar"
  const int* col;       // column node of each block
  const int* row_ptr;   // (n_rows + 1) block offsets of the rows
  long long n_rows;     // row nodes
  long long n_cols;     // column nodes (x's length in "up")
  int mode, f64, device;
  int grid;             // set by nupgcm_vb_prepare
  void* launcher;       // set by nupgcm_vb_prepare
};

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;      // lanes a row
constexpr int kScalarGroup = 16;  // lanes a row in "scalar"
constexpr int kNoKernel = -1;  // no instantiation for this mode

enum Mode { kFullPP = 1, kUU = 2, kUP = 3, kScalar = 4 };  // the element kernel's mode ids

template <int MODE> constexpr int group_of() { return MODE == kScalar ? kScalarGroup : kGroup; }

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int n = 2; };

template <typename T>
struct Args {
  const T* vals;
  const int* col;
  const int* row_ptr;
  const T* xu;  // "full_pp", "uu": x_u (3 n_rows); else unused
  const T* xp;  // "full_pp", "scalar": x_p (n_rows); "up": x_p (n_cols); "uu": unused
  T* yu;        // y_u (3 n_rows); "scalar": unused
  T* yp;        // "full_pp", "scalar": y_p (n_rows); else unused
  long long n_rows;
};

// The G lanes of a row: sum their partial sums (xor butterfly, a fixed
// order on every run).  Every lane of the warp calls it.
template <typename T, int N, int G = kGroup>
__device__ __forceinline__ void group_sum(T (&acc)[N]) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < N; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
}

template <typename T, int N>
__device__ __forceinline__ T pick(const T (&acc)[N], int r) {
  T v = acc[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (r == q) v = acc[q];
  return v;
}

// Rows of a warp (G lanes a row): the warp's first row advances by the
// whole grid's row count, so every lane of a warp runs the same number
// of turns (the shuffles need the whole warp) whatever the row count.
template <int G = kGroup>
struct RowWalk {
  long long first, stride;
  int sub, lane;
  __device__ RowWalk() {
    const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    first = warp * (32 / G);
    stride = (long long)gridDim.x * (kThreads / G);
    sub = (threadIdx.x & 31) / G;
    lane = threadIdx.x & (G - 1);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) vblock_full_pp_kernel(const Args<T> g) {
  using W = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;  // values per 16-byte load
  constexpr int LOADS = 16 / VN;   // 16-byte loads per 4x4 block
  const RowWalk<> w;
  for (long long base = w.first; base < g.n_rows; base += w.stride) {
    const long long row = base + w.sub;
    T acc[4] = {T(0), T(0), T(0), T(0)};
    if (row < g.n_rows) {
      const int end = __ldg(g.row_ptr + row + 1);
      for (int k = __ldg(g.row_ptr + row) + w.lane; k < end; k += kGroup) {
        const W* src = reinterpret_cast<const W*>(g.vals) + (long long)k * LOADS;
        W v[LOADS];
#pragma unroll
        for (int q = 0; q < LOADS; ++q) v[q] = __ldcs(src + q);
        const long long j = __ldcs(g.col + k);
        const T xj[4] = {__ldg(g.xu + 3 * j), __ldg(g.xu + 3 * j + 1), __ldg(g.xu + 3 * j + 2),
                         __ldg(g.xp + j)};
        const T* a = reinterpret_cast<const T*>(v);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r] += a[4 * r] * xj[0] + a[4 * r + 1] * xj[1] + a[4 * r + 2] * xj[2] +
                    a[4 * r + 3] * xj[3];
      }
    }
    group_sum<T, 4>(acc);
    if (row < g.n_rows && w.lane < 4) {
      const T out = pick(acc, w.lane);
      if (w.lane < 3)
        g.yu[3 * row + w.lane] = out;
      else
        g.yp[row] = out;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vblock_up_kernel(const Args<T> g) {
  const RowWalk<> w;
  for (long long base = w.first; base < g.n_rows; base += w.stride) {
    const long long row = base + w.sub;
    T acc[3] = {T(0), T(0), T(0)};
    if (row < g.n_rows) {
      const int end = __ldg(g.row_ptr + row + 1);
      for (int k = __ldg(g.row_ptr + row) + w.lane; k < end; k += kGroup) {
        const T* src = g.vals + 3LL * k;
        const T v0 = __ldcs(src), v1 = __ldcs(src + 1), v2 = __ldcs(src + 2);
        const T xj = __ldg(g.xp + __ldcs(g.col + k));
        acc[0] += v0 * xj;
        acc[1] += v1 * xj;
        acc[2] += v2 * xj;
      }
    }
    group_sum<T, 3>(acc);
    if (row < g.n_rows && w.lane < 3) g.yu[3 * row + w.lane] = pick(acc, w.lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vblock_uu_kernel(const Args<T> g) {
  const RowWalk<> w;
  for (long long base = w.first; base < g.n_rows; base += w.stride) {
    const long long row = base + w.sub;
    T acc[3] = {T(0), T(0), T(0)};
    if (row < g.n_rows) {
      const int end = __ldg(g.row_ptr + row + 1);
      for (int k = __ldg(g.row_ptr + row) + w.lane; k < end; k += kGroup) {
        const T* src = g.vals + 9LL * k;
        T a[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) a[q] = __ldcs(src + q);
        const long long j = __ldcs(g.col + k);
        const T x0 = __ldg(g.xu + 3 * j), x1 = __ldg(g.xu + 3 * j + 1),
                x2 = __ldg(g.xu + 3 * j + 2);
#pragma unroll
        for (int r = 0; r < 3; ++r) acc[r] += a[3 * r] * x0 + a[3 * r + 1] * x1 + a[3 * r + 2] * x2;
      }
    }
    group_sum<T, 3>(acc);
    if (row < g.n_rows && w.lane < 3) g.yu[3 * row + w.lane] = pick(acc, w.lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vblock_scalar_kernel(const Args<T> g) {
  constexpr int G = kScalarGroup;
  const RowWalk<G> w;
  for (long long base = w.first; base < g.n_rows; base += w.stride) {
    const long long row = base + w.sub;
    T acc[1] = {T(0)};
    if (row < g.n_rows) {
      const int end = __ldg(g.row_ptr + row + 1);
      for (int k = __ldg(g.row_ptr + row) + w.lane; k < end; k += G)
        acc[0] += __ldcs(g.vals + k) * __ldg(g.xp + __ldcs(g.col + k));
    }
    group_sum<T, 1, G>(acc);
    if (row < g.n_rows && w.lane == 0) g.yp[row] = acc[0];
  }
}

// ---------------------------------------------------------------------
// host side: preparation and launch
// ---------------------------------------------------------------------

template <typename T, int MODE>
int launch(const VbLaunch* p, const void* x, void* y, cudaStream_t stream) {
  Args<T> g;
  g.vals = (const T*)p->vals;
  g.col = p->col;
  g.row_ptr = p->row_ptr;
  g.n_rows = p->n_rows;
  const T* xt = (const T*)x;
  T* yt = (T*)y;
  g.xu = MODE == kFullPP || MODE == kUU ? xt : nullptr;
  g.xp = MODE == kFullPP ? xt + 3 * p->n_rows : MODE == kUU ? nullptr : xt;
  g.yu = MODE == kScalar ? nullptr : yt;
  g.yp = MODE == kFullPP ? yt + 3 * p->n_rows : MODE == kScalar ? yt : nullptr;
  if (MODE == kFullPP)
    vblock_full_pp_kernel<T><<<p->grid, kThreads, 0, stream>>>(g);
  else if (MODE == kUU)
    vblock_uu_kernel<T><<<p->grid, kThreads, 0, stream>>>(g);
  else if (MODE == kUP)
    vblock_up_kernel<T><<<p->grid, kThreads, 0, stream>>>(g);
  else
    vblock_scalar_kernel<T><<<p->grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int prepare_mode(VbLaunch* p) {
  auto kernel = MODE == kFullPP ? (const void*)vblock_full_pp_kernel<T>
                : MODE == kUU  ? (const void*)vblock_uu_kernel<T>
                : MODE == kUP  ? (const void*)vblock_up_kernel<T>
                               : (const void*)vblock_scalar_kernel<T>;
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return (int)cudaErrorInvalidConfiguration;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, p->device);
  if (err != cudaSuccess) return (int)err;
  const long long need = (p->n_rows * group_of<MODE>() + kThreads - 1) / kThreads;
  const long long fit = (long long)per_sm * sms;
  p->grid = (int)(need < fit ? need : fit);
  p->launcher = (void*)&launch<T, MODE>;
  return 0;
}

template <typename T>
int prepare_dtype(VbLaunch* p) {
  if (p->mode == kFullPP) return prepare_mode<T, kFullPP>(p);
  if (p->mode == kUU) return prepare_mode<T, kUU>(p);
  if (p->mode == kUP) return prepare_mode<T, kUP>(p);
  if (p->mode == kScalar) return prepare_mode<T, kScalar>(p);
  return kNoKernel;
}

using Launcher = int (*)(const VbLaunch*, const void*, void*, cudaStream_t);

}  // namespace

// Plain C interface (loaded with ctypes by ops/build.py); errors are
// named by nupgcm_error_string (csrc/element_matvec.cu).

extern "C" {

// Pick the instantiation for p's dtype and mode and size the persistent
// grid; fills p->grid and p->launcher.  Returns 0, a cudaError_t, or -1
// when no instantiation has this mode.
// Runs once per prepared shape, on p->device.
int nupgcm_vb_prepare(VbLaunch* p) {
  return p->f64 ? prepare_dtype<double>(p) : prepare_dtype<float>(p);
}

// y = A x for a prepared launch, on the given stream.  Every entry of y
// is written (rows without blocks as zero).  Returns cudaGetLastError().
int nupgcm_vb_apply(const VbLaunch* p, const void* x, void* y, void* stream) {
  if (p->n_rows == 0) return 0;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != p->device && (err = cudaSetDevice(p->device)) != cudaSuccess) return (int)err;
  const int rc = ((Launcher)p->launcher)(p, x, y, (cudaStream_t)stream);
  if (cur != p->device) cudaSetDevice(cur);
  return rc;
}

}  // extern "C"
