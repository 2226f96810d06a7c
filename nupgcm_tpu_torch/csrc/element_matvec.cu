// Element-local matvec kernels for Hopper (sm_90a):
//
//     y = sum_e P_e^T A_e P_e x
//
// over the canonical element tensors (nc, rows, cols) and the cell dof
// tables cd (nc, nl) int32 that ops/element.py also uses, with the
// node-major velocity layout dof = 3*node + comp.
//
// saddle_kernel replaces nupgcm_tpu/ops/window.py::saddle_matvec
// (Pallas body _saddle_kernel) in all four of its modes; scalar_kernel
// replaces window.py::scalar_matvec (Pallas body _scalar_kernel).
//
// Bound: memory bandwidth.  Each application streams every element
// tensor once (for the P2-P1 tet saddle operator 1140 values, about
// 4.5 KB of f32, per cell) and does 2 flops per value, far below the
// H100's ~20 flops/byte balance point against 3.35 TB/s of HBM.  The
// gathered x and scattered y are small next to the tensors and stay
// in L2.
//
// Design: one thread per (cell, element row).  A thread reads its row
// of A_e contiguously, gathers the x entries of its cell, forms the
// dot product in registers and atomicAdds it into y; the caller zeroes
// y.  Neighbouring threads read neighbouring rows, so a warp streams a
// contiguous stretch of the tensor, and a cell's tensor lands in L1
// once for all its rows.  One thread per cell would run only a few
// hundred threads per SM at production mesh sizes (2.3e4 cells at
// h = 0.08); one per row gives 34x more.  Cells are sorted by their
// smallest RCM velocity node (models/fedata.py), so the gathers and
// atomics of a block hit a narrow dof window.  Padded cells carry
// zero tensors and add exact zeros.  The atomics sum in a different
// order on every run, so results agree with a sequential sum only to
// rounding.
//
// Pinned probe (saddle_kernel<T, true>): every cell c reads the tensors
// of cell c mod 128 (tensors are given for the first min(nc, 128) cells
// only) while its gathers and scatters use its own dof tables.  It
// replaces the "compute" variant of tools/profile_matvec.py:200-216,
// where a patched BlockSpec pins every grid step to block 0's tensors:
// the tensors then stay in cache and the time left is compute, gathers
// and atomics.  The production instantiation (Pinned = false) compiles
// to the same code as before the flag existed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPinCells = 128;  // one TPU grid block of cells

enum Mode { kFull = 0, kFullPP = 1, kUU = 2, kUP = 3 };

// Dot product of one velocity-column row a[0 : 3*nlu] with the
// gathered node-major velocity x_e.
template <typename T>
__device__ __forceinline__ T dot_u(const T* __restrict__ a,
                                   const int* __restrict__ cu, int nlu,
                                   const T* __restrict__ xu) {
  T acc = T(0);
  for (int j = 0; j < nlu; ++j) {
    const T* xn = xu + 3LL * cu[j];
    acc += a[3 * j] * xn[0];
    acc += a[3 * j + 1] * xn[1];
    acc += a[3 * j + 2] * xn[2];
  }
  return acc;
}

// Dot product of one pressure-column row a[0 : nlp] with the gathered
// pressure x_e.
template <typename T>
__device__ __forceinline__ T dot_p(const T* __restrict__ a,
                                   const int* __restrict__ cp, int nlp,
                                   const T* __restrict__ xp) {
  T acc = T(0);
  for (int k = 0; k < nlp; ++k) acc += a[k] * xp[cp[k]];
  return acc;
}

// Saddle operator [uu up; pu pp] over (velocity, pressure):
//   kFull   y = [uu up; pu 0] x      (rows: 3*nlu + nlp per cell)
//   kFullPP y = [uu up; pu pp] x     (rows: 3*nlu + nlp per cell)
//   kUU     yu = uu xu               (rows: 3*nlu per cell)
//   kUP     yu = up xp               (rows: 3*nlu per cell)
template <typename T, bool Pinned>
__global__ void __launch_bounds__(kThreads)
saddle_kernel(const T* __restrict__ uu, const T* __restrict__ up,
              const T* __restrict__ pu, const T* __restrict__ pp,
              const int* __restrict__ cd_u, const int* __restrict__ cd_p,
              const T* __restrict__ xu, const T* __restrict__ xp,
              T* __restrict__ yu, T* __restrict__ yp,
              long long nc, int nlu, int nlp, int mode) {
  const int nlu3 = 3 * nlu;
  const int rows = (mode == kFull || mode == kFullPP) ? nlu3 + nlp : nlu3;
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= nc * rows) return;
  const long long c = t / rows;
  const int r = (int)(t - c * rows);
  const long long ct = Pinned ? c % kPinCells : c;  // whose tensors
  const int* cu = cd_u + c * nlu;
  const int* cp = cd_p + c * nlp;
  if (r < nlu3) {
    T acc = T(0);
    if (mode != kUP) acc += dot_u(uu + (ct * nlu3 + r) * nlu3, cu, nlu, xu);
    if (mode != kUU) acc += dot_p(up + (ct * nlu3 + r) * nlp, cp, nlp, xp);
    atomicAdd(yu + 3LL * cu[r / 3] + r % 3, acc);
  } else {
    const int k = r - nlu3;
    T acc = dot_u(pu + (ct * nlp + k) * nlu3, cu, nlu, xu);
    if (mode == kFullPP) acc += dot_p(pp + (ct * nlp + k) * nlp, cp, nlp, xp);
    atomicAdd(yp + cp[k], acc);
  }
}

// Scalar-space operator y = A x, A (nc, nl, nl).
template <typename T>
__global__ void __launch_bounds__(kThreads)
scalar_kernel(const T* __restrict__ ae, const int* __restrict__ cd,
              const T* __restrict__ x, T* __restrict__ y, long long nc,
              int nl) {
  const long long t = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (t >= nc * nl) return;
  const long long c = t / nl;
  const int r = (int)(t - c * nl);
  const int* cc = cd + c * nl;
  atomicAdd(y + cc[r], dot_p(ae + (c * nl + r) * nl, cc, nl, x));
}

unsigned int n_blocks(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

template <typename T>
int launch_saddle(const void* uu, const void* up, const void* pu,
                  const void* pp, const void* cd_u, const void* cd_p,
                  const void* xu, const void* xp, void* yu, void* yp,
                  long long nc, int nlu, int nlp, int mode, int pinned,
                  void* stream) {
  const int rows = (mode == kFull || mode == kFullPP) ? 3 * nlu + nlp : 3 * nlu;
  if (nc * rows == 0) return 0;  // a zero-block grid is a launch error
  auto kernel = pinned ? saddle_kernel<T, true> : saddle_kernel<T, false>;
  kernel<<<n_blocks(nc * rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)uu, (const T*)up, (const T*)pu, (const T*)pp,
      (const int*)cd_u, (const int*)cd_p, (const T*)xu, (const T*)xp,
      (T*)yu, (T*)yp, nc, nlu, nlp, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar(const void* ae, const void* cd, const void* x, void* y,
                  long long nc, int nl, void* stream) {
  if (nc * nl == 0) return 0;
  scalar_kernel<T><<<n_blocks(nc * nl), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)ae, (const int*)cd, (const T*)x, (T*)y, nc, nl);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes by ops/build.py).  Every entry
// launches on the given stream and returns cudaGetLastError().

extern "C" {

int nupgcm_saddle_matvec_f32(const void* uu, const void* up, const void* pu,
                             const void* pp, const void* cd_u, const void* cd_p,
                             const void* xu, const void* xp, void* yu, void* yp,
                             long long nc, int nlu, int nlp, int mode,
                             int pinned, void* stream) {
  return launch_saddle<float>(uu, up, pu, pp, cd_u, cd_p, xu, xp, yu, yp, nc,
                              nlu, nlp, mode, pinned, stream);
}

int nupgcm_saddle_matvec_f64(const void* uu, const void* up, const void* pu,
                             const void* pp, const void* cd_u, const void* cd_p,
                             const void* xu, const void* xp, void* yu, void* yp,
                             long long nc, int nlu, int nlp, int mode,
                             int pinned, void* stream) {
  return launch_saddle<double>(uu, up, pu, pp, cd_u, cd_p, xu, xp, yu, yp, nc,
                               nlu, nlp, mode, pinned, stream);
}

int nupgcm_scalar_matvec_f32(const void* ae, const void* cd, const void* x,
                             void* y, long long nc, int nl, void* stream) {
  return launch_scalar<float>(ae, cd, x, y, nc, nl, stream);
}

int nupgcm_scalar_matvec_f64(const void* ae, const void* cd, const void* x,
                             void* y, long long nc, int nl, void* stream) {
  return launch_scalar<double>(ae, cd, x, y, nc, nl, stream);
}

const char* nupgcm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
