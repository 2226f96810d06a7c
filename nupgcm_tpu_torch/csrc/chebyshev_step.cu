// One Chebyshev smoothing step for Hopper (sm_90a): the vector updates
// of solvers/preconditioners.py::chebyshev around each operator
// application, in one launch.
//
// It replaces no TPU kernel: on the TPU, XLA fuses the smoother's
// elementwise updates (nupgcm_tpu/solvers/preconditioners.py::chebyshev
// under jit).  In eager PyTorch each step launched eight small kernels
// besides the operator (the mask multiply and select of
// MaskedOperator, r - y, a d, dinv r, b (dinv r), the sum, z + d), and
// the host time spent launching them, not the card, set the smoother's
// cost.  A call of k steps now makes 1 + 2 (k - 1) launches: this
// kernel's init, then per step the operator and this kernel's step.
//
//   init:  d = scale (dinv r);  dm = d free
//   step:  y' = free != 0 ? y : d      (y = A dm; MaskedOperator's select)
//          r = r - y';  d = a d + b (dinv r);  z = z + d;  dm = d free
//
// With free null the operator is unmasked (y' = y) and no dm is
// written: the next operator application takes d itself.
//
// Bit for bit the unfused PyTorch expressions: every operation is
// rounded on its own, in their order, through the _rn intrinsics, which
// nvcc never contracts into an FMA; a and b arrive rounded to T as
// PyTorch rounds a Python scalar; d free stays a multiply (NaN and -0
// as the unfused path has them).  Each thread reads all of its element
// before it writes, so r_out may be r_in and z_in may be d (the first
// step, where z is still d).  Vectors are contiguous at any element
// offset (a pressure block is a view into the Krylov vector, 4-byte
// aligned): scalar loads, no vector loads.
//
// Bound: bytes.  A step reads six vectors and writes four (init: three
// and two), about 3.3 MB each at the 0.87M bowl's velocity block, so
// the card takes microseconds; what the fusion saves is host time.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_init_kernel(const T* __restrict__ r, const T* __restrict__ dinv,
                 const T* __restrict__ free, T scale, T* __restrict__ d,
                 T* __restrict__ dm, long long n) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const T dv = mul(scale, mul(dinv[i], r[i]));
  d[i] = dv;
  if (free != nullptr) dm[i] = mul(dv, free[i]);
}

// No __restrict__ on y, r_in/r_out, d, z_in, dm: they may alias (see above).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cheb_step_kernel(const T* y, const T* r_in, T* r_out,
                 const T* __restrict__ dinv, const T* __restrict__ free, T* d,
                 const T* z_in, T* z_out, T* dm, T a, T b, long long n) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const T dv = d[i];
  const T zv = z_in[i];
  const T rv = r_in[i];
  const T f = free != nullptr ? free[i] : T(1);
  const T yv = f != T(0) ? y[i] : dv;
  const T rn = sub(rv, yv);
  const T dn = add(mul(a, dv), mul(b, mul(dinv[i], rn)));
  r_out[i] = rn;
  d[i] = dn;
  z_out[i] = add(zv, dn);
  if (free != nullptr) dm[i] = mul(dn, f);
}

unsigned int blocks(long long n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

// Run on p->device (the caller's current device restored after).
template <typename F>
int on_device(int device, F launch) {
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return (int)err;
  if (cur != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  launch();
  const int rc = (int)cudaGetLastError();
  if (cur != device) cudaSetDevice(cur);
  return rc;
}

}  // namespace

// One smoothing call's vectors, set by the wrapper (ops/kernels.py
// ChebStep, which mirrors this struct): free null for an unmasked
// operator (dm then unused); r_in, z_in are the caller's r and d at the
// first step, the work vectors r_out, z_out after it.
struct ChebLaunch {
  const void* r_in;
  void* r_out;
  const void* dinv;
  const void* free;
  void* d;
  const void* z_in;
  void* z_out;
  void* dm;
  long long n;
  int f64;
  int device;
};

// Plain C interface (loaded with ctypes by ops/build.py).  Every entry
// launches on the given stream of p->device and returns
// cudaGetLastError().

extern "C" {

// init: d = scale (dinv r), dm = d free.
int nupgcm_cheb_init(const ChebLaunch* p, const void* r, double scale, void* stream) {
  if (p->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return on_device(p->device, [&] {
    if (p->f64)
      cheb_init_kernel<double><<<blocks(p->n), kThreads, 0, s>>>(
          (const double*)r, (const double*)p->dinv, (const double*)p->free, scale,
          (double*)p->d, (double*)p->dm, p->n);
    else
      cheb_init_kernel<float><<<blocks(p->n), kThreads, 0, s>>>(
          (const float*)r, (const float*)p->dinv, (const float*)p->free, (float)scale,
          (float*)p->d, (float*)p->dm, p->n);
  });
}

// A step after y = A dm (see the top of this file).
int nupgcm_cheb_step(const ChebLaunch* p, const void* y, double a, double b, void* stream) {
  if (p->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return on_device(p->device, [&] {
    if (p->f64)
      cheb_step_kernel<double><<<blocks(p->n), kThreads, 0, s>>>(
          (const double*)y, (const double*)p->r_in, (double*)p->r_out,
          (const double*)p->dinv, (const double*)p->free, (double*)p->d,
          (const double*)p->z_in, (double*)p->z_out, (double*)p->dm, a, b, p->n);
    else
      cheb_step_kernel<float><<<blocks(p->n), kThreads, 0, s>>>(
          (const float*)y, (const float*)p->r_in, (float*)p->r_out, (const float*)p->dinv,
          (const float*)p->free, (float*)p->d, (const float*)p->z_in, (float*)p->z_out,
          (float*)p->dm, (float)a, (float)b, p->n);
  });
}

}  // extern "C"
