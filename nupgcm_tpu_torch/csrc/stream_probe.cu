// Streaming probes for Hopper (sm_90a): kernels that read a known
// number of bytes and do almost nothing with them, so their time is the
// cost of moving those bytes from device memory.
//
// stream_saddle_kernel (K3) replaces the Pallas kernel stream_once of
// tools/profile_matvec.py:174-188 (body stream_kernel :159-170).  It
// reads exactly the element tensors the saddle matvec reads -- uu
// (nc, 30, 30), up (nc, 30, 4), pu (nc, 4, 30) for P2-P1 tets -- and
// computes, in the canonical cell order,
//
//     o[l] = carry[l] + 1e-30 * sum_{c : c mod 128 = l} sum(uu_c, up_c, pu_c)
//
// which is what the TPU kernel's (1, 128) lane-carry sums to: its
// blocked layout puts cell b*128 + l in lane l, and padded cells are
// zero.  Design: one warp per cell, 16-byte loads (a cell's f32 slices
// are 3600, 480 and 480 bytes, all multiples of 16), a warp-shuffle
// sum, and one atomicAdd per cell into a 128-entry accumulator of the
// input type; a one-block epilogue forms o in f32 (the TPU kernel's
// out_shape).
//
// stream_probe_kernel (K4) replaces the Pallas kernel run.<locals>.once
// of tools/profile_stream.py:75-79 (body kernel :52-63), on its shapes:
// f32 parts (nb, rows_i, 128) and an optional eight int32 index arrays
// (nb, 1, L) that the TPU kernel only copies in.
//
//     o[j] = sum_parts sum_{b, r} part[b, r, j] + sum_b w0[b]
//
// One CUDA block covers the bytes of one TPU grid step (block b of
// every part), so the block count and the bytes per block follow the
// probe's B as on the TPU.  256 threads: thread (r0, q) sums float4
// column quad q of rows r0, r0 + 8, ...; a shared-memory pass folds the
// 8 row groups and one atomicAdd per column and block lands in o.  The
// index arrays, where given, are really read: their int64 sum goes to
// a checksum the wrapper returns, so no load can be dropped.
//
// Bound: HBM bandwidth (3.35 TB/s on an H100 SXM) once the bytes exceed
// the 50 MB L2; below that, L2 bandwidth and launch cost.  Both probes
// do one add per value.  The atomics sum in a different order on every
// run, so results agree with a sequential sum only to rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 128;       // the TPU kernels' lane width
constexpr int kIdxArrays = 8;

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ float vsum(float4 v) { return (v.x + v.y) + (v.z + v.w); }
__device__ __forceinline__ double vsum(double2 v) { return v.x + v.y; }

// This lane's share of the sum of n_vec 16-byte vectors at a.
template <typename T>
__device__ __forceinline__ T lane_sum(const T* __restrict__ a, long long n_vec,
                                      int lane) {
  using V = typename Vec16<T>::type;
  const V* v = reinterpret_cast<const V*>(a);
  T acc = T(0);
  for (long long i = lane; i < n_vec; i += 32) acc += vsum(__ldg(v + i));
  return acc;
}

// K3: n_* are 16-byte vectors per cell of each tensor.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_saddle_kernel(const T* __restrict__ uu, const T* __restrict__ up,
                     const T* __restrict__ pu, T* __restrict__ acc,
                     long long nc, int n_uu, int n_up, int n_pu) {
  const long long c = blockIdx.x * (long long)kWarps + threadIdx.x / 32;
  if (c >= nc) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  constexpr int k = Vec16<T>::n;
  T s = lane_sum(uu + c * n_uu * k, n_uu, lane)
      + lane_sum(up + c * n_up * k, n_up, lane)
      + lane_sum(pu + c * n_pu * k, n_pu, lane);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) atomicAdd(acc + c % kLanes, s);
}

template <typename T>
__global__ void stream_saddle_epilogue(const T* __restrict__ acc,
                                       const float* __restrict__ carry,
                                       float* __restrict__ out) {
  const int l = threadIdx.x;
  if (l < kLanes) out[l] = (float)((T)carry[l] + (T)1e-30 * acc[l]);
}

struct IdxArrays {
  const int* p[kIdxArrays];
};

// K4: part i is (nb, rows_i, 128) f32; rows_i = 0 for an absent part.
__global__ void __launch_bounds__(kThreads)
stream_probe_kernel(const float* __restrict__ p0, const float* __restrict__ p1,
                    const float* __restrict__ p2, int rows0, int rows1,
                    int rows2, const int* __restrict__ w0, IdxArrays idx,
                    int idx_len, float* __restrict__ out,
                    unsigned long long* __restrict__ checksum) {
  const long long b = blockIdx.x;
  const int q = threadIdx.x & 31;   // float4 column quad: columns 4q .. 4q+3
  const int r0 = threadIdx.x >> 5;  // row group = warp
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* parts[3] = {p0, p1, p2};
  const int rows[3] = {rows0, rows1, rows2};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (rows[i] == 0) continue;
    const float4* v = reinterpret_cast<const float4*>(parts[i] + b * rows[i] * kLanes);
    for (int r = r0; r < rows[i]; r += kWarps) {
      const float4 x = __ldg(v + r * (kLanes / 4) + q);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
  }
  __shared__ float4 part_sums[kWarps][32];
  part_sums[r0][q] = acc;
  __syncthreads();
  if (r0 == 0) {
    float4 s = part_sums[0][q];
    for (int g = 1; g < kWarps; ++g) {
      const float4 x = part_sums[g][q];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const float w = (float)w0[b];
    atomicAdd(out + 4 * q, s.x + w);
    atomicAdd(out + 4 * q + 1, s.y + w);
    atomicAdd(out + 4 * q + 2, s.z + w);
    atomicAdd(out + 4 * q + 3, s.w + w);
  }
  if (idx.p[0] == nullptr) return;  // uniform across the grid
  long long cs = 0;
  for (int a = 0; a < kIdxArrays; ++a) {
    const int* ip = idx.p[a] + b * idx_len;
    for (int i = threadIdx.x; i < idx_len; i += kThreads) cs += __ldg(ip + i);
  }
  for (int off = 16; off > 0; off >>= 1) cs += __shfl_down_sync(0xffffffffu, cs, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(checksum, (unsigned long long)cs);
}

template <typename T>
int launch_stream_saddle(const void* uu, const void* up, const void* pu,
                         const void* carry, void* acc, void* out, long long nc,
                         int n_uu, int n_up, int n_pu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nc > 0) {
    const unsigned int blocks = (unsigned int)((nc + kWarps - 1) / kWarps);
    stream_saddle_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)uu, (const T*)up, (const T*)pu, (T*)acc, nc, n_uu, n_up, n_pu);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  stream_saddle_epilogue<T><<<1, kLanes, 0, s>>>((const T*)acc, (const float*)carry,
                                                 (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes by ops/build.py).  Every entry
// launches on the given stream and returns cudaGetLastError().  The
// caller zeroes acc (K3), out and checksum (K4).

extern "C" {

int nupgcm_stream_saddle_f32(const void* uu, const void* up, const void* pu,
                             const void* carry, void* acc, void* out,
                             long long nc, int n_uu, int n_up, int n_pu,
                             void* stream) {
  return launch_stream_saddle<float>(uu, up, pu, carry, acc, out, nc, n_uu,
                                     n_up, n_pu, stream);
}

int nupgcm_stream_saddle_f64(const void* uu, const void* up, const void* pu,
                             const void* carry, void* acc, void* out,
                             long long nc, int n_uu, int n_up, int n_pu,
                             void* stream) {
  return launch_stream_saddle<double>(uu, up, pu, carry, acc, out, nc, n_uu,
                                      n_up, n_pu, stream);
}

int nupgcm_stream_probe_f32(const void* p0, const void* p1, const void* p2,
                            int rows0, int rows1, int rows2, const void* w0,
                            const void* i0, const void* i1, const void* i2,
                            const void* i3, const void* i4, const void* i5,
                            const void* i6, const void* i7, int idx_len,
                            void* out, void* checksum, long long nb,
                            void* stream) {
  if (nb == 0) return 0;
  const IdxArrays idx = {{(const int*)i0, (const int*)i1, (const int*)i2,
                          (const int*)i3, (const int*)i4, (const int*)i5,
                          (const int*)i6, (const int*)i7}};
  stream_probe_kernel<<<(unsigned int)nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p0, (const float*)p1, (const float*)p2, rows0, rows1, rows2,
      (const int*)w0, idx, idx_len, (float*)out, (unsigned long long*)checksum);
  return (int)cudaGetLastError();
}

}  // extern "C"
