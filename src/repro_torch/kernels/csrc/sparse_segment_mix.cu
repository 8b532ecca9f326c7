// Edge-list gossip segment sum for Hopper (sm_90a): one round of sparse
// gossip in Laplacian form, the per-receiver update
//
//     delta[s] = sum_{e in [offsets[s], offsets[s+1])} w[e] * (x[src[e]] - x[dst[e]])
//
// for an (n, D) node-stacked state x, with the round's edges grouped by
// receiver segment (the caller sorts them once per staged plan, stably, so
// each segment's edges keep the plan's order).  The caller then applies
// x[slots[s]] += delta[s] outside the kernel.
//
// Replaces the TPU kernel `sparse_segment_mix` of
// src/repro/kernels/sparse_gossip.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 64).  The TPU kernel takes gathered (E, D) copies
// xs = x[src], xd = x[dst] and does the segment sum as a one-hot matmul on
// the MXU, because a TPU has no scatter-add; neither is needed here.
//
// What bounds it on this card: at the sampled-client main path (a cohort of
// 256 of 100,000 nodes, ~27k edges, D = 784) the work is small: ~3*E*D =
// 62 MFLOP and a few MB (the <= 256 distinct rows of x it reads, delta, the
// edge arrays), about 1 us either way at the card's peak rates.  So launch
// latency and the dependent loop over a segment's edges bound it, not bytes
// or operations.
//
// What the design does about it: the gathers are fused (x[src[e]] and
// x[dst[e]] are read straight from x by index; no xs or xd is built), and
// one block owns one (segment, column chunk): a thread keeps VEC columns of
// the segment's sum in registers and walks the segment's edges in order, so
// the sum has a fixed order, needs no float atomics, and reruns are
// bit-equal.  Every thread of a warp reads the same edge (a broadcast) and
// neighbouring columns of its two rows (coalesced, 16 bytes a thread for f32
// when VEC = 4).  A ragged D needs no padding copy: VEC = 4 only when
// D % 4 == 0 and x is 16-byte aligned (the wrapper checks), else VEC = 1,
// and the last chunk's threads past D return.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC consecutive elements moved as one aligned load/store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    sparse_segment_mix_kernel(const T* __restrict__ x,
                              const long long* __restrict__ src,
                              const long long* __restrict__ dst,
                              const float* __restrict__ w,
                              const long long* __restrict__ offsets,
                              float* __restrict__ delta, long long D) {
  const long long s = blockIdx.x;  // the receiver segment
  const long long c =
      ((long long)blockIdx.y * kThreads + threadIdx.x) * VEC;  // first column
  if (c >= D) return;  // VEC divides D (checked by the host)
  const long long lo = offsets[s];
  const long long hi = offsets[s + 1];
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
#pragma unroll 4
  for (long long e = lo; e < hi; ++e) {
    const float we = w[e];
    const Pack<T, VEC> ps =
        *reinterpret_cast<const Pack<T, VEC>*>(x + src[e] * D + c);
    const Pack<T, VEC> pd =
        *reinterpret_cast<const Pack<T, VEC>*>(x + dst[e] * D + c);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] = fmaf(we, to_f32(ps.v[v]) - to_f32(pd.v[v]), acc[v]);
  }
  Pack<float, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = acc[v];
  *reinterpret_cast<Pack<float, VEC>*>(delta + s * D + c) = out;
}

template <typename T, int VEC>
cudaError_t launch(const T* x, const long long* src, const long long* dst,
                   const float* w, const long long* offsets, float* delta,
                   int S, long long D, cudaStream_t stream) {
  const long long chunks = (D / VEC + kThreads - 1) / kThreads;
  if (chunks > kMaxGridY) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)S, (unsigned)chunks);
  sparse_segment_mix_kernel<T, VEC>
      <<<grid, kThreads, 0, stream>>>(x, src, dst, w, offsets, delta, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const long long* src, const long long* dst,
                     const float* w, const long long* offsets, float* delta,
                     int S, long long D, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (vec == 4) {
    if (D % 4 != 0) return cudaErrorInvalidValue;
    return launch<T, 4>(xt, src, dst, w, offsets, delta, S, D, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return launch<T, 1>(xt, src, dst, w, offsets, delta, S, D, s);
}

}  // namespace

// x: (n, D) contiguous, f32 (dtype 0) or bf16 (dtype 1); src, dst, w: the
// round's edges grouped by segment, int64, int64, f32; offsets: (S + 1,)
// int64, segment s owning edges [offsets[s], offsets[s+1]); delta: (S, D)
// f32, every entry written.  Indices are trusted: the wrapper documents
// them.  Launches on `stream` and returns the launch's cudaError_t (0 =
// queued).
extern "C" int sparse_segment_mix_launch(const void* x, const void* src,
                                         const void* dst, const void* w,
                                         const void* offsets, void* delta,
                                         int S, long long D, int dtype,
                                         int vec, void* stream) {
  if (S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(src);
  const long long* dp = static_cast<const long long*>(dst);
  const float* wp = static_cast<const float*>(w);
  const long long* op = static_cast<const long long*>(offsets);
  float* out = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch<float>(x, sp, dp, wp, op, out, S, D, vec, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, sp, dp, wp, op, out, S, D, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* sparse_segment_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
