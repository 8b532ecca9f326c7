// Diagonal linear recurrence for Hopper (sm_90a):
//
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0,
//
// along the time axis of a, b (B, S, C), independently for every (batch,
// channel).  Writes every state h_all (B, S, C) f32 and the last one h_last
// (B, C) f32.  a and b are f32 or bf16 (both the same), read as f32.
//
// Replaces the TPU kernel `linear_recurrence` of
// src/repro/kernels/linear_recurrence.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 63).  The TPU kernel walks the time axis as the
// innermost, sequential grid dimension in chunks of block_t steps, carrying
// the state from chunk to chunk in VMEM scratch; here the grid has no
// sequential dimension, so one thread carries its channels' state through
// all S steps in registers.
//
// What bounds it on this card: bytes.  A step is one multiply and one add per
// channel against 8-12 bytes moved (a and b read, h written), so at the mamba
// prefill's shape (1, 2048, 131072) f32 the kernel moves 3.2 GB and does 0.5
// GFLOP: ~0.96 ms at 3.35 TB/s against ~8 us of f32 arithmetic.
//
// What the design does about it: threads own channels (C is the contiguous
// axis, so a warp's loads and stores of one step are coalesced: 16 bytes a
// thread for f32 when VEC = 4), and the grid covers B x ceil(C / (VEC *
// 128)).  A thread issues the loads of kAhead steps before it runs their
// multiply-add chain (the loads do not depend on h), so each warp keeps
// 2 * kAhead loads in flight; only the chain itself is serial.  A ragged C
// needs no padding copy: VEC = 4 only when C % 4 == 0 and the pointers are
// aligned (the wrapper checks), else VEC = 1.
//
// Rounding: the step is __fadd_rn(__fmul_rn(a, h), b), the product and the
// sum each rounded to f32.  nvcc would otherwise contract a * h + b into one
// FMA, and the result would no longer be bit-equal to the plain PyTorch
// version (two separate elementwise ops), nor to the reference's jnp scan.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;  // steps whose loads are issued before their chain
constexpr long long kMaxGridX = 2147483647LL;
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
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// One step for VEC channels: h <- a * h + b, stored to out.
template <typename T, int VEC>
__device__ __forceinline__ void step(float (&h)[VEC], const Pack<T, VEC>& pa,
                                     const Pack<T, VEC>& pb, float* out) {
  Pack<float, VEC> o;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    h[v] = __fadd_rn(__fmul_rn(to_f32(pa.v[v]), h[v]), to_f32(pb.v[v]));
    o.v[v] = h[v];
  }
  *reinterpret_cast<Pack<float, VEC>*>(out) = o;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    linear_recurrence_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             float* __restrict__ h_all,
                             float* __restrict__ h_last, int S, long long C) {
  const long long c =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;  // first channel
  if (c >= C) return;  // VEC divides C (checked by the host)
  const long long base = (long long)blockIdx.y * S * C + c;  // (batch, 0, c)
  const T* ap = a + base;
  const T* bp = b + base;
  float* hp = h_all + base;
  float h[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) h[v] = 0.f;
  int t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    Pack<T, VEC> pa[kAhead], pb[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long off = (long long)(t + k) * C;
      pa[k] = load<T, VEC>(ap + off);
      pb[k] = load<T, VEC>(bp + off);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      step<T, VEC>(h, pa[k], pb[k], hp + (long long)(t + k) * C);
  }
  for (; t < S; ++t) {
    const long long off = (long long)t * C;
    step<T, VEC>(h, load<T, VEC>(ap + off), load<T, VEC>(bp + off), hp + off);
  }
  Pack<float, VEC> last;
#pragma unroll
  for (int v = 0; v < VEC; ++v) last.v[v] = h[v];
  *reinterpret_cast<Pack<float, VEC>*>(h_last + (long long)blockIdx.y * C +
                                        c) = last;
}

template <typename T, int VEC>
cudaError_t launch(const T* a, const T* b, float* h_all, float* h_last, int B,
                   int S, long long C, cudaStream_t stream) {
  const long long blocks = (C / VEC + kThreads - 1) / kThreads;
  if (blocks > kMaxGridX || B > kMaxGridY) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  linear_recurrence_kernel<T, VEC>
      <<<grid, kThreads, 0, stream>>>(a, b, h_all, h_last, S, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* b, float* h_all,
                     float* h_last, int B, int S, long long C, int vec,
                     cudaStream_t s) {
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  if (vec == 4) {
    if (C % 4 != 0) return cudaErrorInvalidValue;
    return launch<T, 4>(at, bt, h_all, h_last, B, S, C, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return launch<T, 1>(at, bt, h_all, h_last, B, S, C, s);
}

}  // namespace

// a, b: (B, S, C) contiguous, f32 (dtype 0) or bf16 (dtype 1); h_all: (B, S,
// C) f32 and h_last: (B, C) f32, every entry written.  Launches on `stream`
// and returns the launch's cudaError_t (0 = queued).
extern "C" int linear_recurrence_launch(const void* a, const void* b,
                                        void* h_all, void* h_last, int B,
                                        int S, long long C, int dtype, int vec,
                                        void* stream) {
  if (B < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ha = static_cast<float*>(h_all);
  float* hl = static_cast<float*>(h_last);
  if (dtype == 0)
    return (int)dispatch<float>(a, b, ha, hl, B, S, C, vec, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(a, b, ha, hl, B, S, C, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* linear_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
