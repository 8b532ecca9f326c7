// Multi-consensus gossip mix for Hopper (sm_90a):  X <- W_{R-1} ... W_1 W_0 X
// for a stack of R (n, n) gossip matrices and an (n, D) node-stacked state.
//
// Replaces the TPU kernel `gossip_mix` of src/repro/kernels/gossip_matmul.py
// (the Pallas `_kernel`, launched by `pl.pallas_call` at line 44): Algorithm 2's
// R chained mixing rounds applied to the flattened model state.
//
// What bounds it on this card: device-memory bandwidth.  A column costs
// 2*R*n*n flops for 2*n*sizeof(T) bytes; at the trainer's n = 4, R = 2 in f32
// that is 2 flop/byte, far below the H100's ridge, so the least time is one
// read and one write of X, 2*n*D*sizeof(T) bytes, over the memory rate.
//
// What the design does about it: one thread owns VEC consecutive columns.  It
// loads the column's n values into registers (16-byte loads for f32 when
// VEC = 4), applies all R matrices with f32 FMA from a shared-memory copy of
// the W stack (every thread of a warp reads the same W entry: a broadcast),
// and writes the column once.  HBM traffic is therefore 2*n*D elements
// whatever R is, the fusion the TPU kernel buys with its VMEM-resident W.  A
// grid-stride loop keeps the grid to a few blocks per SM, so each block
// stages W once.  The ragged tail needs no padding: VEC = 4 only when D % 4 == 0
// and the rows are 16-byte aligned (the wrapper checks), else VEC = 1 and
// every column is bounds-checked.  A thread reads all of its columns before it
// writes them, so a launch may run in place (out == x).
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC consecutive elements moved as one aligned load/store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// x and out are not __restrict__: the launch may run in place.
template <typename T, int N, int VEC>
__global__ void __launch_bounds__(kThreads)
    gossip_mix_kernel(const float* __restrict__ ws, const T* x, T* out, int R,
                      int n, long long D) {
  extern __shared__ float w_s[];
  const int wsize = R * n * n;
  for (int k = threadIdx.x; k < wsize; k += blockDim.x) w_s[k] = ws[k];
  __syncthreads();

  const long long groups = D / VEC;  // VEC divides D (checked by the host)
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long c = g * VEC;
    float col[N][VEC];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const Pack<T, VEC> pk =
            *reinterpret_cast<const Pack<T, VEC>*>(x + (long long)i * D + c);
#pragma unroll
        for (int v = 0; v < VEC; ++v) col[i][v] = to_f32(pk.v[v]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) col[i][v] = 0.f;
      }
    }
    for (int r = 0; r < R; ++r) {
      const float* w = w_s + r * n * n;
      float acc[N][VEC];
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[i][v] = 0.f;
        if (i < n) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            if (j < n) {
              const float wij = w[i * n + j];
#pragma unroll
              for (int v = 0; v < VEC; ++v)
                acc[i][v] = fmaf(wij, col[j][v], acc[i][v]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) col[i][v] = acc[i][v];
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        Pack<T, VEC> pk;
#pragma unroll
        for (int v = 0; v < VEC; ++v) pk.v[v] = from_f32<T>(col[i][v]);
        *reinterpret_cast<Pack<T, VEC>*>(out + (long long)i * D + c) = pk;
      }
    }
  }
}

template <typename T, int N, int VEC>
cudaError_t launch(const float* ws, const T* x, T* out, int R, int n,
                   long long D, cudaStream_t stream) {
  const size_t smem = (size_t)R * n * n * sizeof(float);
  auto kern = gossip_mix_kernel<T, N, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long need = (D / VEC + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  const int blocks = (int)(need < 1 ? 1 : (need < cap ? need : cap));
  kern<<<blocks, kThreads, smem, stream>>>(ws, x, out, R, n, D);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_n(const float* ws, const T* x, T* out, int R, int n,
                       long long D, cudaStream_t s) {
  if (n <= 4) return launch<T, 4, VEC>(ws, x, out, R, n, D, s);
  if (n <= 8) return launch<T, 8, VEC>(ws, x, out, R, n, D, s);
  return launch<T, 16, VEC>(ws, x, out, R, n, D, s);
}

template <typename T>
cudaError_t dispatch(const float* ws, const T* x, T* out, int R, int n,
                     long long D, int vec, cudaStream_t s) {
  if (vec == 4) {
    if (n > 16 || D % 4 != 0) return cudaErrorInvalidValue;
    return dispatch_n<T, 4>(ws, x, out, R, n, D, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (n <= 16) return dispatch_n<T, 1>(ws, x, out, R, n, D, s);
  if (n <= 32) return launch<T, 32, 1>(ws, x, out, R, n, D, s);
  return launch<T, 64, 1>(ws, x, out, R, n, D, s);
}

}  // namespace

// ws: (R, n, n) f32; x, out: (n, D) contiguous, f32 (dtype 0) or bf16
// (dtype 1); 1 <= n <= 64; vec 1 or 4.  Launches on `stream` and returns the
// launch's cudaError_t (0 = queued).
extern "C" int gossip_mix_launch(const void* ws, const void* x, void* out,
                                 int R, int n, long long D, int dtype, int vec,
                                 void* stream) {
  if (R < 1 || n < 1 || n > 64 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  if (dtype == 0)
    return (int)dispatch<float>(w, static_cast<const float*>(x),
                                static_cast<float*>(out), R, n, D, vec, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(
        w, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), R, n, D, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
