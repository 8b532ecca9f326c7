// Error-feedback compressed multi-consensus for Hopper (sm_90a).  For each
// of R rounds, on an (n, D) node-stacked f32 state x and residual res:
//
//   buf = x + res
//   deq = dequant(quant(buf))   per (node, group of `group` consecutive columns)
//   res = buf - deq             (only with error feedback)
//   x   = W_r @ deq
//
// sign:  s = mean|g| over the group, deq = sign(g) * s, sign(0) = 0.
// int8:  s = max|g| / 127, safe = s > 0 ? s : 1, q = clip(rint(g / safe), ±127),
//        deq = q * s.  rint rounds half to even, like jnp.round.
//
// Replaces the TPU kernel `quantized_gossip_mix` of
// src/repro/kernels/quantized_gossip.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 79).
//
// What bounds it on this card: device-memory bandwidth.  Per column and round
// it does ~2n^2 flops of mixing plus a few operations of quantization for
// 4*n*4 bytes moved once (x and res read, x and res written), far below the
// H100's ridge; the least time is one read and one write of x and res.
//
// What the design does about it: one thread owns VEC consecutive columns of
// every node and keeps them, x and res, in registers for all R rounds; a
// quantization group is owned by group / VEC consecutive threads of one
// block.  Each round reduces |buf| per (node, group) across those threads --
// a warp-shuffle butterfly (every lane ends with the same bits, since each
// step adds the same two values on both lanes), then, for a group wider than
// a warp, a pass over shared memory in a fixed warp order.  No atomics: a
// rerun gives the same bits.  The mix applies W_r from a shared-memory copy
// of the W stack (a broadcast read), as gossip_mix.cu does.  So device-memory
// traffic is one read and one write of x and res whatever R is -- the fusion
// the TPU kernel buys with its VMEM-resident block.  A thread reads all of its
// columns before it writes them and no other thread touches them, so a
// launch may run in place (out == x, res_out == res).
//
// Numerics: IEEE division (no --use_fast_math), rintf for half to even, and
// buf, deq and buf - deq through the _rn intrinsics, which the compiler may
// not contract into an FMA: res then has the reference's bits.
//
// Takes: 1 <= n <= 16; group a power of two, 1 <= group <= 256; D a multiple
// of group; f32 only.  VEC = 4 (16-byte loads) when n <= 8, group % 4 == 0
// and the rows are 16-byte aligned (the wrapper checks), else VEC = 1.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxNodes = 16;
constexpr int kMaxGroup = kThreads;  // a group fits one block even at VEC = 1

// VEC consecutive floats moved as one aligned load/store.
template <int VEC>
struct alignas(4 * VEC) Pack {
  float v[VEC];
};

// SCHEME 0 = sign (sum of |buf|), 1 = int8 (max of |buf|).
template <int SCHEME>
__device__ __forceinline__ float combine(float a, float b) {
  return SCHEME == 0 ? __fadd_rn(a, b) : fmaxf(a, b);
}

// x, res, out, res_out are not __restrict__: the launch may run in place.
template <int N, int VEC, int SCHEME>
__global__ void __launch_bounds__(kThreads)
    quantized_gossip_mix_kernel(const float* __restrict__ ws, const float* x,
                                const float* res, float* out, float* res_out,
                                int R, int n, long long D, int group, int ef,
                                int write_res) {
  extern __shared__ float smem[];
  float* w_s = smem;                  // R * n * n
  float* red_s = smem + R * n * n;    // kWarps * N per-warp partials
  const int wsize = R * n * n;
  for (int k = threadIdx.x; k < wsize; k += blockDim.x) w_s[k] = ws[k];
  __syncthreads();

  const int tpg = group / VEC;                  // threads per group
  const int width = tpg < 32 ? tpg : 32;        // shuffle segment
  const int wpg = tpg / 32;                     // warps per group (0 or 1: none)
  const int warp = threadIdx.x >> 5;
  const int first = wpg > 1 ? (warp / wpg) * wpg : warp;
  const float count = (float)group;             // mean = sum / group
  const long long tile = (long long)kThreads * VEC;
  const long long tiles = (D + tile - 1) / tile;

  // The loop bound is the same for every thread of the block, so the
  // __syncthreads below are reached by all of them.
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long c = t * tile + (long long)threadIdx.x * VEC;
    // D % group == 0 and a group is tpg consecutive threads, so a group is
    // all live or all dead; dead threads carry zeros through the reductions.
    const bool live = c < D;
    float xv[N][VEC], rv[N][VEC];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (live && i < n) {
        const Pack<VEC> px =
            *reinterpret_cast<const Pack<VEC>*>(x + (long long)i * D + c);
        const Pack<VEC> pr =
            *reinterpret_cast<const Pack<VEC>*>(res + (long long)i * D + c);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          xv[i][v] = px.v[v];
          rv[i][v] = pr.v[v];
        }
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) xv[i][v] = rv[i][v] = 0.f;
      }
    }

    for (int r = 0; r < R; ++r) {
      // buf = x + res, kept in xv; this thread's share of each row's group
      float part[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float p = 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          xv[i][v] = __fadd_rn(xv[i][v], rv[i][v]);
          p = combine<SCHEME>(p, fabsf(xv[i][v]));
        }
        part[i] = p;
      }
      // butterfly within the group's warp segment
      for (int off = width >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          part[i] = combine<SCHEME>(
              part[i], __shfl_xor_sync(0xffffffffu, part[i], off, width));
      }
      if (wpg > 1) {  // a group spans wpg warps: combine them in warp order
        if ((threadIdx.x & 31) == 0) {
#pragma unroll
          for (int i = 0; i < N; ++i) red_s[warp * N + i] = part[i];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < N; ++i) {
          float s = red_s[first * N + i];
          for (int w = 1; w < wpg; ++w)
            s = combine<SCHEME>(s, red_s[(first + w) * N + i]);
          part[i] = s;
        }
        __syncthreads();  // red_s is written again next round
      }
      // quantize -> dequantize in xv, the error into rv
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (SCHEME == 0) {
          const float s = part[i] / count;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float b = xv[i][v];
            const float sg = (float)((b > 0.f) - (b < 0.f));
            const float d = __fmul_rn(sg, s);
            if (ef) rv[i][v] = __fsub_rn(b, d);
            xv[i][v] = d;
          }
        } else {
          const float s = part[i] / 127.0f;
          const float safe = s > 0.f ? s : 1.f;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const float b = xv[i][v];
            const float q = fminf(fmaxf(rintf(b / safe), -127.f), 127.f);
            const float d = __fmul_rn(q, s);
            if (ef) rv[i][v] = __fsub_rn(b, d);
            xv[i][v] = d;
          }
        }
      }
      // x = W_r @ deq
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
                acc[i][v] = fmaf(wij, xv[j][v], acc[i][v]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) xv[i][v] = acc[i][v];
      }
    }

    if (live) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < n) {
          Pack<VEC> px, pr;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            px.v[v] = xv[i][v];
            pr.v[v] = rv[i][v];
          }
          *reinterpret_cast<Pack<VEC>*>(out + (long long)i * D + c) = px;
          if (write_res)
            *reinterpret_cast<Pack<VEC>*>(res_out + (long long)i * D + c) = pr;
        }
      }
    }
  }
}

template <int N, int VEC, int SCHEME>
cudaError_t launch(const float* ws, const float* x, const float* res,
                   float* out, float* res_out, int R, int n, long long D,
                   int group, int ef, int write_res, cudaStream_t stream) {
  const size_t smem = ((size_t)R * n * n + (size_t)kWarps * N) * sizeof(float);
  auto kern = quantized_gossip_mix_kernel<N, VEC, SCHEME>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many blocks as are resident at once (registers bound it for the
  // wide instances), so the grid-stride loop leaves no late wave
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tile = (long long)kThreads * VEC;
  const long long need = (D + tile - 1) / tile;
  const long long cap =
      (long long)sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  const int blocks = (int)(need < cap ? need : cap);
  kern<<<blocks, kThreads, smem, stream>>>(ws, x, res, out, res_out, R, n, D,
                                           group, ef, write_res);
  return cudaGetLastError();
}

template <int SCHEME>
cudaError_t dispatch(const float* ws, const float* x, const float* res,
                     float* out, float* res_out, int R, int n, long long D,
                     int group, int ef, int write_res, int vec,
                     cudaStream_t s) {
  if (vec == 4) {
    if (n > 8 || group % 4 != 0) return cudaErrorInvalidValue;
    if (n <= 4)
      return launch<4, 4, SCHEME>(ws, x, res, out, res_out, R, n, D, group,
                                  ef, write_res, s);
    return launch<8, 4, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                                write_res, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (n <= 4)
    return launch<4, 1, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                                write_res, s);
  if (n <= 8)
    return launch<8, 1, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                                write_res, s);
  return launch<16, 1, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                               write_res, s);
}

}  // namespace

// ws: (R, n, n) f32; x, res, out, res_out: (n, D) contiguous f32, out may be
// x and res_out may be res; 1 <= n <= 16; group a power of two in [1, 256]
// dividing D; scheme 0 = sign, 1 = int8; ef: error feedback on/off;
// write_res: store res_out (0 only when res is unchanged and res_out == res);
// vec 1 or 4.  Launches on `stream` and returns the launch's cudaError_t
// (0 = queued).
extern "C" int quantized_gossip_mix_launch(const void* ws, const void* x,
                                           const void* res, void* out,
                                           void* res_out, int R, int n,
                                           long long D, int group, int scheme,
                                           int ef, int write_res, int vec,
                                           void* stream) {
  if (R < 1 || n < 1 || n > kMaxNodes || D < 1 || group < 1 ||
      group > kMaxGroup || (group & (group - 1)) != 0 || D % group != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(res);
  float* op = static_cast<float*>(out);
  float* rop = static_cast<float*>(res_out);
  if (scheme == 0)
    return (int)dispatch<0>(w, xp, rp, op, rop, R, n, D, group, ef, write_res,
                            vec, s);
  if (scheme == 1)
    return (int)dispatch<1>(w, xp, rp, op, rop, R, n, D, group, ef, write_res,
                            vec, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* quantized_gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
