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
// Three routes, picked by the wrapper from the shapes alone
// (kernels/quantized_gossip.py launch_geometry):
//
// * regs (n <= 16, group a power of two <= 256): one thread owns VEC
//   consecutive columns of every node and keeps them, x and res, in
//   registers for all R rounds; a quantization group is owned by group / VEC
//   consecutive threads of one block.  Each round reduces |buf| per (node,
//   group) across those threads -- a warp-shuffle butterfly (every lane ends
//   with the same bits, since each step adds the same two values on both
//   lanes), then, for a group wider than a warp, a pass over shared memory in
//   a fixed warp order.  The mix applies W_r from a shared-memory copy of the
//   W stack (a broadcast read), as gossip_mix.cu does.  n * VEC * 2 floats a
//   thread bound n, the 256-thread block bounds the group.
// * tile (n <= 64, any group, where a block's tile of whole groups fits in
//   shared memory: n * group * 8 bytes, a few groups when they are narrow):
//   the block loads the tile's x and res once, runs all R rounds on it in
//   shared memory -- buf, then each (node, group) row's |buf| reduced by one
//   warp (lane l takes columns l, l + 32, ... in order, then a butterfly),
//   then each thread quantizes and mixes its own columns, all n nodes of
//   one column at a time, with n accumulators in registers -- and stores it
//   once.
// * stream (n <= 64, a tile that does not fit): a block owns one group at a
//   time and streams it through device memory every round: a pass that
//   reduces each node's |buf| over the group (one warp a node, as above),
//   then a pass in which each thread quantizes and mixes its columns and
//   writes x and res; round r > 0 reads what round r - 1 wrote.  Device
//   traffic is then up to 1.5 R times the other routes' (per round two
//   reads of x and res and one write, against one read and one write in
//   all), less what the L2 cache keeps of a group between its two passes.
//
// Every route: one read and one write of x and res where the tile is on
// chip, fixed-order reductions and no atomics (a rerun gives the same bits),
// and the mix of column c as fmaf(W[i][j], deq[j][c], acc) over j = 0 .. n-1
// in order, so for int8 (a max, order-free) the three routes give the same
// bits; sign's sums differ in order between routes.  A thread reads all n
// values of its columns before it writes them, and no other thread of the
// launch writes them, so a launch may run in place (out == x, res_out ==
// res).
//
// Numerics: IEEE division (no --use_fast_math), rintf for half to even, and
// buf, deq and buf - deq through the _rn intrinsics, which the compiler may
// not contract into an FMA: res then has the reference's bits.
//
// Takes: 1 <= n <= 64; 1 <= group dividing D (the regs route: n <= 16 and a
// power of two <= 256); f32 only; the W stack in shared memory beside the
// route's tile.  On the regs route VEC = 4 (16-byte loads) when n <= 8,
// group % 4 == 0 and the rows are 16-byte aligned (the wrapper checks),
// else VEC = 1.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kRegsNodes = 16;
constexpr int kRegsGroup = kThreads;  // a group fits one block even at VEC = 1
constexpr int kMaxNodes = 64;
constexpr int kWideThreads = 512;     // the tile and stream routes' blocks
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kRouteRegs = 0, kRouteTile = 1, kRouteStream = 2;

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

// ---------------------------------------------------------------------------
// The tile and stream routes (n <= 64, any group)
// ---------------------------------------------------------------------------

// A (node, group) row's combined |buf| -> its scale, as the regs route has it.
template <int SCHEME>
__device__ __forceinline__ float scale_of(float part, float count) {
  return SCHEME == 0 ? part / count : part / 127.0f;
}

// buf -> dequant(quant(buf)) with the row's scale s.
template <int SCHEME>
__device__ __forceinline__ float dequant(float b, float s) {
  if (SCHEME == 0) {
    const float sg = (float)((b > 0.f) - (b < 0.f));
    return __fmul_rn(sg, s);
  }
  const float safe = s > 0.f ? s : 1.f;
  const float q = fminf(fmaxf(rintf(b / safe), -127.f), 127.f);
  return __fmul_rn(q, s);
}

// A warp's combine of its lanes' partials; every lane ends with the same bits.
template <int SCHEME>
__device__ __forceinline__ float warp_combine(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = combine<SCHEME>(a, __shfl_xor_sync(0xffffffffu, a, off));
  return a;
}

// smem: the W stack (R n n), the tile's n * gpt scales, then its x and res,
// n rows of gpt * group columns each.
template <int N, int SCHEME>
__global__ void __launch_bounds__(kWideThreads)
    quantized_gossip_mix_tile_kernel(const float* __restrict__ ws,
                                     const float* x, const float* res,
                                     float* out, float* res_out, int R, int n,
                                     long long D, int group, int gpt, int ef,
                                     int write_res) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* sc_s = w_s + R * n * n;
  float* x_s = sc_s + n * gpt;
  float* r_s = x_s + (size_t)n * gpt * group;
  const int wsize = R * n * n;
  for (int k = threadIdx.x; k < wsize; k += blockDim.x) w_s[k] = ws[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float count = (float)group;
  const long long groups = D / group;
  const long long tiles = (groups + gpt - 1) / gpt;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long g0 = t * gpt;
    const int ng = (int)(groups - g0 < gpt ? groups - g0 : gpt);
    const int cols = ng * group;
    const long long c0 = g0 * group;
    for (int i = 0; i < n; ++i) {
      const float* xr = x + (long long)i * D + c0;
      const float* rr = res + (long long)i * D + c0;
      for (int c = threadIdx.x; c < cols; c += blockDim.x) {
        x_s[i * cols + c] = xr[c];
        r_s[i * cols + c] = rr[c];
      }
    }
    __syncthreads();

    for (int r = 0; r < R; ++r) {
      for (int k = threadIdx.x; k < n * cols; k += blockDim.x)
        x_s[k] = __fadd_rn(x_s[k], r_s[k]);           // buf = x + res
      __syncthreads();
      for (int row = warp; row < n * ng; row += kWideWarps) {
        const int i = row / ng, g = row - i * ng;
        const float* p = x_s + i * cols + g * group;
        float a = 0.f;
        for (int c = lane; c < group; c += 32)
          a = combine<SCHEME>(a, fabsf(p[c]));
        a = warp_combine<SCHEME>(a);
        if (lane == 0) sc_s[row] = scale_of<SCHEME>(a, count);
      }
      __syncthreads();
      // quantize -> dequantize, the error into r_s, and x = W_r @ deq, a
      // column at a time: this thread alone touches column c here
      const float* w = w_s + r * n * n;
      for (int c = threadIdx.x; c < cols; c += blockDim.x) {
        const int g = c / group;
        float acc[N];
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.f;
        for (int j = 0; j < n; ++j) {
          const float b = x_s[j * cols + c];
          const float d = dequant<SCHEME>(b, sc_s[j * ng + g]);
          if (ef) r_s[j * cols + c] = __fsub_rn(b, d);
#pragma unroll
          for (int i = 0; i < N; ++i)
            if (i < n) acc[i] = fmaf(w[i * n + j], d, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (i < n) x_s[i * cols + c] = acc[i];
      }
      __syncthreads();
    }

    for (int i = 0; i < n; ++i) {
      float* xo = out + (long long)i * D + c0;
      float* ro = res_out + (long long)i * D + c0;
      for (int c = threadIdx.x; c < cols; c += blockDim.x) {
        xo[c] = x_s[i * cols + c];
        if (write_res) ro[c] = r_s[i * cols + c];
      }
    }
    __syncthreads();  // the next tile overwrites x_s and r_s
  }
}

// smem: the W stack (R n n), then the group's n scales.
template <int N, int SCHEME>
__global__ void __launch_bounds__(kWideThreads)
    quantized_gossip_mix_stream_kernel(const float* __restrict__ ws,
                                       const float* x, const float* res,
                                       float* out, float* res_out, int R,
                                       int n, long long D, int group, int ef,
                                       int write_res) {
  extern __shared__ float smem[];
  float* w_s = smem;
  float* sc_s = w_s + R * n * n;
  const int wsize = R * n * n;
  for (int k = threadIdx.x; k < wsize; k += blockDim.x) w_s[k] = ws[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float count = (float)group;
  const long long groups = D / group;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long c0 = g * group;
    for (int r = 0; r < R; ++r) {
      // round 0 reads the inputs, later rounds what the last one wrote; with
      // error feedback off the residual stays the input's
      const float* xs = r == 0 ? x : out;
      const float* rs = (r == 0 || !ef) ? res : res_out;
      for (int i = warp; i < n; i += kWideWarps) {
        const float* xr = xs + (long long)i * D + c0;
        const float* rr = rs + (long long)i * D + c0;
        float a = 0.f;
        for (int c = lane; c < group; c += 32)
          a = combine<SCHEME>(a, fabsf(__fadd_rn(xr[c], rr[c])));
        a = warp_combine<SCHEME>(a);
        if (lane == 0) sc_s[i] = scale_of<SCHEME>(a, count);
      }
      __syncthreads();
      const float* w = w_s + r * n * n;
      for (int c = threadIdx.x; c < group; c += blockDim.x) {
        float acc[N];
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] = 0.f;
        for (int j = 0; j < n; ++j) {
          const long long k = (long long)j * D + c0 + c;
          const float b = __fadd_rn(xs[k], rs[k]);
          const float d = dequant<SCHEME>(b, sc_s[j]);
          if (ef) res_out[k] = __fsub_rn(b, d);
#pragma unroll
          for (int i = 0; i < N; ++i)
            if (i < n) acc[i] = fmaf(w[i * n + j], d, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (i < n) out[(long long)i * D + c0 + c] = acc[i];
      }
      __syncthreads();  // the next round reads these columns and sc_s
    }
    if (!ef && write_res) {     // the residual passes through
      for (int i = 0; i < n; ++i)
        for (int c = threadIdx.x; c < group; c += blockDim.x)
          res_out[(long long)i * D + c0 + c] = res[(long long)i * D + c0 + c];
    }
  }
}

// Dynamic shared bytes of a wide route's block.
size_t wide_smem(int route, int R, int n, int group, int gpt) {
  const size_t w = (size_t)R * n * n;
  if (route == kRouteTile)
    return (w + (size_t)n * gpt + 2 * (size_t)n * gpt * group) * sizeof(float);
  return (w + (size_t)n) * sizeof(float);
}

template <typename Kernel>
cudaError_t resident_grid(Kernel kern, int threads, size_t smem,
                          long long work, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * per_sm;
  *blocks = (int)(work < cap ? work : cap);
  return cudaSuccess;
}

template <int N, int SCHEME>
cudaError_t launch_wide(int route, const float* ws, const float* x,
                        const float* res, float* out, float* res_out, int R,
                        int n, long long D, int group, int gpt, int ef,
                        int write_res, cudaStream_t stream) {
  const size_t smem = wide_smem(route, R, n, group, gpt);
  const long long groups = D / group;
  int blocks = 0;
  cudaError_t err;
  if (route == kRouteTile) {
    auto kern = quantized_gossip_mix_tile_kernel<N, SCHEME>;
    err = resident_grid(kern, kWideThreads, smem, (groups + gpt - 1) / gpt,
                        &blocks);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kWideThreads, smem, stream>>>(ws, x, res, out, res_out, R,
                                                 n, D, group, gpt, ef,
                                                 write_res);
  } else {
    auto kern = quantized_gossip_mix_stream_kernel<N, SCHEME>;
    err = resident_grid(kern, kWideThreads, smem, groups, &blocks);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kWideThreads, smem, stream>>>(ws, x, res, out, res_out, R,
                                                 n, D, group, ef, write_res);
  }
  return cudaGetLastError();
}

template <int SCHEME>
cudaError_t dispatch_wide(int route, const float* ws, const float* x,
                          const float* res, float* out, float* res_out, int R,
                          int n, long long D, int group, int gpt, int ef,
                          int write_res, cudaStream_t s) {
  if (n <= 16)
    return launch_wide<16, SCHEME>(route, ws, x, res, out, res_out, R, n, D,
                                   group, gpt, ef, write_res, s);
  if (n <= 32)
    return launch_wide<32, SCHEME>(route, ws, x, res, out, res_out, R, n, D,
                                   group, gpt, ef, write_res, s);
  return launch_wide<64, SCHEME>(route, ws, x, res, out, res_out, R, n, D,
                                 group, gpt, ef, write_res, s);
}

template <typename Kernel>
cudaError_t kernel_resources(Kernel kern, int* out) {
  cudaFuncAttributes a = {};
  const cudaError_t err = cudaFuncGetAttributes(&a, kern);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return err;
}

template <int N>
cudaError_t wide_resources(int route, int scheme, int* out) {
  if (route == kRouteTile)
    return scheme == 0
               ? kernel_resources(quantized_gossip_mix_tile_kernel<N, 0>, out)
               : kernel_resources(quantized_gossip_mix_tile_kernel<N, 1>, out);
  return scheme == 0
             ? kernel_resources(quantized_gossip_mix_stream_kernel<N, 0>, out)
             : kernel_resources(quantized_gossip_mix_stream_kernel<N, 1>, out);
}

}  // namespace

// ws: (R, n, n) f32; x, res, out, res_out: (n, D) contiguous f32, out may be
// x and res_out may be res; 1 <= n <= 64; group >= 1 dividing D; scheme 0 =
// sign, 1 = int8; ef: error feedback on/off; write_res: store res_out (0 only
// when res is unchanged and res_out == res); route 0 = regs (n <= 16, group a
// power of two <= 256, vec 1 or 4), 1 = tile (gpt groups a block), 2 =
// stream.  Launches on `stream` and returns the launch's cudaError_t (0 =
// queued).
extern "C" int quantized_gossip_mix_launch(const void* ws, const void* x,
                                           const void* res, void* out,
                                           void* res_out, int R, int n,
                                           long long D, int group, int scheme,
                                           int ef, int write_res, int route,
                                           int vec, int gpt, void* stream) {
  if (R < 1 || n < 1 || n > kMaxNodes || D < 1 || group < 1 ||
      D % group != 0 || (scheme != 0 && scheme != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  const float* xp = static_cast<const float*>(x);
  const float* rp = static_cast<const float*>(res);
  float* op = static_cast<float*>(out);
  float* rop = static_cast<float*>(res_out);
  if (route == kRouteRegs) {
    if (n > kRegsNodes || group > kRegsGroup || (group & (group - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    if (scheme == 0)
      return (int)dispatch<0>(w, xp, rp, op, rop, R, n, D, group, ef,
                              write_res, vec, s);
    return (int)dispatch<1>(w, xp, rp, op, rop, R, n, D, group, ef, write_res,
                            vec, s);
  }
  if (route != kRouteTile && route != kRouteStream)
    return (int)cudaErrorInvalidValue;
  if (route == kRouteTile && (gpt < 1 || (D / group) < 1))
    return (int)cudaErrorInvalidValue;
  if (scheme == 0)
    return (int)dispatch_wide<0>(route, w, xp, rp, op, rop, R, n, D, group,
                                 gpt, ef, write_res, s);
  return (int)dispatch_wide<1>(route, w, xp, rp, op, rop, R, n, D, group, gpt,
                               ef, write_res, s);
}

// The compiled tile or stream kernel a launch of (route, n, scheme) runs:
// out[0] registers and out[1] spilled (local) bytes a thread, out[2] static
// shared bytes, out[3] threads a block.
extern "C" int quantized_gossip_mix_resources(int route, int n, int scheme,
                                              int* out) {
  out[3] = kWideThreads;
  if ((route != kRouteTile && route != kRouteStream) || n < 1 ||
      n > kMaxNodes || (scheme != 0 && scheme != 1))
    return (int)cudaErrorInvalidValue;
  if (n <= 16) return (int)wide_resources<16>(route, scheme, out);
  if (n <= 32) return (int)wide_resources<32>(route, scheme, out);
  return (int)wide_resources<64>(route, scheme, out);
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* quantized_gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
