// Single-token decode attention over a ring-buffered KV cache, for Hopper
// (sm_90a):
//
//     o[b, j * G + g] = softmax_c(valid(c) ? (q[b, j, g] . k[b, c, j]) * scale
//                                          : -1e30) . v[b, :, j]
//
// q (B, 1, J, G, hd), k and v (B, C, J, hd), kpos (C,) int32 (the absolute
// position of each cache slot, -1 for an empty one), pos the query's
// absolute position; o (B, 1, J * G, hd) in q's dtype (f32 or bf16).  Slot
// c is valid when kpos[c] >= 0, kpos[c] <= pos and, with a window w,
// kpos[c] > pos - w.  scale = 1 / sqrt(hd).
//
// Replaces the TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 86).  There the grid is (B, J, k-blocks) with the
// k-block axis in order on one core, the G query rows' softmax state in VMEM
// scratch.  Here one block owns one (b, j): it keeps the G query rows in
// shared memory and walks the cache in tiles of 128 slots, the state (m, l
// per row in shared memory, acc in registers) carried through the loop.
//
// Numerics follow the TPU kernel: f32 scores, invalid slots at the finite
// -1e30 (a row with no valid slot averages v over all C slots, as the
// reference does), m from -1e30, l summed from the f32 p, p rounded to v's
// dtype before the PV product, output acc / max(l, 1e-30).
//
// What bounds it on this card: bytes.  Every cache slot's k and v are read
// once, 2 * C * hd values per (b, j), against 4 * G * C * hd flops: at the
// serve path's decode (C = 2048, J = 16, G = 1, hd = 64, bf16) 8.4 MB, 2.5 us
// at 3.35 TB/s.  What the design does: a tile's k and v are read as 16-byte
// vectors (consecutive threads, consecutive vectors of a row), 8 of each in
// flight per thread before the first is stored, and staged in shared memory
// as f32 (a first version that loaded one value at a time, each waiting on
// the last, took 0.141 ms at the serve path's shape on an H100, 5x its plain
// version); thread c of the tile computes slot c's scores for all G
// rows; one warp per row takes the tile's max and sum with shuffles; for
// the PV product a thread owns one column of hd for a share of the rows.
// B * J blocks (16 at the serve path) leave most of the 132 SMs idle: a
// split over C with a combine pass (flash-decoding) is the later redesign.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int kBK = 128;        // cache slots per tile, one per thread
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;       // query rows per KV head the kernel takes
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

template <int HD>
constexpr int smem_floats() {
  // Q (G rows), K (padded rows), V, S/P (G x kBK), m, l, alpha
  return kMaxG * HD + kBK * (HD + 4) + kBK * HD + kMaxG * kBK + 3 * kMaxG;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kpos, T* __restrict__ o,
                            int C, int J, int G, int pos, int window,
                            float scale) {
  constexpr int LDK = HD + 4;             // float4-aligned, padded K rows
  constexpr int NG = kThreads / HD;       // row shares in the PV product
  constexpr int RPT = (kMaxG + NG - 1) / NG;  // rows a thread may own
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;
  float* sK = sQ + kMaxG * HD;
  float* sV = sK + kBK * LDK;
  float* sS = sV + kBK * HD;
  float* sM = sS + kMaxG * kBK;
  float* sL = sM + kMaxG;
  float* sA = sL + kMaxG;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int j = blockIdx.x, b = blockIdx.y;
  const long long row = (long long)J * HD;  // stride of k between slots
  const T* qb = q + ((long long)b * J + j) * G * HD;
  const T* kb = k + (long long)b * C * row + (long long)j * HD;
  const T* vb = v + (long long)b * C * row + (long long)j * HD;

  for (int i = t; i < G * HD; i += kThreads) sQ[i] = to_f32(qb[i]);
  if (t < G) {
    sM[t] = kNegInf;
    sL[t] = 0.f;
  }
  const int d = t % HD, g0 = t / HD;    // PV: column d, rows g0 + NG r
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tiles<kThreads, T, HD, kBK, 8, true>(kb, vb, row, c0, C, sK, LDK,
                                              sV, HD);
    __syncthreads();

    // scores of slot c0 + t for every row; -inf past C (no slot at all)
    {
      const int c = c0 + t;
      bool valid = false;
      if (c < C) {
        const int kp = kpos[c];
        valid = kp >= 0 && kp <= pos && (window == 0 || kp > pos - window);
      }
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll 8
        for (int e = 0; e < HD; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&sQ[g * HD + e]);
          const float4 kv = *reinterpret_cast<const float4*>(&sK[t * LDK + e]);
          s = fmaf(qv.x, kv.x, s);
          s = fmaf(qv.y, kv.y, s);
          s = fmaf(qv.z, kv.z, s);
          s = fmaf(qv.w, kv.w, s);
        }
        sS[g * kBK + t] = c >= C ? -INFINITY : (valid ? s * scale : kNegInf);
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int g = warp; g < G; g += kWarps) {
      float sv[kBK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        sv[i] = sS[g * kBK + lane + 32 * i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const float p = expf(sv[i] - m_new);
        sum += p;
        sS[g * kBK + lane + 32 * i] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sA[g] = alpha;
        sL[g] = alpha * sL[g] + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int g = g0 + NG * r;
      if (g >= G) break;
      float a = acc[r] * sA[g];
      const float* p = sS + g * kBK;
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) a = fmaf(p[c], sV[c * HD + d], a);
      acc[r] = a;
    }
  }
  __syncthreads();

  T* ob = o + ((long long)b * J + j) * G * HD;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int g = g0 + NG * r;
    if (g >= G) break;
    ob[g * HD + d] = from_f32<T>(acc[r] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kpos, void* o, int B, int C, int J, int G,
                   int pos, int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(J, B);
  decode_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kpos, static_cast<T*>(o), C, J, G, pos,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kpos, void* o, int B, int C, int J, int G,
                     int hd, int pos, int window, float scale,
                     cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, kpos, o, B, C, J, G, pos, window, scale,
                           s);
    case 64:
      return launch<T, 64>(q, k, v, kpos, o, B, C, J, G, pos, window, scale,
                           s);
    case 128:
      return launch<T, 128>(q, k, v, kpos, o, B, C, J, G, pos, window, scale,
                            s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, 1, J, G, hd), k and v: (B, C, J, hd), o: (B, 1, J * G, hd), all
// contiguous and of one dtype, f32 (dtype 0) or bf16 (dtype 1); kpos: (C,)
// int32; hd 32, 64 or 128; 1 <= G <= 16; window 0 = none.  Launches on
// `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kpos,
                                       void* o, int B, int C, int J, int G,
                                       int hd, int pos, int window,
                                       float scale, int dtype, void* stream) {
  if (B < 1 || C < 1 || J < 1 || G < 1 || G > kMaxG || window < 0 ||
      B > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kpos);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, kp, o, B, C, J, G, hd, pos, window,
                                scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, kp, o, B, C, J, G, hd, pos,
                                        window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
