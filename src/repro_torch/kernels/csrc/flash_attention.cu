// Causal / sliding-window GQA attention with an online softmax, for Hopper
// (sm_90a):
//
//     o[b, q, h] = softmax_k(mask(q, k) ? q[b, q, h] . k[b, k, h / G] * scale
//                                       : -1e30) . v[b, :, h / G]
//
// q (B, Sq, H, hd), k and v (B, Sk, KV, hd), G = H / KV query heads per KV
// head, o (B, Sq, H, hd) in q's dtype (f32 or bf16).  A key k is masked for
// query row q when causal and k > q, or when a window w is set and
// k <= q - w.  scale = 1 / sqrt(hd).
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 91).  There the grid is (B, H, q-blocks,
// k-blocks) and the k-block axis runs in order on one core, carrying the
// softmax state (m, l, acc) in VMEM scratch from grid step to grid step.
// Hopper's blocks run in no order, so here one block owns one (b, h, q-tile)
// and walks the k-tiles in a loop, the state in registers.
//
// Numerics follow the TPU kernel: scores in f32, masked scores set to the
// finite -1e30 (so a row with no valid key averages v, as the reference
// does), m starts at -1e30, p = exp(s - m_new), alpha = exp(m_prev - m_new),
// l summed from the f32 p, and p rounded to v's dtype before the PV product;
// the output is acc / max(l, 1e-30).  Keys past Sk (the ragged last tile)
// are left out altogether (p = 0), not masked.
//
// Skipped tiles: k-tiles that lie wholly above the causal diagonal or wholly
// before the window of every row in the q-tile are not visited.  That is
// exact: a masked key adds exp(-1e30 - m) = 0 once a row has seen a valid
// key, and the junk a fully masked first tile leaves in l and acc is scaled
// by alpha = exp(-1e30 - m_valid) = 0.  A row with no valid key at all gets
// the mean of v over all Sk keys from the reference, so a q-tile holding
// such a row (only possible with a window and Sq > Sk) visits every tile.
//
// What bounds it on this card: operations.  At the serve path's prefill
// (1, 1920, 16, 64) bf16, causal, the QK^T and PV products are ~7.5 GFLOP
// against ~16 MB moved.  This first version computes both products with
// f32 FMAs out of shared memory (no tensor cores), so it runs far from the
// 989 TFLOP/s bf16 bound; TMA, wgmma and an FA3-style pipeline are the
// later redesign.  What the design does: a block of 128 threads holds a
// 64-row q-tile and 64-key K and V tiles in shared memory as f32 (rows
// padded so that 16-byte reads hit distinct banks), read from device memory
// as 16-byte vectors with several in flight per thread; a thread owns a 4 x 8
// patch of the score tile (4 rows, keys tx + 8j) and 4 rows x hd/8 columns
// of the output, reads q and k as float4 along hd, and reduces each row's
// max and sum over the 8 threads of the row with warp shuffles.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 16 row groups of 4 rows x 8 column lanes
constexpr int kLDP = kBK + 4;   // padded row stride of the P tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridYZ = 65535;

template <int HD>
constexpr int smem_floats() {
  return 2 * kBQ * (HD + 4) + kBK * HD + kBQ * kLDP;  // Q, K, V, P
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int Sq,
                           int Sk, int H, int KV, int causal, int window,
                           float scale) {
  static_assert(kBQ == kBK, "Q and K tiles share a row stride");
  constexpr int LD = HD + 4;       // Q and K rows: float4-aligned, padded
  constexpr int NC = HD / 32;      // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * HD;

  const int t = threadIdx.x;
  const int tx = t & 7;            // key lane / output column lane
  const int ty = t >> 3;           // row group: rows 4 ty .. 4 ty + 3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * HD;       // stride of q between rows
  const long long k_row = (long long)KV * HD;
  const T* qb = q + ((long long)b * Sq * H + h) * HD;
  const T* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((long long)b * Sk * KV + kvh) * HD;

  load_tiles<kThreads, T, HD, kBQ, 4, false>(qb, nullptr, q_row, q0, Sq, sQ,
                                             LD, nullptr, 0);

  // the k-tiles this q-tile visits (see the note at the top)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int lo = 0, hi = Sk - 1;
  const bool row_without_key = window > 0 && q_last - window + 1 > Sk - 1;
  if (!row_without_key) {
    if (window > 0) lo = max(0, q0 - window + 1);
    if (causal) hi = min(q_last, Sk - 1);
  }

  float m[4], l[4], acc[4][NC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  for (int kt = lo / kBK; kt <= hi / kBK; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tiles<kThreads, T, HD, kBK, 4, true>(kb, vb, k_row, k0, Sk, sK, LD,
                                              sV, HD);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(4 * ty + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&sK[(tx + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + tx + 8 * j;
        bool valid = !(causal && kp > qp);
        if (window > 0 && kp <= qp - window) valid = false;
        // a key past Sk is no key at all: exp(-inf - m) = 0 below
        s[i][j] = kp >= Sk ? -INFINITY : (valid ? s[i][j] * scale : kNegInf);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(4 * ty + i) * kLDP + tx + 8 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(4 * ty + i) * kLDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &sV[(c + cc) * HD + 32 * n + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0   ? pv[i].x
                            : cc == 1 ? pv[i].y
                            : cc == 2 ? pv[i].z
                                      : pv[i].w;
            acc[i][4 * n + 0] = fmaf(p, vv.x, acc[i][4 * n + 0]);
            acc[i][4 * n + 1] = fmaf(p, vv.y, acc[i][4 * n + 1]);
            acc[i][4 * n + 2] = fmaf(p, vv.z, acc[i][4 * n + 2]);
            acc[i][4 * n + 3] = fmaf(p, vv.w, acc[i][4 * n + 3]);
          }
        }
      }
    }
  }

  T* ob = o + ((long long)b * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ob[qp * q_row + 32 * n + 4 * tx + e] =
            from_f32<T>(acc[i][4 * n + e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KV, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KV, int hd, int causal,
                     int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Sk, KV, hd), o: (B, Sq, H, hd), all
// contiguous and of one dtype, f32 (dtype 0) or bf16 (dtype 1); hd 32, 64
// or 128; KV divides H.  window 0 = none.  Launches on `stream` and returns
// the launch's cudaError_t (0 = queued).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV != 0 || window < 0 ||
      H > kMaxGridYZ || B > kMaxGridYZ)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal,
                                window, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd,
                                        causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
