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
// Two kernels, one per dtype (a route by dtype, not a fallback: a bf16 call
// the tensor-core kernel does not take raises):
//
// * bf16: tensor cores.  A block of 288 threads owns a 128-row q-tile and
//   walks 128-key k-tiles (the TPU kernel's block_q = block_k = 128).  One
//   producer warp issues TMA loads, the Q tile once and the K and V tiles
//   into a 2-stage ring, K and V each completing on its own mbarrier
//   (full) and each refilled once the consumers release it (empty): a K
//   stage as soon as its S product is done, so the next K is in flight
//   early.  Two consumer warpgroups own 64 query rows each: S = Q K^T by
//   wgmma m64n128k16 with both operands in shared memory (f32 scores from
//   bf16 inputs, as the Pallas dot_general with preferred_element_type =
//   f32), the online softmax in registers on the accumulator fragment, P
//   packed to bf16 in registers as the A operand of O += P V (wgmma
//   m64n{hd}k16), V read from shared memory as an MN-major B operand, so it
//   needs no transposed copy.  Inside a warpgroup, tile i's S product and
//   tile i - 1's PV product are issued together, and tile i's softmax runs
//   while the PV product finishes (a first version that waited on each
//   product in turn took 0.050 ms at the serve path's prefill shape on an
//   H100, this one 0.029).  The tiles are TMA boxes of 64 (or, at hd 32, 32)
//   columns with the matching swizzle (128 B, or 64 B), two boxes per tile
//   at hd 128; the wgmma descriptors name the same swizzle.  Blocks take the
//   heads fastest and the q-tiles from the last (the longest causal walk)
//   to the first.  At hd 192 (nemotron-4-340b) and 256 (recurrentgemma-2b)
//   the tiles halve: a block of 160 threads, one consumer warpgroup of 64
//   query rows, 64-key tiles in a 3-stage ring, three or four boxes a tile
//   (see Cfg); the rest is the same code.
// * f32: the SIMT kernel of the first port.  wgmma on f32 is TF32, too
//   coarse for the f32 tolerance; a block of 128 threads holds a 64-row
//   q-tile and 64-key K and V tiles in shared memory, products as f32 FMAs.
//
// Numerics follow the TPU kernel: scores in f32, masked scores set to the
// finite -1e30 (so a row with no valid key averages v, as the reference
// does), m starts at -1e30, p = exp(s - m_new), alpha = exp(m_prev - m_new),
// l summed from the f32 p, and p rounded to v's dtype before the PV product;
// the output is acc / max(l, 1e-30).  The bf16 kernel takes the exponentials
// in base 2 on scores scaled by log2(e) (the same p to ~1e-7).  Keys past Sk
// (the ragged last tile; TMA reads them as zeros) are left out altogether
// (p = 0), not masked; so are the padding rows of a q-tile past Sq.
//
// Skipped tiles: k-tiles that lie wholly above the causal diagonal or wholly
// before the window of every row in the q-tile are not visited.  That is
// exact: a masked key adds exp(-1e30 - m) = 0 once a row has seen a valid
// key, and the junk a fully masked first tile leaves in l and acc is scaled
// by alpha = exp(-1e30 - m_valid) = 0.  A row with no valid key at all gets
// the mean of v over all Sk keys from the reference, so a q-tile holding
// such a row (only possible with a window and Sq > Sk) visits every tile.
//
// What bounds it on this card: operations.  At the qwen1.5-0.5b serve
// path's prefill (1, 1920, 16, 64) bf16, causal, the QK^T and PV products
// are 7.55 GFLOP, 7.6 us at the 989 TFLOP/s of bf16 wgmma, against ~16 MB
// moved (4.7 us); at recurrentgemma-2b's (1, 3968, 10 over 1 KV head, 256)
// bf16 with a 2048-key window, 61.8 GFLOP, 62.5 us, against ~22 MB; at
// nemotron-4-340b's (1, 1920, 96 over 8 KV heads, 192) bf16, causal, 136.0
// GFLOP, 137.5 us, against ~153 MB.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py);
// the TMA descriptors are encoded on the host by cuTensorMapEncodeTiled,
// looked up at run time (hopper_common.cuh's encode_tiled), so the library
// links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGridYZ = 65535;

// ==== f32: the SIMT kernel ==================================================

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 128;   // 16 row groups of 4 rows x 8 column lanes
constexpr int kLDP = kBK + 4;   // padded row stride of the P tile

template <int HD>
constexpr int smem_floats() {
  return 2 * kBQ * (HD + 4) + kBK * HD + kBQ * kLDP;  // Q, K, V, P
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, int Sq, int Sk, int H,
                               int KV, int causal, int window, float scale) {
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
  const float* qb = q + ((long long)b * Sq * H + h) * HD;
  const float* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((long long)b * Sk * KV + kvh) * HD;

  load_tiles<kThreads, HD, kBQ, 4, false>(qb, nullptr, q_row, q0, Sq, sQ,
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
    load_tiles<kThreads, HD, kBK, 4, true>(kb, vb, k_row, k0, Sk, sK, LD,
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
        sP[(4 * ty + i) * kLDP + tx + 8 * j] = p;
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

  float* ob = o + ((long long)b * Sq * H + h) * HD;
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
            acc[i][4 * n + e] * inv;
  }
}


// ==== bf16: tensor cores ====================================================

namespace tc {

// The tiling by head_dim.  Up to hd 128: 128-row q-tiles of two consumer
// warpgroups, 128-key tiles, a 2-stage ring.  At hd 256 a 128 x 256 tile is
// 64 KB and an O accumulator of 64 rows x 256 f32 takes 128 registers a
// thread, which beside a 64 x 128 S fragment exceeds the 168 registers that
// 288 threads leave: one consumer warpgroup of 64 rows, 64-key tiles (an S
// fragment of 32 registers) and a 3-stage ring (Q 32 KB + 3 x (K + V) of
// 32 KB each = 224 KB).  hd 192 takes the same tiling: its O accumulator
// (96 registers) with S (64) and P (32) would still pass 168 beside a
// second warpgroup, and its ring is Q 24 KB + 3 x 48 KB = 168 KB.
template <int HD>
struct Cfg {
  static constexpr bool WIDE = HD > 128;
  static constexpr int BM = WIDE ? 64 : 128;        // query rows per block
  static constexpr int BN = WIDE ? 64 : 128;        // keys per tile
  static constexpr int STAGES = WIDE ? 3 : 2;       // K / V ring
  static constexpr int CONSUMERS = 2 * BM;          // a warpgroup / 64 rows
  static constexpr int THREADS = CONSUMERS + 32;    // + the producer warp
  static constexpr int NS = BN / 2;                 // S fragment per thread
  static constexpr int KSTEPS = BN / 16;            // k-steps of PV
  static constexpr int BC = HD < 64 ? HD : 64;      // columns per TMA box
  static constexpr int NB = HD / BC;                // boxes per tile
  static constexpr int ROW_BYTES = BC * 2;          // one swizzle row
  static constexpr int BOX_BYTES = BN * ROW_BYTES;  // BM == BN rows
  static constexpr int TILE_BYTES = NB * BOX_BYTES;
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // B128, B64
  static constexpr int SBO = 8 * ROW_BYTES;         // next 8-row group
  // Q, K and V per stage, 4 STAGES + 1 mbarriers; 1024 to align the tiles
  static constexpr int SMEM_BYTES =
      1024 + TILE_BYTES * (1 + 2 * STAGES) + 128;
  static_assert(BM == BN, "Q and K tiles share the TMA box");
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
};

// A wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused by these swizzled layouts), stride byte offset `sbo` between
// 8-row groups, swizzle `layout`.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from reading accumulators before the wgmma that
// writes them has completed.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128, f32) {+}= A (64 x 16) . B^T (16 x 128), A and B in shared
// memory, both K-major.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {+}= A (64 x 16) . B^T (16 x 64), A and B in shared
// memory, both K-major.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64), B in
// shared memory, MN-major (its 64 columns contiguous).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers) . B (16 x 32), B in
// shared memory, MN-major (its 32 columns contiguous).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The online-softmax state of a thread's two rows of the S fragment: a
// (fragment values 4 j, 4 j + 1) and b = a + 8 (4 j + 2, 4 j + 3).
struct Rows {
  float m_a, m_b, l_a, l_b;
};

// One tile's raw scores s (q.k) to p = 2^(s scale log2(e) - m_new), in
// place: masks (a whole tile, every key valid for every row, takes none),
// row max over the quad, m, l (this thread's columns only; the quad's sum
// is taken at the end) and the rows' alpha = 2^(m_prev - m_new).  N = the
// tile's keys / 2 fragment values, 4 per block of 8 keys.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], Rows& r,
                                             float& alpha_a, float& alpha_b,
                                             bool whole, int k0, int row_a,
                                             int cq, int Sk, int causal,
                                             int window, float c) {
  float mx_a = kNegInf, mx_b = kNegInf;
  if (whole) {
    // max(s) c == max(s c) for c > 0: scale the max, fold c into the exp
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx_a *= c;
    mx_b *= c;
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * j + e];
        const int kp = k0 + 8 * j + cq + (e & 1);
        const int qp = row_a + (e < 2 ? 0 : 8);
        bool valid = !(causal && kp > qp);
        if (window > 0 && kp <= qp - window) valid = false;
        x = kp >= Sk ? -INFINITY : (valid ? x * c : kNegInf);
        if (e < 2)
          mx_a = fmaxf(mx_a, x);
        else
          mx_b = fmaxf(mx_b, x);
      }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(r.m_a, mx_a), mn_b = fmaxf(r.m_b, mx_b);
  alpha_a = ex2(r.m_a - mn_a);
  alpha_b = ex2(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  const float cs = whole ? c : 1.f;   // the masked scores are scaled
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], cs, -mn_a));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], cs, -mn_a));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], cs, -mn_b));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], cs, -mn_b));
    sum_a += s[4 * j] + s[4 * j + 1];
    sum_b += s[4 * j + 2] + s[4 * j + 3];
  }
  r.l_a = alpha_a * r.l_a + sum_a;
  r.l_b = alpha_b * r.l_b + sum_b;
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, 1)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                              int H, int KV, int causal, int window,
                              float scale_log2) {
  using Cf = Cfg<HD>;
  constexpr int BC = Cf::BC, NB = Cf::NB, kBM = Cf::BM, kBN = Cf::BN;
  constexpr int kStages = Cf::STAGES, kConsumers = Cf::CONSUMERS;
  constexpr int KSTEPS = Cf::KSTEPS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = base;
  // stage st: K at sK(st), V right after it
  auto sK = [&](int st) { return base + Cf::TILE_BYTES * (1 + 2 * st); };
  uint64_t* full_k = reinterpret_cast<uint64_t*>(
      base + Cf::TILE_BYTES * (1 + 2 * kStages));
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* qbar = empty_v + kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int kvh = h / (H / KV);

  // the k-tiles this q-tile visits (see the note at the top)
  const int q_last = min(q0 + kBM, Sq) - 1;
  int lo = 0, hi = Sk - 1;
  const bool row_without_key = window > 0 && q_last - window + 1 > Sk - 1;
  if (!row_without_key) {
    if (window > 0) lo = max(0, q0 - window + 1);
    if (causal) hi = min(q_last, Sk - 1);
  }
  const int kt_lo = lo / kBN, n_tiles = hi / kBN - kt_lo + 1;

  const int t = threadIdx.x;
  if (t == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], kConsumers / 32);   // one arrival per warp
      mbar_init(&empty_v[st], kConsumers / 32);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (t >= kConsumers) {   // the producer warp: one thread issues the TMA
    if (t == kConsumers) {
      mbar_arrive_expect_tx(qbar, Cf::TILE_BYTES);
      for (int x = 0; x < NB; ++x)
        tma_load_4d(sQ + x * Cf::BOX_BYTES, &tq, qbar, x * BC, h, q0, b);
      // K and V of tile i into stage i % kStages, each once the consumers
      // have released what that stage held (tile i - kStages)
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, k0 = (kt_lo + i) * kBN;
        const uint32_t parity = (i / kStages - 1) & 1;
        if (i >= kStages) mbar_wait(&empty_k[st], parity);
        mbar_arrive_expect_tx(&full_k[st], Cf::TILE_BYTES);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(sK(st) + x * Cf::BOX_BYTES, &tk, &full_k[st], x * BC,
                      kvh, k0, b);
        if (i >= kStages) mbar_wait(&empty_v[st], parity);
        mbar_arrive_expect_tx(&full_v[st], Cf::TILE_BYTES);
        for (int x = 0; x < NB; ++x)
          tma_load_4d(sK(st) + Cf::TILE_BYTES + x * Cf::BOX_BYTES, &tv,
                      &full_v[st], x * BC, kvh, k0, b);
      }
    }
  } else {
    // a consumer warpgroup: rows q0 + 64 wg .. + 63; this thread's two rows
    // in the accumulator fragments are row_a and row_a + 8
    const int wg = t / 128, lane = t % 32;
    const int row_a = q0 + wg * 64 + (t % 128) / 32 * 16 + lane / 4;
    const int row_b = row_a + 8;
    const int wrow0 = q0 + wg * 64, wrow1 = wrow0 + 63;
    const int cq = 2 * (lane % 4);   // first column of an n8 block's pair
    const uint32_t q_addr = smem_addr(sQ) + wg * 64 * Cf::ROW_BYTES;
    float oacc[NB][BC / 2];
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) oacc[x][i] = 0.f;
    float s[Cf::NS];       // S of one tile, then its p
    uint32_t pa[KSTEPS][4];   // p as bf16 A fragments: keys 16 kk .. + 15
    Rows rows = {kNegInf, kNegInf, 0.f, 0.f};
    float alpha_a, alpha_b;

    // S = Q K_i^T (64 x kBN per warpgroup), HD / 16 k-steps
    auto issue_qk = [&](int i) {
      const uint32_t k_addr = smem_addr(sK(i % kStages));
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off =
            (ks * 16 / BC) * Cf::BOX_BYTES + (ks * 16 % BC) * 2;
        const uint64_t da = desc(q_addr + off, Cf::SBO, Cf::LAYOUT);
        const uint64_t db = desc(k_addr + off, Cf::SBO, Cf::LAYOUT);
        if constexpr (kBN == 128)
          wgmma_m64n128k16_ss(s, da, db, ks > 0);
        else
          wgmma_m64n64k16_ss(s, da, db, ks > 0);
      }
      wg_commit();
    };
    // O += P V_i: KSTEPS k-steps of 16 keys, V's rows 16 kk .. in each box
    auto issue_pv = [&](int i) {
      const uint32_t v_addr = smem_addr(sK(i % kStages)) + Cf::TILE_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int x = 0; x < NB; ++x) {
          const uint64_t db =
              desc(v_addr + x * Cf::BOX_BYTES + kk * 16 * Cf::ROW_BYTES,
                   Cf::SBO, Cf::LAYOUT);
          if constexpr (BC == 64)
            wgmma_m64n64k16_rs(oacc[x], pa[kk], db);
          else
            wgmma_m64n32k16_rs(oacc[x], pa[kk], db);
        }
      wg_commit();
    };
    // the PV product of a tile has completed: its A fragments stay live until
    // here, so the compiler reuses none of their registers while it runs
    auto pv_done = [&]() {
#pragma unroll
      for (int x = 0; x < NB; ++x) reg_fence(oacc[x]);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          asm volatile("" : "+r"(pa[kk][e])::"memory");
    };
    auto softmax = [&](int i) {
      const int k0 = (kt_lo + i) * kBN;
      const bool whole = k0 + kBN <= Sk &&
                         (!causal || k0 + kBN - 1 <= wrow0) &&
                         (window == 0 || k0 > wrow1 - window);
      softmax_tile(s, rows, alpha_a, alpha_b, whole, k0, row_a, cq, Sk, causal,
                   window, scale_log2);
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);   // this warp is done with the stage
    };

    // Tile i's S product runs on the tensor cores while tile i - 1's PV
    // product does, and tile i's softmax while tile i - 1's PV product
    // finishes; O is rescaled by tile i's alpha once that product is done.
    mbar_wait(qbar, 0);
    mbar_wait(&full_k[0], 0);
    issue_qk(0);
    wg_wait<0>();
    reg_fence(s);
    release(&empty_k[0]);
    softmax(0);   // O is still 0: its alpha is not applied
    pack_p();
    for (int i = 1; i < n_tiles; ++i) {
      const int st = i % kStages, prev = (i - 1) % kStages;
      mbar_wait(&full_k[st], (i / kStages) & 1);
      issue_qk(i);
      mbar_wait(&full_v[prev], ((i - 1) / kStages) & 1);
      issue_pv(i - 1);
      wg_wait<1>();   // S of tile i
      reg_fence(s);
      release(&empty_k[st]);
      softmax(i);
      wg_wait<0>();   // PV of tile i - 1
      pv_done();
      release(&empty_v[prev]);
#pragma unroll
      for (int x = 0; x < NB; ++x)
#pragma unroll
        for (int j = 0; j < BC / 8; ++j) {
          oacc[x][4 * j] *= alpha_a;
          oacc[x][4 * j + 1] *= alpha_a;
          oacc[x][4 * j + 2] *= alpha_b;
          oacc[x][4 * j + 3] *= alpha_b;
        }
      pack_p();
    }
    const int last = n_tiles - 1;
    mbar_wait(&full_v[last % kStages], (last / kStages) & 1);
    issue_pv(last);
    wg_wait<0>();
    pv_done();

    // l over the quad's columns, then o = acc / max(l, 1e-30) as bf16
    float l_a = rows.l_a, l_b = rows.l_b;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    const long long q_row = (long long)H * HD;
    __nv_bfloat16* ob = o + (long long)b * Sq * q_row + (long long)h * HD;
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        const int col = x * BC + 8 * j + cq;
        if (row_a < Sq)
          *reinterpret_cast<uint32_t*>(ob + row_a * q_row + col) = pack_bf16(
              oacc[x][4 * j] * inv_a, oacc[x][4 * j + 1] * inv_a);
        if (row_b < Sq)
          *reinterpret_cast<uint32_t*>(ob + row_b * q_row + col) = pack_bf16(
              oacc[x][4 * j + 2] * inv_b, oacc[x][4 * j + 3] * inv_b);
      }
  }
}

// The (hd, heads, S, B) view of a contiguous (B, S, heads, hd) bf16 tensor,
// cut in boxes of `box` columns x `rows` rows of one head and batch; rows
// past S read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
                int B, int box, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t boxes[4] = {(cuuint32_t)box, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, boxes, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, float scale, cudaStream_t stream) {
  using Cf = Cfg<HD>;
  constexpr int smem = Cf::SMEM_BYTES;
  cudaError_t err = allow_smem<flash_attention_tc_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, HD, H, Sq, B, Cf::BC, Cf::BM) ||
      !tensor_map(&tk, k, HD, KV, Sk, B, Cf::BC, Cf::BN) ||
      !tensor_map(&tv, v, HD, KV, Sk, B, Cf::BC, Cf::BN))
    return cudaErrorInvalidValue;
  const dim3 grid(H, (Sq + Cf::BM - 1) / Cf::BM, B);
  flash_attention_tc_kernel<HD><<<grid, Cf::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, causal,
      window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KV, int causal,
                       int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = allow_smem<flash_attention_f32_kernel<HD>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Sq, H, hd), k and v: (B, Sk, KV, hd), o: (B, Sq, H, hd), all
// contiguous, 16-byte aligned and of one dtype: f32 (dtype 0, the SIMT
// kernel) or bf16 (dtype 1, the tensor-core kernel); hd 32, 64, 128, 192
// or 256; KV divides H.  window 0 = none.  Launches on `stream` and returns
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
#define FLASH_ARGS q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, s
  if (dtype == 0) {
    if (hd == 32) return (int)launch_f32<32>(FLASH_ARGS);
    if (hd == 64) return (int)launch_f32<64>(FLASH_ARGS);
    if (hd == 128) return (int)launch_f32<128>(FLASH_ARGS);
    if (hd == 192) return (int)launch_f32<192>(FLASH_ARGS);
    if (hd == 256) return (int)launch_f32<256>(FLASH_ARGS);
  } else if (dtype == 1) {
    if (hd == 32) return (int)tc::launch<32>(FLASH_ARGS);
    if (hd == 64) return (int)tc::launch<64>(FLASH_ARGS);
    if (hd == 128) return (int)tc::launch<128>(FLASH_ARGS);
    if (hd == 192) return (int)tc::launch<192>(FLASH_ARGS);
    if (hd == 256) return (int)tc::launch<256>(FLASH_ARGS);
  }
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// The resources of the kernel that (hd, dtype) takes: registers and local
// (spilled) bytes per thread, static and dynamic shared bytes per block,
// threads per block, into out[0..4].  Returns 0, or a cudaError_t.
extern "C" int flash_attention_resources(int hd, int dtype, int* out) {
#define FLASH_CASE(HD)                                                    \
  if (hd == HD) {                                                         \
    out[4] = dtype == 0 ? kThreads : tc::Cfg<HD>::THREADS;                \
    return dtype == 0                                                     \
               ? (int)kernel_resources<flash_attention_f32_kernel<HD>>(   \
                     smem_floats<HD>() * (int)sizeof(float), out)         \
               : (int)kernel_resources<tc::flash_attention_tc_kernel<HD>>( \
                     tc::Cfg<HD>::SMEM_BYTES, out);                        \
  }
  if (dtype == 0 || dtype == 1) {
    FLASH_CASE(32) FLASH_CASE(64) FLASH_CASE(128) FLASH_CASE(192)
    FLASH_CASE(256)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
