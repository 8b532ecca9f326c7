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
// kpos[c] > pos - w.  scale = 1 / sqrt(hd).  Any G: a block takes up to 16
// query rows, and G > 16 launches groups of 16 rows as the grid's z, each
// group reading the cache on its own, so a row's bits are those of the same
// row launched in a group of G <= 16.
//
// Replaces the TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 86).  There the grid is (B, J, k-blocks) with the
// k-block axis in order on one core, the G query rows' softmax state in VMEM
// scratch.
//
// What bounds it on this card: bytes.  Every cache slot's k and v are read
// once, 2 * C * hd values per (b, j), against 4 * G * C * hd flops: at the
// qwen1.5-0.5b serve path's decode (C = 2048, J = 16, G = 1, hd = 64, bf16)
// 8.4 MB, 2.5 us at 3.35 TB/s; at recurrentgemma-2b's (C = 2048, J = 1,
// G = 10, hd = 256, bf16) 2.1 MB, 0.63 us; at nemotron-4-340b's (C =
// 2048, J = 8, G = 12, hd = 192, bf16) 12.6 MB, 3.76 us.  To come near that
// the card needs many bytes in flight on many SMs, and one block per (b, j)
// gives 16 blocks (1 for recurrentgemma's one KV head) for 132 SMs.
//
// Two kernels, chosen by shape (`kTensorCores`): bf16 at hd 192 and 256
// runs the tensor-core kernel of namespace tc below; everything else the
// SIMT one.  They share the split, the ring, the softmax and the combine.
//
// What the design does (flash-decoding inside one thread-block cluster):
// the cache axis is split S ways (S = `splits`, 1 .. 8, chosen by the
// wrapper so that B * J * S fills the SMs), and the S blocks of one (b, j)
// form a cluster.  Block r streams slots [r C / S, (r + 1) C / S) in tiles
// of 64 slots (32 at hd 192 and 256) through a ring of cp.async stages (k,
// v and kpos; q joins the first group), k and v kept in their own dtype in
// shared memory (16-byte chunks XOR-swizzled by slot, so the reads below
// hit distinct banks) and widened to f32 in registers; the next tiles are
// in flight while one is computed.  Per tile: TPS = 128 / tile threads per
// slot (2, or 4 at hd 192 and 256) compute its scores for the G rows, each
// over every TPS-th 16-byte chunk of hd (a shuffle joins them), one warp
// per row takes the tile's max and sum, and for the PV product a thread
// owns one column of hd (two at hd 256, three at hd 192) and a share of the
// slots, row by row, its running sums in shared memory.  After one cluster
// barrier every block's (m, l, acc) is final in its own shared memory, and
// the blocks of the cluster combine the splits in rank order, each for its
// share of the G x hd outputs, reading the other blocks' state through
// distributed shared memory (the loads of all splits issued before any is
// used):
//
//     M = max_r m_r,  L = sum_r e^(m_r - M) l_r,
//     o = sum_r e^(m_r - M) acc_r / max(L, 1e-30),
//
// a fixed order, so reruns give the same bits; a second cluster barrier
// keeps every block resident until the others have read it.  One launch,
// no atomics, no second pass.  (A first version kept the G rows' PV sums in
// registers, each behind a branch on G, which serialised the PV loop: 0.030
// ms at the qwen serve path's decode on an H100, the next 0.009.  That one
// gathered every split's state into rank 0's shared memory, 8 x (2 G + G
// hd) floats, which at hd 256 and G 16 would not fit beside the ring.)
//
// Numerics follow the TPU kernel within each split: f32 scores, invalid
// slots at the finite -1e30, m from -1e30, l summed from the f32 p, p
// rounded to v's dtype before the PV product.  A split whose slots are all
// invalid ends with m = -1e30, l = its slot count, acc = sum of v: beside a
// split with a valid slot its weight e^(-1e30 - M) is 0, and when no split
// has one the combine gives the mean of v over all C slots, as the
// reference does.  Slots past C (a short last tile) are no slots at all:
// score -inf, p = 0, v read as zeros.  kernels/ref.py's
// `decode_attention_split_ref` is this arithmetic in plain PyTorch.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;   // a block (TPS per slot in the score phase)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;       // query rows a block takes (a row group)
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

template <typename T, int HD>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);      // values per 16-byte chunk
  static constexpr int CPR = HD / VEC;            // chunks per cache row
  static constexpr int SWZ = (CPR < 8 ? CPR : 8) - 1;
  // cache slots per tile: 64, or 32 at hd 192 and 256, where a tile's k
  // and v of 64 slots would take 48-64 KB (bf16) or 96-128 KB (f32) a stage
  static constexpr int TILE = HD > 128 ? 32 : 64;
  static constexpr int TPS = kThreads / TILE;     // threads per slot (scores)
  static constexpr int KR = HD / TPS;             // k values each holds
  // PV: DW adjacent columns, a thread each, in NP slot shares; DW divides
  // both hd and the block (hd 192: 64 columns, NP 2, 3 columns a thread)
  static constexpr int DW =
      HD % kThreads == 0 ? kThreads : (HD < kThreads ? HD : 64);
  static constexpr int NP = kThreads / DW;        // slot shares in PV
  static constexpr int COLS = HD / DW;            // columns a thread owns
  static constexpr int TILE_BYTES = TILE * HD * (int)sizeof(T);
  // as many stages of k and v as fit in 64 KB (128 KB past hd 128), 2 to 4
  static constexpr int NS0 =
      (HD > 128 ? 131072 : 65536) / (2 * TILE_BYTES);
  static constexpr int STAGES = NS0 < 2 ? 2 : (NS0 > 4 ? 4 : NS0);
  // K and V rings (own dtype), kpos per stage, q (own dtype), then f32:
  // S (G x TILE), the PV sums (NP x G x HD), m, l, alpha
  static constexpr int RING_BYTES = 2 * STAGES * TILE_BYTES;
  static constexpr int KPOS_BYTES = STAGES * TILE * 4;
  static constexpr int Q_BYTES = kMaxG * HD * (int)sizeof(T);
  static constexpr int SMEM_BYTES =
      RING_BYTES + KPOS_BYTES + Q_BYTES +
      (int)sizeof(float) * (kMaxG * TILE + NP * kMaxG * HD + 3 * kMaxG);
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
  static_assert(KR % VEC == 0 && TILE % 32 == 0 && COLS * DW == HD &&
                    NP * DW == kThreads,
                "the tile splits evenly over the threads");
  static_assert(CPR < 8 ? (CPR & (CPR - 1)) == 0 : CPR % 8 == 0,
                "the swizzle keeps a chunk in its row");
};

// Where value e of slot s lies in a tile of the ring: its 16-byte chunk
// XORed with (s TPS) & SWZ, so that the 8 threads of a quarter warp in the
// score phase (8 / TPS slots, TPS chunks each, chunks n TPS + h) read 8
// distinct banks' chunks.
template <typename T, int HD>
__device__ __forceinline__ int swz(int s, int e) {
  using C = Cfg<T, HD>;
  return s * HD + (((e / C::VEC) ^ ((s * C::TPS) & C::SWZ)) * C::VEC) +
         e % C::VEC;
}

// The splits' combine, after every block of the cluster has computed its
// split's (m, l, acc): sM, sL (per row) and sO (row g at g hd) of every
// block, read through distributed shared memory, in rank order.  Block
// `rank` takes outputs rank 128 + t, stepping by splits x 128, and loads
// the state of all splits before it uses any (each load is a round trip to
// another SM).  A cluster barrier before keeps every block's state final,
// one after keeps every block resident until the others have read it.
template <typename T>
__device__ __forceinline__ void combine_splits(cg::cluster_group& cluster,
                                               float* sM, float* sL,
                                               float* sO, T* ob, int n_out,
                                               int hd, int splits, int rank,
                                               int t) {
  cluster.sync();   // every split's (m, l, acc) is final in its block
  for (int i = rank * kThreads + t; i < n_out; i += splits * kThreads) {
    const int g = i / hd;
    float mr[kMaxSplits], lr[kMaxSplits], ar[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const bool in = r < splits;
      mr[r] = in ? *cluster.map_shared_rank(sM + g, r) : kNegInf;
      lr[r] = in ? *cluster.map_shared_rank(sL + g, r) : 0.f;
      ar[r] = in ? *cluster.map_shared_rank(sO + i, r) : 0.f;
    }
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) M = fmaxf(M, mr[r]);
    float L = 0.f, out = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits) {
        const float w = expf(mr[r] - M);
        L = fmaf(w, lr[r], L);
        out = fmaf(w, ar[r], out);
      }
    ob[i] = from_f32<T>(out / fmaxf(L, 1e-30f));
  }
  cluster.sync();   // no block leaves while another may still read it
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ kpos, T* __restrict__ o,
                            int C, int J, int G, int splits, int pos,
                            int window, float scale) {
  using Cf = Cfg<T, HD>;
  constexpr int NS = Cf::STAGES, VEC = Cf::VEC, CPR = Cf::CPR, NP = Cf::NP;
  constexpr int TILE = Cf::TILE, TPS = Cf::TPS, DW = Cf::DW;
  constexpr int COLS = Cf::COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + NS * TILE * HD;
  int* sKp = reinterpret_cast<int*>(smem + Cf::RING_BYTES);
  T* sQ = reinterpret_cast<T*>(smem + Cf::RING_BYTES + Cf::KPOS_BYTES);
  float* sS = reinterpret_cast<float*>(smem + Cf::RING_BYTES +
                                       Cf::KPOS_BYTES + Cf::Q_BYTES);
  float* sO = sS + kMaxG * TILE;
  float* sM = sO + NP * kMaxG * HD;
  float* sL = sM + kMaxG;
  float* sA = sL + kMaxG;

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int rank = (int)cluster.block_rank();   // == blockIdx.x % splits
  const int j = blockIdx.x / splits, b = blockIdx.y;
  // this block's query rows: g0 .. g0 + rows - 1 of the G
  const int g0 = blockIdx.z * kMaxG, rows = min(kMaxG, G - g0);
  const long long row = (long long)J * HD;      // stride of k between slots
  const T* kb = k + (long long)b * C * row + (long long)j * HD;
  const T* vb = v + (long long)b * C * row + (long long)j * HD;
  const int chunk = (C + splits - 1) / splits;
  const int c_begin = rank * chunk;
  const int c_end = min(C, c_begin + chunk);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + TILE - 1) / TILE
                                      : 0;

  // q of the rows, into the first group
  const T* qb = q + (((long long)b * J + j) * G + g0) * HD;
  for (int i = t; i < rows * CPR; i += kThreads)
    cp_async16_zfill(sQ + i * VEC, qb + i * VEC, 16);
  // tile `it` of this split into stage `it % NS`: TILE CPR / 128 chunks of
  // k and of v per thread, slots past c_end as zeros; its kpos, 4 slots a
  // chunk
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int c0 = c_begin + it * TILE;
      T* dk = sK + (it % NS) * TILE * HD;
      T* dv = sV + (it % NS) * TILE * HD;
#pragma unroll
      for (int n = 0; n < TILE * CPR / kThreads; ++n) {
        const int i = t + n * kThreads;
        const int s = i / CPR, e = (i % CPR) * VEC;
        const bool in = c0 + s < c_end;
        const long long off = in ? (long long)(c0 + s) * row + e : 0;
        cp_async16_zfill(dk + swz<T, HD>(s, e), kb + off, in ? 16 : 0);
        cp_async16_zfill(dv + swz<T, HD>(s, e), vb + off, in ? 16 : 0);
      }
      if (t < TILE / 4) {
        const int c = c0 + 4 * t;
        const int n = min(4, max(0, c_end - c));
        cp_async16_zfill(sKp + (it % NS) * TILE + 4 * t, kpos + (n ? c : 0),
                         4 * n);
      }
    }
    cp_async_commit();   // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) issue(it);

  if (t < rows) {
    sM[t] = kNegInf;
    sL[t] = 0.f;
  }
  // PV: this thread owns columns d0 + c DW (c < COLS) of rows 0 .. rows - 1
  // over the tile's slots part, part + NP, ...; its running sums sit in sO
  const int d0 = t % DW, part = t / DW;
  for (int g = 0; g < rows; ++g)
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      sO[(part * kMaxG + g) * HD + d0 + c * DW] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NS - 2>();   // this thread's copies of tile `it` landed
    __syncthreads();           // everyone's did; tile it - 1 is consumed
    issue(it + NS - 1);        // into the stage tile it - 1 used
    const T* tk = sK + (it % NS) * TILE * HD;
    const T* tv = sV + (it % NS) * TILE * HD;
    const int c0 = c_begin + it * TILE;

    // scores: slot s = t / TPS; this thread's part h = t % TPS of hd is
    // the chunks h, h + TPS, h + 2 TPS, ...
    {
      const int s = t / TPS, h = t % TPS;
      const int c = c0 + s;
      const int kp = sKp[(it % NS) * TILE + s];
      const bool valid = c < c_end && kp >= 0 && kp <= pos &&
                         (window == 0 || kp > pos - window);
      float kr[Cf::KR];
#pragma unroll
      for (int n = 0; n < CPR / TPS; ++n) {
        const int e = (n * TPS + h) * VEC;
        unpack_f32(T(), *reinterpret_cast<const uint4*>(tk + swz<T, HD>(s, e)),
                   kr + n * VEC);
      }
      for (int g = 0; g < rows; ++g) {
        const T* qg = sQ + g * HD;
        float a = 0.f;
#pragma unroll
        for (int n = 0; n < CPR / TPS; ++n) {
          float qv[VEC];
          unpack_f32(T(), *reinterpret_cast<const uint4*>(
                              qg + (n * TPS + h) * VEC), qv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) a = fmaf(qv[e], kr[n * VEC + e], a);
        }
#pragma unroll
        for (int off = 1; off < TPS; off <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (h == 0)
          sS[g * TILE + s] =
              c >= c_end ? -INFINITY : (valid ? a * scale : kNegInf);
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per row
    for (int g = warp; g < rows; g += kWarps) {
      float sv[TILE / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        sv[i] = sS[g * TILE + lane + 32 * i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TILE / 32; ++i) {
        const float p = expf(sv[i] - m_new);
        sum += p;
        sS[g * TILE + lane + 32 * i] = round_to<T>(p);
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

    // PV: o = o alpha + the tile's sum of p v, row by row
    for (int g = 0; g < rows; ++g) {
      const float* p = sS + g * TILE;
      float a[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) a[c] = 0.f;
#pragma unroll
      for (int i = 0; i < TILE / NP; ++i) {
        const int s = part + NP * i;
        const float ps = p[s];
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          a[c] = fmaf(ps, to_f32(tv[swz<T, HD>(s, d0 + c * DW)]), a[c]);
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        float& og = sO[(part * kMaxG + g) * HD + d0 + c * DW];
        og = fmaf(og, sA[g], a[c]);
      }
    }
  }
  cp_async_wait<0>();   // no copy may land after the block has moved on
  __syncthreads();      // every share's sums are in sO

  // this split's acc: the NP shares summed in order into share 0
  if (NP > 1 && part == 0)
    for (int g = 0; g < rows; ++g)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int d = d0 + c * DW;
        float a = sO[g * HD + d];
        for (int p = 1; p < NP; ++p) a += sO[(p * kMaxG + g) * HD + d];
        sO[g * HD + d] = a;
      }
  combine_splits(cluster, sM, sL, sO,
                 o + (((long long)b * J + j) * G + g0) * HD, rows * HD, HD,
                 splits, rank, t);
}

// The route by shape: bf16 at hd 192 and 256 on the tensor cores, the rest
// SIMT.
template <typename T, int HD>
constexpr bool kTensorCores =
    std::is_same<T, __nv_bfloat16>::value && HD > 128;

// ==== bf16 at hd 192 and 256: tensor cores ================================
//
// recurrentgemma's decode has G = 10 query rows per KV head at hd 256, and
// the SIMT kernel above then reads every k and v value from shared memory
// once per row: 0.058 ms at its serve shape on an H100, bound by shared
// memory's wavefronts, slower than its plain version (this kernel: 0.014).
// nemotron-4-340b's has G = 12 at hd 192, the same case.  Here a block's
// rows (up to 16, zero-padded) are the M = 16 of mma.sync m16n8k16 (bf16
// in, f32 out): q's A fragments stay in registers for the whole walk, each
// warp takes 8 slots of a 32-slot tile for S = q k^T (k's B fragments by
// ldmatrix from the swizzled ring) and hd / 4 columns of hd for O += p v
// (v's by ldmatrix.trans; p as bf16 through shared memory, since the online
// softmax needs a row's max over the 4 warps' slots).  The 16-byte chunks
// of a ring row are XORed with (slot & 7), so the 8 rows an ldmatrix reads
// lie in 8 distinct bank groups.  The softmax, the splits and their combine
// are the SIMT kernel's, so are the numerics, but for the product order
// inside the tensor cores and for O being rescaled by alpha before the
// tile's p v is added.  A warp's softmax takes its 4 rows at once, and the
// even and odd k-steps of S accumulate apart, so that no long chain of
// dependent shuffles or mma serialises a tile.

namespace tc {

constexpr int kRows = 16;      // mma M: a block's rows, zero-padded
constexpr int kTile = 32;      // slots per tile: 8 per warp

template <int HD>
struct Cfg {
  static constexpr int CPR = HD / 8;     // 16-byte chunks a row
  static constexpr int TILE_BYTES = kTile * HD * 2;
  static constexpr int NS0 = 131072 / (2 * TILE_BYTES);
  static constexpr int STAGES = NS0 < 2 ? 2 : (NS0 > 4 ? 4 : NS0);
  static constexpr int QLD = HD + 8;     // padded q rows: no bank conflicts
  static constexpr int SLD = kTile + 4;  // S rows (f32)
  static constexpr int PLD = kTile + 8;  // p rows (bf16): no bank conflicts
  static constexpr int NB = HD / 32;     // n8 blocks of O a warp owns
  static constexpr int RING_BYTES = 2 * STAGES * TILE_BYTES;
  static constexpr int KPOS_BYTES = STAGES * kTile * 4;
  static constexpr int Q_BYTES = kRows * QLD * 2;
  static constexpr int S_BYTES = kRows * SLD * 4;
  static constexpr int P_BYTES = kRows * PLD * 2;
  static constexpr int O_BYTES = kRows * HD * 4;
  static constexpr int SMEM_BYTES = RING_BYTES + KPOS_BYTES + Q_BYTES +
                                    S_BYTES + P_BYTES + O_BYTES +
                                    3 * kRows * 4;
  static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
  static_assert(HD % 64 == 0 && kTile * CPR % kThreads == 0,
                "the tile splits evenly over the threads and warps");
};

// Where chunk c (8 values) of slot s lies in a tile of the ring.
template <int HD>
__device__ __forceinline__ int swz(int s, int c) {
  return s * HD + ((c ^ (s & 7)) * 8);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const int* __restrict__ kpos,
                               __nv_bfloat16* __restrict__ o, int C, int J,
                               int G, int splits, int pos, int window,
                               float scale) {
  using Cf = Cfg<HD>;
  using bf16 = __nv_bfloat16;
  constexpr int NS = Cf::STAGES, CPR = Cf::CPR, NB = Cf::NB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + NS * kTile * HD;
  unsigned char* rest = smem + Cf::RING_BYTES;
  int* sKp = reinterpret_cast<int*>(rest);
  bf16* sQ = reinterpret_cast<bf16*>(rest + Cf::KPOS_BYTES);
  float* sS = reinterpret_cast<float*>(rest + Cf::KPOS_BYTES + Cf::Q_BYTES);
  bf16* sP = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sS) +
                                     Cf::S_BYTES);
  float* sO = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sP) +
                                       Cf::P_BYTES);
  float* sM = sO + kRows * HD;
  float* sL = sM + kRows;
  float* sA = sL + kRows;

  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, tq = lane & 3;      // fragment row, column pair
  const int rank = (int)cluster.block_rank();
  const int j = blockIdx.x / splits, b = blockIdx.y;
  const int g0 = blockIdx.z * kMaxG, rows = min(kMaxG, G - g0);
  const long long row = (long long)J * HD;
  const bf16* kb = k + (long long)b * C * row + (long long)j * HD;
  const bf16* vb = v + (long long)b * C * row + (long long)j * HD;
  const int chunk = (C + splits - 1) / splits;
  const int c_begin = rank * chunk;
  const int c_end = min(C, c_begin + chunk);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTile - 1) / kTile
                                      : 0;

  // q's rows into the first group; rows past them zero
  const bf16* qb = q + (((long long)b * J + j) * G + g0) * HD;
  for (int i = t; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    if (r < rows)
      cp_async16_zfill(sQ + r * Cf::QLD + c * 8, qb + r * HD + c * 8, 16);
    else
      *reinterpret_cast<uint4*>(sQ + r * Cf::QLD + c * 8) =
          make_uint4(0, 0, 0, 0);
  }
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int c0 = c_begin + it * kTile;
      bf16* dk = sK + (it % NS) * kTile * HD;
      bf16* dv = sV + (it % NS) * kTile * HD;
#pragma unroll
      for (int n = 0; n < kTile * CPR / kThreads; ++n) {
        const int i = t + n * kThreads;
        const int sl = i / CPR, c = i % CPR;
        const bool in = c0 + sl < c_end;
        const long long off = in ? (long long)(c0 + sl) * row + c * 8 : 0;
        cp_async16_zfill(dk + swz<HD>(sl, c), kb + off, in ? 16 : 0);
        cp_async16_zfill(dv + swz<HD>(sl, c), vb + off, in ? 16 : 0);
      }
      if (t < kTile / 4) {
        const int c = c0 + 4 * t;
        const int n = min(4, max(0, c_end - c));
        cp_async16_zfill(sKp + (it % NS) * kTile + 4 * t, kpos + (n ? c : 0),
                         4 * n);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) issue(it);
  if (t < kRows) {
    sM[t] = kNegInf;
    sL[t] = 0.f;
    sA[t] = 0.f;
  }
  cp_async_wait<NS - 2>();   // q (and tile 0) landed
  __syncthreads();

  // q's A fragments for every k-step of hd, kept for the whole walk
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int m = lane >> 3, r = (lane & 7) + 8 * (m & 1);
    ldsm_x4(qa[ks], sQ + r * Cf::QLD + (2 * ks + (m >> 1)) * 8);
  }
  float oacc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    issue(it + NS - 1);
    const bf16* tk = sK + (it % NS) * kTile * HD;
    const bf16* tv = sV + (it % NS) * kTile * HD;
    const int c0 = c_begin + it * kTile;

    // S = q k^T for this warp's 8 slots, two k-steps per ldmatrix, the
    // even and odd k-steps in two accumulators (two chains of mma)
    {
      float sacc[4] = {0.f, 0.f, 0.f, 0.f}, sodd[4] = {0.f, 0.f, 0.f, 0.f};
      const int m = lane >> 3, sl = 8 * warp + (lane & 7);
#pragma unroll
      for (int p = 0; p < HD / 32; ++p) {
        uint32_t kf[4];
        ldsm_x4(kf, tk + swz<HD>(sl, 4 * p + m));
        mma_bf16(sacc, qa[2 * p], kf[0], kf[1]);
        mma_bf16(sodd, qa[2 * p + 1], kf[2], kf[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[e] += sodd[e];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * warp + 2 * tq + e;
        const int c = c0 + s;
        const int kp = sKp[(it % NS) * kTile + s];
        const bool valid = c < c_end && kp >= 0 && kp <= pos &&
                           (window == 0 || kp > pos - window);
        const float none = c >= c_end ? -INFINITY : kNegInf;
        sS[gq * Cf::SLD + s] = valid ? sacc[e] * scale : none;
        sS[(gq + 8) * Cf::SLD + s] = valid ? sacc[2 + e] * scale : none;
      }
    }
    __syncthreads();

    // online softmax over the tile, a warp for rows warp, warp + 4, ...,
    // all 16 at once (rows past `rows`, from q's zero rows, are never
    // output)
    {
      float sv[kRows / kWarps], mx[kRows / kWarps], sum[kRows / kWarps];
#pragma unroll
      for (int r = 0; r < kRows / kWarps; ++r) {
        sv[r] = sS[(warp + kWarps * r) * Cf::SLD + lane];
        mx[r] = sv[r];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < kRows / kWarps; ++r)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
#pragma unroll
      for (int r = 0; r < kRows / kWarps; ++r) {
        const int g = warp + kWarps * r;
        mx[r] = fmaxf(sM[g], mx[r]);            // m_new
        sum[r] = expf(sv[r] - mx[r]);
        sP[g * Cf::PLD + lane] = __float2bfloat16_rn(sum[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < kRows / kWarps; ++r)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      __syncwarp();
      if (lane < kRows / kWarps) {
        float m_new = mx[0], s_new = sum[0];
#pragma unroll
        for (int r = 1; r < kRows / kWarps; ++r)
          if (lane == r) m_new = mx[r], s_new = sum[r];
        const int g = warp + kWarps * lane;
        const float alpha = expf(sM[g] - m_new);
        sA[g] = alpha;
        sL[g] = alpha * sL[g] + s_new;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // O = O alpha + p v for this warp's NB n8 blocks of hd
    const float al_a = sA[gq], al_b = sA[gq + 8];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      oacc[n][0] *= al_a;
      oacc[n][1] *= al_a;
      oacc[n][2] *= al_b;
      oacc[n][3] *= al_b;
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t pa[4];
      const bf16* pr = sP + gq * Cf::PLD + 16 * kk + 2 * tq;
      pa[0] = *reinterpret_cast<const uint32_t*>(pr);
      pa[1] = *reinterpret_cast<const uint32_t*>(pr + 8 * Cf::PLD);
      pa[2] = *reinterpret_cast<const uint32_t*>(pr + 8);
      pa[3] = *reinterpret_cast<const uint32_t*>(pr + 8 * Cf::PLD + 8);
      const int m = lane >> 3;
      const int sl = 16 * kk + 8 * (m & 1) + (lane & 7);
#pragma unroll
      for (int n = 0; n < NB; n += 2) {
        uint32_t vf[4];
        ldsm_x4_t(vf, tv + swz<HD>(sl, NB * warp + n + (m >> 1)));
        mma_bf16(oacc[n], pa, vf[0], vf[1]);
        mma_bf16(oacc[n + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // this split's acc into sO (row g at g HD), then the cluster's combine
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int col = 8 * (NB * warp + n) + 2 * tq;
    *reinterpret_cast<float2*>(sO + gq * HD + col) =
        make_float2(oacc[n][0], oacc[n][1]);
    *reinterpret_cast<float2*>(sO + (gq + 8) * HD + col) =
        make_float2(oacc[n][2], oacc[n][3]);
  }
  combine_splits(cluster, sM, sL, sO,
                 o + (((long long)b * J + j) * G + g0) * HD, rows * HD, HD,
                 splits, rank, t);
}

}  // namespace tc

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kpos, void* o, int B, int C, int J, int G,
                   int splits, int pos, int window, float scale,
                   cudaStream_t stream) {
  using Cf = Cfg<T, HD>;
  if (splits > 1 && C % (Cf::TILE * splits) != 0)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(J * splits, B, (G + kMaxG - 1) / kMaxG);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if constexpr (kTensorCores<T, HD>) {
    static_assert(Cf::TILE == tc::kTile, "both kernels split alike");
    err = allow_smem<tc::decode_attention_tc_kernel<HD>>(
        tc::Cfg<HD>::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    cfg.dynamicSmemBytes = tc::Cfg<HD>::SMEM_BYTES;
    err = cudaLaunchKernelEx(&cfg, tc::decode_attention_tc_kernel<HD>,
                             static_cast<const T*>(q),
                             static_cast<const T*>(k),
                             static_cast<const T*>(v), kpos,
                             static_cast<T*>(o), C, J, G, splits, pos,
                             window, scale);
  } else {
    err = allow_smem<decode_attention_kernel<T, HD>>(Cf::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    cfg.dynamicSmemBytes = Cf::SMEM_BYTES;
    err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, HD>,
                             static_cast<const T*>(q),
                             static_cast<const T*>(k),
                             static_cast<const T*>(v), kpos,
                             static_cast<T*>(o), C, J, G, splits, pos,
                             window, scale);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* kpos, void* o, int B, int C, int J, int G,
                     int hd, int splits, int pos, int window, float scale,
                     cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, kpos, o, B, C, J, G, splits, pos, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, kpos, o, B, C, J, G, splits, pos, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, kpos, o, B, C, J, G, splits, pos,
                            window, scale, s);
    case 192:
      return launch<T, 192>(q, k, v, kpos, o, B, C, J, G, splits, pos,
                            window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, kpos, o, B, C, J, G, splits, pos,
                            window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, 1, J, G, hd), k and v: (B, C, J, hd), o: (B, 1, J * G, hd), all
// contiguous, 16-byte aligned and of one dtype, f32 (dtype 0) or bf16
// (dtype 1); kpos: (C,) int32; hd 32, 64, 128, 192 or 256; G >= 1; window
// 0 = none; 1 <= splits <= 8, and with splits > 1 C a multiple of tile *
// splits (tile 64, or 32 at hd 192 and 256).
// One launch on `stream` of J * splits x B x ceil(G / 16) blocks in
// clusters of `splits`; returns the launch's cudaError_t (0 = queued).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kpos,
                                       void* o, int B, int C, int J, int G,
                                       int hd, int splits, int pos,
                                       int window, float scale, int dtype,
                                       void* stream) {
  if (B < 1 || C < 1 || J < 1 || G < 1 || window < 0 || B > kMaxGridY ||
      (G + kMaxG - 1) / kMaxG > kMaxGridY || splits < 1 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kp = static_cast<const int*>(kpos);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, kp, o, B, C, J, G, hd, splits, pos,
                                window, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, kp, o, B, C, J, G, hd,
                                        splits, pos, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel's resources for (hd, dtype): registers and local (spilled)
// bytes per thread, static and dynamic shared bytes per block, threads per
// block, into out[0..4].  Returns 0, or a cudaError_t.
extern "C" int decode_attention_resources(int hd, int dtype, int* out) {
#define DECODE_CASE(T, HD)                                           \
  if (hd == HD) {                                                    \
    out[4] = kThreads;                                               \
    return (int)kernel_resources<decode_attention_kernel<T, HD>>(    \
        Cfg<T, HD>::SMEM_BYTES, out);                                \
  }
#define DECODE_TC_CASE(HD)                                           \
  if (hd == HD) {                                                    \
    out[4] = kThreads;                                               \
    return (int)kernel_resources<tc::decode_attention_tc_kernel<HD>>( \
        tc::Cfg<HD>::SMEM_BYTES, out);                               \
  }
  if (dtype == 0) {
    DECODE_CASE(float, 32) DECODE_CASE(float, 64) DECODE_CASE(float, 128)
    DECODE_CASE(float, 192) DECODE_CASE(float, 256)
  } else if (dtype == 1) {
    DECODE_CASE(__nv_bfloat16, 32) DECODE_CASE(__nv_bfloat16, 64)
    DECODE_CASE(__nv_bfloat16, 128)
    DECODE_TC_CASE(192) DECODE_TC_CASE(256)
  }
#undef DECODE_TC_CASE
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
