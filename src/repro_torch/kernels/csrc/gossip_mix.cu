// Multi-consensus gossip mix for Hopper (sm_90a):  X <- W_{R-1} ... W_1 W_0 X
// for a stack of R (n, n) gossip matrices and an (n, D) node-stacked state.
//
// Replaces the TPU kernel `gossip_mix` of src/repro/kernels/gossip_matmul.py
// (the Pallas `_kernel` at line 23, launched by `pl.pallas_call` at line 44):
// Algorithm 2's R chained mixing rounds applied to the flattened model state.
//
// What bounds it on this card.  X is read once and out written once, 2n
// values a column whatever R is: the fusion the TPU kernel buys with its
// VMEM-resident W.  The function needs 2 n^2 D FMA operations once the R
// rounds are collapsed into one n x n matrix (2 (R-1) n^3 more, nothing at
// these n); chained round by round it would take R times that.  Against
// the card's 3.35 TB/s and 67 TFLOP/s of f32 FMAs, in f32:
//   n = 4    the bytes bound it (the FMAs take under 1% of the byte time);
//   n = 32   the bytes bound it, the FMAs at 40% of the byte time (1.11
//            against 2.79 ms at whisper-tiny's 32-node state): the FMA loop
//            must run under the stream;
//   n = 128  the FMAs take 1.6x the byte time (4.46 against 2.79 ms): the
//            FMA pipe bounds it.
// Shared memory delivers 32 lanes' 4-byte words a cycle to an SM, whatever
// the addresses (a 16-byte load is 4 cycles of it, broadcast or not), while
// the SM issues 4 warp-wide FMAs a cycle.  So a thread's every loaded word
// must feed 4 FMAs or more: an 8 x 8 micro-tile of W T (16 words a step for
// 64 FMAs) just does; the first design (one FMA for each W[i][j] loaded,
// every round) ran at a quarter of the FMA rate at n = 32.
//
// The kernel, its launch picked by the wrapper from the shapes alone
// (kernels/gossip_matmul.py launch_geometry).  First a small kernel
// collapses the stack into W = W_{R-1} ... W_0, stored transposed and
// zero-padded to rows_pad (an n x n product, a block per row).  Then a
// persistent grid; each block walks column tiles of all n rows x tc
// columns.  A ring of 2-4 shared-memory stages holds the next tiles as
// stored (f32 or bf16), each filled by one 2-D TMA box (a few boxes past
// 256 rows; plain copies where the rows are not 16-byte aligned) completing
// on the stage's mbarrier.  Each thread computes an 8-row x CM-column
// micro-tile of W T, j = 0 .. n-1 in order: per step two 16-byte loads of
// W^T and CM / 4 of the tile row feed 8 CM FMAs, the next step's loads
// issued before this step's FMAs.  A warp holds lr x lc micro-tiles (lr *
// lc = 32), its lanes on consecutive 16-byte pieces of a row.  Two walks:
// - warp (n up to ~210, W^T resident; the main path's 4 nodes: a warp 8
//   rows, 4 of them padding, x 256 columns, 16 one-warp blocks an SM;
//   whisper-tiny's 32 nodes: 8 x 8 micro-tiles, a warp 32 rows x 64
//   columns, 4 warps a block, 3 blocks an SM; n = 128: 8 warps a block
//   sharing its W^T): a warp's micro-tiles cover all n rows of its
//   columns, so no block barrier is ever taken; the last warp done with a
//   stage refills it, then stores.
// - block (more rows, or a W^T too large for shared memory): 8 x 4
//   micro-tiles; W^T streams through the L2 in chunks of kc of its rows,
//   each thread keeping its partial sums in an f32 tile buffer between
//   chunks, behind block barriers.
// The micro-tile stores from registers, 16 bytes a row for f32 and 8 for
// bf16 (vector PTX stores).  bf16 is widened as it is read and rounded to
// nearest once as it is stored.  The first design of this kernel (a thread
// owning a few columns, every round from a shared copy of the stack)
// reached 85% of the byte bound at n = 4; this one, timed beside it in
// alternating pairs, was faster there too.
//
// The kernel reads all n inputs of a column before it writes any output
// of it, and blocks own disjoint columns, so a launch may run in place
// (out == x).  Sums run in f32 on the FMA pipe, j in ascending order; no
// tensor cores (no TF32).
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kWarpCm = 8;   // micro-tile columns of the warp walk
constexpr int kBlockCm = 4;  // and of the block walk
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxBox = 256;      // a TMA box's most elements a dimension
constexpr int kFillTma = 0, kFillElems = 1;

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

constexpr int kCollapseThreads = 256;

// The collapse: wt = (W_{R-1} ... W_1 W_0)^T, (n, rows_pad), its columns n
// .. rows_pad-1 zero.  Block i < n computes row i of the product as a row
// vector, v = row i of W_{R-1}, then v <- v W_r for r = R-2 .. 0 (k
// ascending), through two shared vectors of n; block i >= n writes its
// column of zeros.  R n^3 FMAs in all: 2 M at n = 128, R = 2.
__global__ void __launch_bounds__(kCollapseThreads)
    gossip_mix_collapse_kernel(const float* __restrict__ ws,
                               float* __restrict__ wt, int R, int n,
                               int rows_pad) {
  extern __shared__ float v_s[];  // 2 n
  const int i = blockIdx.x;
  if (i >= n) {
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      wt[(size_t)j * rows_pad + i] = 0.f;
    return;
  }
  float* v = v_s;
  float* nv = v_s + n;
  const float* top = ws + ((size_t)(R - 1) * n + i) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) v[j] = top[j];
  __syncthreads();
  for (int r = R - 2; r >= 0; --r) {
    const float* w = ws + (size_t)r * n * n;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float sum = 0.f;
      for (int k = 0; k < n; ++k) sum = fmaf(v[k], w[(size_t)k * n + j], sum);
      nv[j] = sum;
    }
    __syncthreads();
    float* t = v;
    v = nv;
    nv = t;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    wt[(size_t)j * rows_pad + i] = v[j];
}

struct TileArgs {
  const float* wt;  // (n, rows_pad): the collapsed W transposed, padded
  const void* x;
  void* out;
  long long D;
  int n, rows_pad;
  int lr, lc;      // a warp's micro-tiles: lr row groups x lc column groups
  int tc;          // a tile's columns (a multiple of CM lc, at most 256)
  int units;       // a tile's micro-tiles: rows_pad / 8 x tc / CM
  int stages;      // stages of the ring
  int kc;          // rows of W^T a chunk (n where resident: the warp walk)
  int box_rows;    // a stage holds boxes x box_rows >= n rows
  int boxes;
  int fill;        // kFillTma or kFillElems
  int vst;         // vector stores of a micro-tile's rows
  int wp;          // the warp walk (W^T resident), else the block walk
};

// Shared memory of a block, in this order from a 128-byte aligned base: the
// stages' mbarriers and (warp walk) their release counts (128 bytes), W^T
// (n x rows_pad resident, or kc x rows_pad), the block walk's f32 buffer of
// n x tc partial sums, then, from the next multiple of 128 bytes, the
// stages, each boxes x box_rows x tc values as stored, padded to 128 bytes.
// The wrapper's tile_smem computes the same sum.
struct TileSmem {
  uint64_t* full;  // a stage's tile has landed
  int* done;       // warp walk: warps done reading a stage's tile
  float* w;
  float* buf;
  unsigned char* stage;
  int stage_bytes;
};

__device__ __forceinline__ TileSmem tile_smem(unsigned char* raw,
                                              const TileArgs& a, int e) {
  TileSmem s;
  unsigned char* base = raw + ((128 - (smem_addr(raw) & 127)) & 127);
  s.full = reinterpret_cast<uint64_t*>(base);
  s.done = reinterpret_cast<int*>(base + 64);
  s.w = reinterpret_cast<float*>(base + 128);
  const int w_floats = a.kc * a.rows_pad;
  s.buf = s.w + w_floats;
  const int used = 128 + 4 * (w_floats + (a.wp ? 0 : a.n * a.tc));
  s.stage = base + ((used + 127) & ~127);
  s.stage_bytes = (a.boxes * a.box_rows * a.tc * e + 127) & ~127;
  return s;
}

// The host's count of the same bytes, with 128 of alignment slack.
int tile_smem_bytes(const TileArgs& a, int e) {
  const int w_floats = a.kc * a.rows_pad;
  const int head =
      (128 + 4 * (w_floats + (a.wp ? 0 : a.n * a.tc)) + 127) & ~127;
  const int stage = (a.boxes * a.box_rows * a.tc * e + 127) & ~127;
  return 128 + head + a.stages * stage;
}

// One 2-D box (c0 innermost, c1) of a tensor map into shared memory at dst,
// completing its bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The tile at column col0 (all n rows, tc columns; columns past D
// zero-filled by TMA, left stale by the copies: an output column reads only
// its own input column, and stale columns are never stored) into stage s,
// by a group of nt threads (the block, or one warp in the warp walk), this
// one its t-th: the boxes by its first thread, or element copies by all of
// them (rows TMA cannot take), which then arrive on the stage's barrier
// (initialised with 1 or nt arrivals to match).
template <typename T>
__device__ __forceinline__ void tile_fill(const TileArgs& a,
                                          const TileSmem& sm,
                                          const CUtensorMap* map, int s,
                                          long long col0, int t, int nt) {
  constexpr int e = sizeof(T);
  unsigned char* dst = sm.stage + (size_t)s * sm.stage_bytes;
  if (a.fill == kFillTma) {
    if (t == 0) {
      const int box = a.box_rows * a.tc * e;
      mbar_arrive_expect_tx(&sm.full[s], (uint32_t)(a.boxes * box));
      for (int b = 0; b < a.boxes; ++b)
        tma_load_2d(dst + (size_t)b * box, map, &sm.full[s], (int)col0,
                    b * a.box_rows);
    }
    return;
  }
  const long long left = a.D - col0;
  const int ncol = (int)(left < a.tc ? left : a.tc);
  for (int k = t; k < a.n * ncol; k += nt) {
    const int i = k / ncol, c = k - i * ncol;
    reinterpret_cast<T*>(dst)[(size_t)i * a.tc + c] =
        static_cast<const T*>(a.x)[(long long)i * a.D + col0 + c];
  }
  mbar_arrive(&sm.full[s]);
}

// 4 consecutive values of a shared-memory row as f32 (16-byte aligned f32,
// 8-byte aligned bf16).
__device__ __forceinline__ void frag4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void frag4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// A micro-tile is 8 rows x CM columns (CM = 4 or 8): rows i0 .. i0+7,
// and CM / 4 quads of columns ch apart, c0 + k ch .. c0 + k ch + 3, so that
// a warp's lanes read consecutive 16-byte pieces of a row.

// One step's 8 x CM FMAs: acc[p][q] += wv[p] * tv[q].
template <int CM>
__device__ __forceinline__ void fma_step(const float4& wa, const float4& wb,
                                         const float (&tv)[CM],
                                         float (&acc)[8][CM]) {
  const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < CM; ++q) acc[p][q] = fmaf(wv[p], tv[q], acc[p][q]);
}

template <int CM, typename S>
__device__ __forceinline__ void frag(const S* s, int ch, float (&tv)[CM]) {
#pragma unroll
  for (int k = 0; k < CM / 4; ++k) frag4(s + k * ch, tv + 4 * k);
}

// acc[p][q] += sum over j = 0 .. steps-1, in order, of W^T[j][i0 + p] *
// src[j][column q]: w points at W^T[j0][i0] (row stride ws), s at
// src[j0][c0] (row stride ss).  Two 16-byte loads of W^T and CM / 4 of the
// tile (8 bytes each for bf16) feed 8 CM FMAs; the next step's fragments
// are loaded before this step's FMAs issue, so that their latency hides
// under them (a scheduler may hold only two warps).
template <int CM, typename S>
__device__ __forceinline__ void mix_steps(const float* w, int ws, const S* s,
                                          int ss, int ch, int steps,
                                          float (&acc)[8][CM]) {
  float4 wa = *reinterpret_cast<const float4*>(w);
  float4 wb = *reinterpret_cast<const float4*>(w + 4);
  float tv[CM];
  frag<CM>(s, ch, tv);
#pragma unroll 2
  for (int j = 1; j < steps; ++j) {
    w += ws;
    s += ss;
    const float4 na = *reinterpret_cast<const float4*>(w);
    const float4 nb = *reinterpret_cast<const float4*>(w + 4);
    float nt[CM];
    frag<CM>(s, ch, nt);
    fma_step<CM>(wa, wb, tv, acc);
    wa = na;
    wb = nb;
#pragma unroll
    for (int q = 0; q < CM; ++q) tv[q] = nt[q];
  }
  fma_step<CM>(wa, wb, tv, acc);
}

template <int CM>
__device__ __forceinline__ void zero(float (&acc)[8][CM]) {
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < CM; ++q) acc[p][q] = 0.f;
}

__device__ __forceinline__ void sts4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A micro-tile's rows (those < n), to an f32 buffer of row stride ld, or
// from it.
template <int CM>
__device__ __forceinline__ void buf_store(float* b, int ld, int n, int i0,
                                          int c0, int ch,
                                          const float (&acc)[8][CM]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (i0 + p >= n) break;
    float* row = b + (size_t)(i0 + p) * ld + c0;
#pragma unroll
    for (int k = 0; k < CM / 4; ++k) sts4(row + k * ch, acc[p] + 4 * k);
  }
}
template <int CM>
__device__ __forceinline__ void buf_load(const float* b, int ld, int n,
                                         int i0, int c0, int ch,
                                         float (&acc)[8][CM]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (i0 + p >= n) break;
    const float* row = b + (size_t)(i0 + p) * ld + c0;
#pragma unroll
    for (int k = 0; k < CM / 4; ++k) frag4(row + k * ch, acc[p] + 4 * k);
  }
}

// 16 bytes (4 f32) or 8 (4 bf16) to device memory at p, aligned to match:
// one vector store (as PTX: nvcc split the float4 store into 4).
__device__ __forceinline__ void stg4(float* p, const float* v) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}
__device__ __forceinline__ void stg4(__nv_bfloat16* p, const float* v) {
  asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(p),
               "r"(pack_bf16(v[0], v[1])), "r"(pack_bf16(v[2], v[3]))
               : "memory");
}

// A quad of a row (columns c .. c+3 of the tile; those < ncol) to out at
// g: one vector store where vst, else value by value.
template <typename T>
__device__ __forceinline__ void out_quad(T* out, long long g, int c,
                                         int ncol, bool vst, const float* v) {
  if (vst && c + 4 <= ncol) {
    stg4(out + g, v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c + q < ncol) out[g + q] = from_f32<T>(v[q]);
  }
}

// A micro-tile's rows (those < n) and columns (those < ncol) to out.
template <typename T, int CM>
__device__ __forceinline__ void out_store(const TileArgs& a, long long col0,
                                          int ncol, int i0, int c0, int ch,
                                          const float (&acc)[8][CM]) {
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    if (i0 + p >= a.n) break;
    const long long g = (long long)(i0 + p) * a.D + col0 + c0;
#pragma unroll
    for (int k = 0; k < CM / 4; ++k)
      out_quad<T>(out, g + k * ch, c0 + k * ch, ncol, a.vst, acc[p] + 4 * k);
  }
}

// A block's tile k starts at this column.
__device__ __forceinline__ long long tile_col0(const TileArgs& a,
                                               long long k) {
  return ((long long)blockIdx.x + k * gridDim.x) * a.tc;
}

// The start of either walk: the stages' barriers (completed by TMA's bytes,
// or by the fill_nt threads that fill a stage), W^T resident (the warp
// walk), a block barrier, and the first `stages` tiles' fills.  Returns the
// block's tiles: b, b + gridDim.x, ...
template <typename T>
__device__ __forceinline__ long long tile_start(const TileArgs& a,
                                                const TileSmem& sm,
                                                const CUtensorMap* map,
                                                int fill_nt) {
  const int t = threadIdx.x, nt = blockDim.x;
  const long long tiles = (a.D + a.tc - 1) / a.tc;
  if (t == 0) {
    if (a.fill == kFillTma)
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&sm.full[s], a.fill == kFillTma ? 1 : fill_nt);
      sm.done[s] = 0;
    }
    mbar_fence_init();
  }
  if (a.wp) {
    const int quads = a.n * a.rows_pad / 4;  // rows_pad: a multiple of 8
    for (int k = t; k < quads; k += nt)
      reinterpret_cast<float4*>(sm.w)[k] =
          reinterpret_cast<const float4*>(a.wt)[k];
  }
  __syncthreads();
  const long long my_tiles =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  if (t < fill_nt)
    for (long long k = 0; k < a.stages && k < my_tiles; ++k)
      tile_fill<T>(a, sm, map, (int)k, tile_col0(a, k), t, fill_nt);
  return my_tiles;
}

// The warp walk (rows_pad == 8 lr: a warp's micro-tiles cover all rows of
// its CM lc columns; W^T resident; one micro-tile a thread).  Warp w owns
// columns [CM lc w, CM lc (w + 1)) of every tile, so no block barrier is
// needed: once a warp has read its columns of a stage it counts itself in
// the stage's `done`, and the warp that completes the count refills the
// stage with the tile `stages` ahead, before it stores.  A stage's barrier
// completes a phase a fill, so tile k waits on parity (k / stages) & 1.
// Blocks of at most 256 threads (128 registers a thread).
template <typename T, int CM>
__global__ void __launch_bounds__(kTileThreads, 2)
    gossip_mix_warp_kernel(const __grid_constant__ TileArgs a,
                           const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TileSmem sm = tile_smem(smem_raw, a, (int)sizeof(T));
  const long long my_tiles = tile_start<T>(a, sm, &map, 32);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const int tc = a.tc, ch = 4 * a.lc;
  const int i0 = 8 * (lane / a.lc);
  const int c0 = warp * CM * a.lc + 4 * (lane % a.lc);
  for (long long k = 0; k < my_tiles; ++k) {
    const int s = (int)(k % a.stages);
    const long long col0 = tile_col0(a, k);
    const int ncol = (int)(a.D - col0 < tc ? a.D - col0 : tc);
    mbar_wait(&sm.full[s], (uint32_t)((k / a.stages) & 1));
    const T* stg = reinterpret_cast<const T*>(sm.stage +
                                              (size_t)s * sm.stage_bytes);
    float acc[8][CM];
    zero<CM>(acc);
    mix_steps<CM, T>(sm.w + i0, a.rows_pad, stg + c0, tc, ch, a.n, acc);
    __syncwarp();
    // this warp is done with the stage; the last of the block refills it
    int last_warp = 0;
    if (lane == 0) {
      __threadfence_block();
      last_warp = atomicAdd(&sm.done[s], 1) == warps - 1;
      if (last_warp) sm.done[s] = 0;
    }
    if (__shfl_sync(0xffffffffu, last_warp, 0) && k + a.stages < my_tiles)
      tile_fill<T>(a, sm, &map, s, tile_col0(a, k + a.stages), lane, 32);
    out_store<T, CM>(a, col0, ncol, i0, c0, ch, acc);
  }
}

// The block walk (n past what one warp's micro-tiles hold, or a W^T too
// large for shared memory): W^T streams through the L2 in chunks of kc of
// its rows, each thread keeping its partial sums in the f32 buffer between
// chunks.  grid: the resident blocks (capped by the tiles); block:
// `threads` of the geometry (a multiple of 32, at most 256; two blocks an
// SM: at most 128 registers a thread).  Micro-tile u (u = t, t +
// blockDim.x, ...: a block's passes) lies in warp tile u / 32, at row group
// (u / 32) / wct * lr + lane / lc and column offset (u / 32) % wct * CM lc
// + 4 (lane % lc), wct = tc / (CM lc) warp tiles across.
template <typename T, int CM>
__global__ void __launch_bounds__(kTileThreads, 2)
    gossip_mix_tile_kernel(const __grid_constant__ TileArgs a,
                           const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TileSmem sm = tile_smem(smem_raw, a, (int)sizeof(T));
  const long long my_tiles = tile_start<T>(a, sm, &map, blockDim.x);
  const int t = threadIdx.x, nt = blockDim.x;
  const int n = a.n, tc = a.tc, rp = a.rows_pad, ch = 4 * a.lc;
  const int wct = tc / (CM * a.lc);
  for (long long k = 0; k < my_tiles; ++k) {
    const int s = (int)(k % a.stages);
    const long long col0 = tile_col0(a, k);
    const int ncol = (int)(a.D - col0 < tc ? a.D - col0 : tc);
    mbar_wait(&sm.full[s], (uint32_t)((k / a.stages) & 1));
    const T* stg = reinterpret_cast<const T*>(sm.stage +
                                              (size_t)s * sm.stage_bytes);
    for (int j0 = 0; j0 < n; j0 += a.kc) {
      const int j1 = j0 + a.kc < n ? j0 + a.kc : n;
      __syncthreads();  // every thread is done with the last chunk
      const float4* g =
          reinterpret_cast<const float4*>(a.wt + (size_t)j0 * rp);
      for (int q = t; q < (j1 - j0) * rp / 4; q += nt)
        reinterpret_cast<float4*>(sm.w)[q] = g[q];
      __syncthreads();
      for (int u = t; u < a.units; u += nt) {
        const int wtile = u >> 5, lane = u & 31;
        const int i0 = 8 * ((wtile / wct) * a.lr + lane / a.lc);
        const int c0 = (wtile % wct) * CM * a.lc + 4 * (lane % a.lc);
        float acc[8][CM];
        if (j0 == 0)
          zero<CM>(acc);
        else  // this thread's partial sums of the earlier chunks
          buf_load<CM>(sm.buf, tc, n, i0, c0, ch, acc);
        mix_steps<CM, T>(sm.w + i0, rp, stg + (size_t)j0 * tc + c0, tc, ch,
                         j1 - j0, acc);
        if (j1 == n)
          out_store<T, CM>(a, col0, ncol, i0, c0, ch, acc);
        else
          buf_store<CM>(sm.buf, tc, n, i0, c0, ch, acc);
      }
    }
    __syncthreads();  // the stage is read
    if (k + a.stages < my_tiles)
      tile_fill<T>(a, sm, &map, s, tile_col0(a, k + a.stages), t, nt);
  }
  // nothing is in flight: every filled stage was waited on
}

// The (D, n) view of a contiguous (n, D) tensor cut in boxes of tc columns
// x box_rows rows; columns past D and rows past n read as zeros.
bool tile_map(CUtensorMap* map, const void* ptr, int bf, int n, long long D,
              int tc, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const int e = bf ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)D * e};
  const cuuint32_t box[2] = {(cuuint32_t)tc, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The blocks of a launch of Kernel: as many as are resident at once,
// capped by the tiles.
template <auto Kernel>
cudaError_t tile_grid(long long D, int tc, int threads, int smem, int* grid) {
  cudaError_t err = allow_smem<Kernel>(kMaxSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (D + tc - 1) / tc;
  const long long cap = (long long)per_sm * sms;
  *grid = (int)(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

// The collapse into wt, then the tile kernel.
template <auto Kernel>
cudaError_t launch_tile(const float* ws, int R, const TileArgs& a,
                        int threads, int smem, int e, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = tile_grid<Kernel>(a.D, a.tc, threads, smem, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap map = {};
  if (a.fill == kFillTma &&
      !tile_map(&map, a.x, e == 2, a.n, a.D, a.tc, a.box_rows))
    return cudaErrorInvalidValue;
  const int vbytes = 2 * a.n * (int)sizeof(float);
  if (vbytes > 48 * 1024) return cudaErrorInvalidValue;
  gossip_mix_collapse_kernel<<<a.rows_pad, kCollapseThreads, vbytes,
                               stream>>>(ws, const_cast<float*>(a.wt), R, a.n,
                                         a.rows_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  Kernel<<<grid, threads, smem, stream>>>(a, map);
  return cudaGetLastError();
}

// What a tile launch does through Kernel: `launch` it, report its `grid`,
// or its compiled `resources`.  The instances built: the warp walk of 8 x 8
// micro-tiles, the block walk of 8 x 4 (kWarpCm, kBlockCm).
enum class TileOp { launch, grid, resources };

template <auto Kernel>
cudaError_t tile_op(TileOp op, const float* ws, int R, const TileArgs& a,
                    int threads, int smem, int e, cudaStream_t s, int* out) {
  if (op == TileOp::launch)
    return launch_tile<Kernel>(ws, R, a, threads, smem, e, s);
  if (op == TileOp::grid)
    return tile_grid<Kernel>(a.D, a.tc, threads, smem, out);
  return kernel_resources<Kernel>(0, out);
}

template <typename T>
cudaError_t tile_dispatch(TileOp op, bool wp, const float* ws, int R,
                          const TileArgs& a, int threads, int smem,
                          cudaStream_t s, int* out) {
  const int e = sizeof(T);
  if (wp)
    return tile_op<gossip_mix_warp_kernel<T, kWarpCm>>(op, ws, R, a, threads,
                                                       smem, e, s, out);
  return tile_op<gossip_mix_tile_kernel<T, kBlockCm>>(op, ws, R, a, threads,
                                                      smem, e, s, out);
}

// The launch's arguments from its shapes and parameters p (see
// gossip_mix_launch); false where they do not describe a tile launch.
bool tile_args(TileArgs* a, int* threads, void* wt, const void* x, void* out,
               int n, long long D, int e, int smem, const int* p) {
  *a = TileArgs{};
  a->wt = static_cast<const float*>(wt);
  a->x = x;
  a->out = out;
  a->D = D;
  a->n = n;
  a->lr = p[0];
  a->lc = p[0] > 0 ? 32 / p[0] : 0;
  a->tc = p[1];
  *threads = p[2];
  a->stages = p[3];
  a->kc = p[4];
  a->rows_pad = p[5];
  a->fill = p[6];
  a->vst = p[7];
  a->box_rows = p[8];
  a->boxes = p[9];
  a->wp = p[10];
  const int lr = a->lr, cm = a->wp ? kWarpCm : kBlockCm;
  a->units = a->rows_pad / 8 * (a->tc / cm);
  if (lr < 1 || lr > 32 || (lr & (lr - 1)) != 0 || a->tc < 4 ||
      a->tc > kMaxBox || a->tc % (cm * a->lc) != 0 || a->rows_pad < n ||
      a->rows_pad % (8 * lr) != 0 || *threads < 32 || *threads % 32 != 0 ||
      *threads > kTileThreads ||
      *threads > a->units || a->stages < 1 || a->stages > kMaxStages ||
      (a->wp ? a->kc != n : (a->kc < 1 || a->kc >= n)) ||
      a->box_rows < 1 || a->box_rows > kMaxBox || a->boxes < 1 ||
      (long long)a->boxes * a->box_rows < n ||
      (a->fill != kFillTma && a->fill != kFillElems) || wt == nullptr ||
      (a->wp && (a->rows_pad != 8 * lr || *threads != a->units)) ||
      smem < tile_smem_bytes(*a, e) || smem > kMaxSmem)
    return false;
  return true;
}

}  // namespace

// ws: (R, n, n) f32; wt: (n, rows_pad) f32 scratch that the launch's first
// kernel fills with (W_{R-1} ... W_0)^T, zero-padded; x, out: (n, D)
// contiguous, f32 (dtype 0) or bf16 (dtype 1), out may be x.  p: p0 = lr,
// p1 = tc, p2 = threads, p3 = stages, p4 = kc, p5 = rows_pad, p6 = fill, p7
// = vst, p8 = box_rows, p9 = boxes, p10 = wp.  smem: the tile's dynamic
// shared bytes the wrapper computed.
// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int gossip_mix_launch(const void* ws, void* wt, const void* x,
                                 void* out, int R, int n, long long D,
                                 int dtype, int smem, const int* p,
                                 void* stream) {
  if (R < 1 || n < 1 || D < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  TileArgs a;
  int threads = 0;
  if (!tile_args(&a, &threads, wt, x, out, n, D, dtype == 0 ? 4 : 2, smem, p))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)tile_dispatch<float>(TileOp::launch, a.wp, w, R, a, threads,
                                     smem, s, nullptr);
  return (int)tile_dispatch<__nv_bfloat16>(TileOp::launch, a.wp, w, R, a,
                                           threads, smem, s, nullptr);
}

// The compiled kernel a launch runs (the warp walk where wp is 1, else the
// block walk): registers, local (spilled) bytes per thread, static shared
// bytes per block, into out[0..2].
extern "C" int gossip_mix_resources(int dtype, int wp, int* out) {
  int r[4] = {0, 0, 0, 0};
  const TileArgs none = {};
  const cudaError_t err =
      dtype == 0 ? tile_dispatch<float>(TileOp::resources, wp != 0, nullptr,
                                        0, none, 0, 0, 0, r)
                 : tile_dispatch<__nv_bfloat16>(TileOp::resources, wp != 0,
                                                nullptr, 0, none, 0, 0, 0, r);
  out[0] = r[0];
  out[1] = r[1];
  out[2] = r[2];
  out[3] = 0;
  return (int)err;
}

// The blocks a tile launch with these shapes runs (resident blocks, capped
// by the tiles), into *grid; nothing is launched.
extern "C" int gossip_mix_tile_grid(long long D, int tc, int threads,
                                    int smem, int dtype, int wp, int* grid) {
  if (D < 1 || tc < 4 || threads < 32 || smem < 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  TileArgs a = {};
  a.D = D;
  a.tc = tc;
  if (dtype == 0)
    return (int)tile_dispatch<float>(TileOp::grid, wp, nullptr, 0, a,
                                     threads, smem, 0, grid);
  return (int)tile_dispatch<__nv_bfloat16>(TileOp::grid, wp, nullptr, 0, a,
                                           threads, smem, 0, grid);
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
