// Diagonal linear recurrence for Hopper (sm_90a):
//
//     h_t = a_t * h_{t-1} + b_t,   h_{-1} = 0,
//
// along the time axis of a, b (B, S, C), independently for every (batch,
// channel).  Writes every state h_all (B, S, C) f32 and the last one h_last
// (B, C) f32.  a and b are f32 or bf16 (both the same), read as f32.
//
// Replaces the TPU kernel `linear_recurrence` of
// src/repro/kernels/linear_recurrence.py:50 (the Pallas `_kernel`, launched
// by `pl.pallas_call` at line 63).  The TPU kernel walks the time axis as
// the innermost, sequential grid dimension in chunks of block_t steps,
// carrying the state from chunk to chunk in VMEM scratch; here the grid has
// no sequential dimension, so one thread carries a channel's state through
// all S steps in a register.
//
// What bounds it on this card: bytes, at 3.35 TB/s.  A step is one multiply
// and one add per channel against 8-12 bytes moved (a and b read, h
// written): at recurrentgemma-2b's rglru layer (1, 3968, 2560) f32 the
// kernel moves 122 MB, 36.4 us; at falcon-mamba-7b's prefill (1, 2048,
// 131072) 3.2 GB, 0.96 ms.  Beside it sits the serial chain: every channel
// takes S dependent multiply-then-add steps, which no design that keeps the
// chain in order can shorten; at recurrentgemma's S = 3968 it takes longer
// than the bytes (below).
//
// Why the first design (its one-channel form kept below as the "loop"
// route) lost at a narrow C: its threads own 4 channels each and its blocks
// 128 threads, so C = 2560 gave 5 blocks on 5 of the 132 SMs, and each
// thread kept only 8 steps of loads in flight (5 x 128 x 2 x 8 x 16 B = 164
// KB on the whole card).  By Little's law that is ~130 GB/s at a
// microsecond of latency: 0.94 ms, 26x its bound.  At falcon's C = 131,072
// the same loop has 256 blocks and ~8 MB in flight and reaches ~80% of HBM.
//
// The ring route spreads the channels over the card and stages the time
// axis through shared memory.  A block owns CB channels (16, 32 or 64; one
// consumer thread a channel) of one batch row, so C = 2560 gives 160 blocks
// of CB = 16.  Three roles share a ring of `stages` stages, each holding a
// [kTileT steps x CB channels] tile of a, one of b and one of h:
//  - a producer warp fills a stage with two TMA loads (a 3-D tensor map
//    over (C, S, B) with box {CB, kTileT, 1}, so a tile never straddles two
//    batches; steps and channels past S and C read as zeros) completing on
//    the stage's full mbarrier.  Where TMA cannot take a and b (a row
//    stride C x elem that is not a multiple of 16 B, or a base that is not
//    16-byte aligned) its 32 lanes fill the same stage with 4-byte cp.async
//    copies, zero-filled past S and C, that arrive on the full mbarrier as
//    they land;
//  - the consumers run each channel's chain out of shared memory, reading
//    a chunk of the tile's values ahead of the chain (they do not depend on
//    h) and writing each h into the stage's h tile at a fixed offset, then
//    arrive on the stage's done mbarrier;
//  - a storer warp writes the h tile to h_all with one TMA store (C % 4 ==
//    0; rows past S and channels past C are not written), or else with
//    coalesced 4-byte stores of its 32 lanes, and releases the stage on its
//    empty mbarrier for the producer.
// The ring keeps up to `stages` tiles of loads in flight per block, MBs
// across the card.  The consumers hold no global address: a first version
// stored h from the consumer threads, and building the 64-bit address of
// each step's store took more of the warp's issue slots than the multiply
// and the add (PERF.md).  What remains is the chain: two shared loads, a
// multiply, an add and a shared store a step, ~12 ns on an H100, so at S =
// 3968 the kernel takes ~47 us against its 36 us byte bound whatever C is
// below a few thousand (examples/torch/linrec_compare.py --sweep).  The
// wrapper (kernels/linear_recurrence.py `launch_geometry`) picks route, CB,
// stages and the fillers from shapes alone.  The TMA ring serves falcon's
// width too (CB = 64, 2048 blocks, ~8% faster than the first design there);
// the loop stays only for bf16 rows that are not 4-byte aligned, which
// neither filler can copy.
//
// Why there is no time-chunked scan: it would compose the steps of a chunk
// into products and sums in another order, and the result would no longer
// be bit-equal to the plain version.  Every route rounds each step as
// __fadd_rn(__fmul_rn(a, h), b), the product and the sum each rounded to
// f32 (nvcc would otherwise contract a * h + b into one FMA), so the kernel
// is bit-equal to the plain PyTorch version (two separate elementwise ops)
// and to the reference's jnp scan, and a rerun gives the same bits.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py);
// the TMA descriptors are encoded on the host by cuTensorMapEncodeTiled
// (hopper_common.cuh's encode_tiled), so the library links no libcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace {

enum Route { kLoop = 0, kTma = 1, kCpAsync = 2 };

constexpr int kTileT = 64;   // steps in a ring tile
constexpr int kChunk = 8;    // steps whose shared reads precede their chain
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kThreads = 128;     // loop route
constexpr int kAhead = 8;  // loop route: steps whose loads precede the chain
constexpr long long kMaxGridX = 2147483647LL;
constexpr int kMaxGridY = 65535;

// ---- the ring route ----------------------------------------------------

template <typename T, int CB>
struct Ring {
  static constexpr int TILE_BYTES = kTileT * CB * (int)sizeof(T);  // a or b
  static constexpr int H_BYTES = kTileT * CB * 4;                  // h, f32
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + H_BYTES;
  static constexpr int CONSUMERS = 32 * ((CB + 31) / 32);  // whole warps
  static constexpr int THREADS = CONSUMERS + 64;  // + producer, + storer
  // stages x (a, b and h tiles), three barriers each, and the slack that
  // aligns the tiles to 128 bytes
  static int smem(int stages) { return 128 + stages * (STAGE_BYTES + 24); }
};

// One tile of a and b (kTileT steps from t0, CB channels from c0, batch row
// bb) into a stage by 4-byte cp.async, the producer warp's 32 lanes a word
// each in turn; words past S or C are zero-filled.  Rows must be 4-byte
// aligned (for bf16: an even C and a 4-byte-aligned base; the host checks).
template <typename T, int CB>
__device__ __forceinline__ void fill_words(T* sa, T* sb,
                                           const T* __restrict__ a,
                                           const T* __restrict__ b, int bb,
                                           int t0, int c0, int S, int C,
                                           int lane) {
  constexpr int EPW = 4 / (int)sizeof(T);  // elements per word
  constexpr int WPR = CB / EPW;            // words per tile row
#pragma unroll 4
  for (int i = lane; i < kTileT * WPR; i += 32) {
    const int r = i / WPR, e = (i % WPR) * EPW;
    const int t = t0 + r, c = c0 + e;
    const int bytes = t < S && c < C ? 4 : 0;
    const long long off = bytes ? ((long long)bb * S + t) * C + c : 0;
    cp_async4_zfill(sa + r * CB + e, a + off, bytes);
    cp_async4_zfill(sb + r * CB + e, b + off, bytes);
  }
}

// The first n rows of a stage's h tile (CB channels from c0) to h_all rows
// t0 .. t0 + n - 1 of batch row bb, the storer warp's 32 lanes a float each
// in turn (a warp's stores of a row are one contiguous run); channels past
// C are not stored.  For rows that TMA cannot store (C % 4 != 0).
template <int CB>
__device__ __forceinline__ void drain(const float* sh,
                                      float* __restrict__ h_all, int bb,
                                      int t0, int n, int c0, int S, int C,
                                      int lane) {
  const long long row0 = (long long)bb * S + t0;
#pragma unroll 4
  for (int i = lane; i < n * CB; i += 32) {
    const int r = i / CB, e = i % CB;
    if (c0 + e < C) h_all[(row0 + r) * C + c0 + e] = sh[r * CB + e];
  }
}

// grid (ceil(C / CB), B); block Ring::THREADS: CB consumer threads (the rest
// of their last warp idle), one producer warp and one storer warp.  TMA
// picks the filler: the tensor maps of a and b (TMA) or the raw pointers
// (cp.async); HTMA how h leaves the stage: a TMA store through map_h (C % 4
// == 0), or the storer warp's 4-byte stores.
template <typename T, int CB, bool TMA, bool HTMA>
__global__ void __launch_bounds__(Ring<T, CB>::THREADS)
    linear_recurrence_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                                  const __grid_constant__ CUtensorMap map_b,
                                  const __grid_constant__ CUtensorMap map_h,
                                  const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  float* __restrict__ h_all,
                                  float* __restrict__ h_last, int S, int C,
                                  int stages) {
  using R = Ring<T, CB>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  auto tile_a = [&](int s) {
    return reinterpret_cast<T*>(base + s * R::STAGE_BYTES);
  };
  auto tile_b = [&](int s) {
    return reinterpret_cast<T*>(base + s * R::STAGE_BYTES + R::TILE_BYTES);
  };
  auto tile_h = [&](int s) {
    return reinterpret_cast<float*>(base + s * R::STAGE_BYTES +
                                    2 * R::TILE_BYTES);
  };
  // full: a and b have landed; done: the consumers have read a and b and
  // written h; empty: the storer has drained h, the stage may be refilled
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * R::STAGE_BYTES);
  uint64_t* done = full + stages;
  uint64_t* empty = done + stages;

  const int c0 = blockIdx.x * CB, bb = blockIdx.y;
  const int n_tiles = (S + kTileT - 1) / kTileT;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);  // one expect_tx, or each lane
      mbar_init(&done[s], CB);            // every consumer thread
      mbar_init(&empty[s], HTMA ? 1 : 32);  // the TMA store, or each lane
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (t >= R::CONSUMERS + 32) {  // the storer warp
    const int lane = t - R::CONSUMERS - 32;
    if (HTMA && lane != 0) return;
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % stages;
      mbar_wait(&done[s], (k / stages) & 1);
      if constexpr (HTMA) {  // rows past S are not written
        tma_store_3d(&map_h, tile_h(s), c0, k * kTileT, bb);
        bulk_commit();
        bulk_wait_read<0>();
      } else {
        drain<CB>(tile_h(s), h_all, bb, k * kTileT,
                  min(kTileT, S - k * kTileT), c0, S, C, lane);
      }
      mbar_arrive(&empty[s]);
    }
    if constexpr (HTMA) bulk_wait<0>();
    return;
  }
  if (t >= R::CONSUMERS) {  // the producer warp
    const int lane = t - R::CONSUMERS;
    if (TMA && lane != 0) return;
    // tile k into stage k % stages, once the storer has drained what that
    // stage held (tile k - stages)
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % stages;
      if (k >= stages) mbar_wait(&empty[s], (k / stages - 1) & 1);
      if constexpr (TMA) {
        mbar_arrive_expect_tx(&full[s], 2 * R::TILE_BYTES);
        tma_load_3d(tile_a(s), &map_a, &full[s], c0, k * kTileT, bb);
        tma_load_3d(tile_b(s), &map_b, &full[s], c0, k * kTileT, bb);
      } else {
        fill_words<T, CB>(tile_a(s), tile_b(s), a, b, bb, k * kTileT, c0, S,
                          C, lane);
        cp_async_mbar_arrive(&full[s]);
      }
    }
    if constexpr (!TMA) {
      cp_async_commit();
      cp_async_wait<0>();  // leave no copy of this thread in flight
    }
    return;
  }
  if (t >= CB) return;

  // a consumer: channel c0 + t's chain through every tile in order, each
  // step's operands and result at fixed offsets in the stage
  float h = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % stages;
    mbar_wait(&full[s], (k / stages) & 1);
    const T* sa = tile_a(s) + t;
    const T* sb = tile_b(s) + t;
    float* sh = tile_h(s) + t;
    const int n = min(kTileT, S - k * kTileT);
    if (n == kTileT) {
#pragma unroll
      for (int j0 = 0; j0 < kTileT; j0 += kChunk) {
        float va[kChunk], vb[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          va[u] = to_f32(sa[(j0 + u) * CB]);
          vb[u] = to_f32(sb[(j0 + u) * CB]);
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          h = __fadd_rn(__fmul_rn(va[u], h), vb[u]);
          sh[(j0 + u) * CB] = h;
        }
      }
    } else {
      for (int j = 0; j < n; ++j) {
        h = __fadd_rn(__fmul_rn(to_f32(sa[j * CB]), h), to_f32(sb[j * CB]));
        sh[j * CB] = h;
      }
    }
    if constexpr (HTMA) proxy_fence_async();  // h, before the TMA store
    mbar_arrive(&done[s]);
  }
  if (c0 + t < C) h_last[(long long)bb * C + c0 + t] = h;
}

// The (C, S, B) view of a contiguous (B, S, C) tensor cut in boxes of CB
// channels x kTileT steps of one batch row; past S and C read as zeros.
bool ring_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int elem, int B, int S, int C, int cb) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * elem,
                                 (cuuint64_t)S * C * elem};
  const cuuint32_t box[3] = {(cuuint32_t)cb, (cuuint32_t)kTileT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int CB, bool TMA, bool HTMA>
cudaError_t launch_ring(const T* a, const T* b, float* h_all, float* h_last,
                        int B, int S, long long C, int stages,
                        cudaStream_t stream) {
  using R = Ring<T, CB>;
  constexpr int elem = (int)sizeof(T);
  const int smem = R::smem(stages);
  const long long blocks = (C + CB - 1) / CB;
  if (stages < 1 || stages > kMaxStages || smem > kMaxSmem ||
      C > kMaxGridX || blocks > kMaxGridX || B > kMaxGridY)
    return cudaErrorInvalidValue;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a),
                  pb = reinterpret_cast<uintptr_t>(b);
  CUtensorMap ma = {}, mb = {}, mh = {};
  if (TMA) {  // a 16-byte aligned base and row stride
    if ((pa | pb) % 16 != 0 || C * elem % 16 != 0 ||
        !ring_map(&ma, a, map_type<T>(), elem, B, S, (int)C, CB) ||
        !ring_map(&mb, b, map_type<T>(), elem, B, S, (int)C, CB))
      return cudaErrorInvalidValue;
  } else if ((pa | pb) % 4 != 0 || C * elem % 4 != 0) {  // 4-byte rows
    return cudaErrorInvalidValue;
  }
  if (HTMA && (reinterpret_cast<uintptr_t>(h_all) % 16 != 0 || C % 4 != 0 ||
               !ring_map(&mh, h_all, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, S,
                         (int)C, CB)))
    return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem<linear_recurrence_ring_kernel<T, CB, TMA, HTMA>>(kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  linear_recurrence_ring_kernel<T, CB, TMA, HTMA>
      <<<grid, R::THREADS, smem, stream>>>(ma, mb, mh, a, b, h_all, h_last, S,
                                           (int)C, stages);
  return cudaGetLastError();
}

// ---- the loop route (the first design) ---------------------------------

// grid (ceil(C / 128), B): a thread owns one channel and issues the loads of
// kAhead steps before it runs their chain.  For rows neither ring filler
// takes (bf16 rows that are not 4-byte aligned).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    linear_recurrence_loop_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b,
                                  float* __restrict__ h_all,
                                  float* __restrict__ h_last, int S,
                                  long long C) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long base = (long long)blockIdx.y * S * C + c;  // (batch, 0, c)
  const T* ap = a + base;
  const T* bp = b + base;
  float* hp = h_all + base;
  float h = 0.f;
  int t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    float va[kAhead], vb[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      va[k] = to_f32(ap[(long long)(t + k) * C]);
      vb[k] = to_f32(bp[(long long)(t + k) * C]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      h = __fadd_rn(__fmul_rn(va[k], h), vb[k]);
      hp[(long long)(t + k) * C] = h;
    }
  }
  for (; t < S; ++t) {
    const long long off = (long long)t * C;
    h = __fadd_rn(__fmul_rn(to_f32(ap[off]), h), to_f32(bp[off]));
    hp[off] = h;
  }
  h_last[(long long)blockIdx.y * C + c] = h;
}

template <typename T>
cudaError_t launch_loop(const T* a, const T* b, float* h_all, float* h_last,
                        int B, int S, long long C, cudaStream_t stream) {
  const long long blocks = (C + kThreads - 1) / kThreads;
  if (blocks > kMaxGridX || B > kMaxGridY) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  linear_recurrence_loop_kernel<T>
      <<<grid, kThreads, 0, stream>>>(a, b, h_all, h_last, S, C);
  return cudaGetLastError();
}

// ---- dispatch ------------------------------------------------------------

struct Args {
  const void* a;
  const void* b;
  float* h_all;
  float* h_last;
  int B, S;
  long long C;
  int stages;
  cudaStream_t stream;
};

template <typename T, int CB, bool HTMA>
cudaError_t ring(bool tma, const Args& x) {
  const T* a = static_cast<const T*>(x.a);
  const T* b = static_cast<const T*>(x.b);
  return tma ? launch_ring<T, CB, true, HTMA>(a, b, x.h_all, x.h_last, x.B,
                                              x.S, x.C, x.stages, x.stream)
             : launch_ring<T, CB, false, HTMA>(a, b, x.h_all, x.h_last, x.B,
                                               x.S, x.C, x.stages, x.stream);
}

// vec 4: h leaves by TMA store; 1: by the storer warp
template <typename T, int CB>
cudaError_t ring_vec(int vec, bool tma, const Args& x) {
  if (vec == 4) return ring<T, CB, true>(tma, x);
  if (vec == 1) return ring<T, CB, false>(tma, x);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(int route, int cb, int vec, const Args& x) {
  if (route == kLoop) {
    if (vec != 1) return cudaErrorInvalidValue;
    return launch_loop<T>(static_cast<const T*>(x.a),
                          static_cast<const T*>(x.b), x.h_all, x.h_last, x.B,
                          x.S, x.C, x.stream);
  }
  if (route != kTma && route != kCpAsync) return cudaErrorInvalidValue;
  const bool tma = route == kTma;
  if (cb == 16) return ring_vec<T, 16>(vec, tma, x);
  if (cb == 32) return ring_vec<T, 32>(vec, tma, x);
  if (cb == 64) return ring_vec<T, 64>(vec, tma, x);
  return cudaErrorInvalidValue;
}

template <typename T, int CB, bool HTMA>
cudaError_t ring_resources(bool tma, int stages, int* out) {
  using R = Ring<T, CB>;
  out[4] = R::THREADS;
  return tma ? kernel_resources<linear_recurrence_ring_kernel<T, CB, true,
                                                              HTMA>>(
                   R::smem(stages), out)
             : kernel_resources<linear_recurrence_ring_kernel<T, CB, false,
                                                              HTMA>>(
                   R::smem(stages), out);
}

template <typename T, int CB>
cudaError_t ring_resources_vec(int vec, bool tma, int stages, int* out) {
  if (vec == 4) return ring_resources<T, CB, true>(tma, stages, out);
  if (vec == 1) return ring_resources<T, CB, false>(tma, stages, out);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t resources(int route, int cb, int vec, int stages, int* out) {
  if (route == kLoop) {
    out[4] = kThreads;
    if (vec != 1) return cudaErrorInvalidValue;
    return kernel_resources<linear_recurrence_loop_kernel<T>>(0, out);
  }
  if (route != kTma && route != kCpAsync) return cudaErrorInvalidValue;
  const bool tma = route == kTma;
  if (cb == 16) return ring_resources_vec<T, 16>(vec, tma, stages, out);
  if (cb == 32) return ring_resources_vec<T, 32>(vec, tma, stages, out);
  if (cb == 64) return ring_resources_vec<T, 64>(vec, tma, stages, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// a, b: (B, S, C) contiguous, f32 (dtype 0) or bf16 (dtype 1); h_all: (B, S,
// C) f32 and h_last: (B, C) f32, every entry written, both 16-byte aligned.
// route 0 (loop, vec 1), 1 (ring filled by TMA) or 2 (ring filled by
// cp.async); on the ring routes vec says how h leaves a stage (4: a TMA
// store, C % 4 == 0; 1: the storer warp), cb the channels a block (16, 32
// or 64) and `stages` the ring's stages (1 .. 4); as
// kernels/linear_recurrence.py `launch_geometry` picks them.
// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
extern "C" int linear_recurrence_launch(const void* a, const void* b,
                                        void* h_all, void* h_last, int B,
                                        int S, long long C, int dtype,
                                        int route, int cb, int stages,
                                        int vec, void* stream) {
  if (B < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const Args x = {a, b, static_cast<float*>(h_all),
                  static_cast<float*>(h_last), B, S, C, stages,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)dispatch<float>(route, cb, vec, x);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(route, cb, vec, x);
  return (int)cudaErrorInvalidValue;
}

// The compiled kernel of (route, dtype, cb, vec): registers and local
// (spilled) bytes per thread, static shared bytes, the dynamic shared bytes
// of a launch with `stages` stages (0 for the loop) and threads per block,
// into out[0..4].  Returns 0, or a cudaError_t.
extern "C" int linear_recurrence_resources(int route, int dtype, int cb,
                                           int vec, int stages, int* out) {
  if (dtype == 0) return (int)resources<float>(route, cb, vec, stages, out);
  if (dtype == 1)
    return (int)resources<__nv_bfloat16>(route, cb, vec, stages, out);
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* linear_recurrence_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
