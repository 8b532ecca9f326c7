// Error-feedback compressed multi-consensus for Hopper (sm_90a).  For each
// of R rounds, on an (n, D) node-stacked state x and residual res (each f32
// or bf16, computed in f32):
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
// What bounds it on this card: device-memory bandwidth, with the f32 FMAs of
// the mix close behind at n = 32.  Per column and round it does 2n^2 flops of
// mixing and ~20n operations of quantization for 4n element moves (x and res
// read once, written once); the least time is one read and one write of x and
// res.  At n = 32 the mix alone is 40% of that time at the card's f32 rate,
// so the design has to keep both the copies and the FMA pipes busy.
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
//   W stack (a broadcast read), as gossip_mix.cu does.
// * ring (where a tile and a stage fit in shared memory): a persistent grid
//   of thread-block clusters.  A cluster of C blocks (2, 4 or 8) splits one
//   group at a time (block r takes columns [r cols, (r + 1) cols)), or a lone
//   block (C = 1) takes a few whole groups.  Each block keeps a ring of
//   stages in shared memory, each the n rows of a later tile's x and res as
//   stored (f32 or bf16), filled by one 2-D TMA box of each (else 4-byte
//   cp.async, or plain copies, as alignment allows), completing on the
//   stage's mbarrier; a stage is refilled with
//   the tile `stages` ahead as soon as round 0 has read it.  The tile is cut
//   in units of 4 rows x 4 columns, U (1 or 2) a thread of 256; a warp's
//   lanes own consecutive columns of its rows.  A thread keeps its units' x
//   (buf, deq, then the mixed x) and res in registers for all R rounds and
//   stores them once, 16 (f32) or 8 (bf16) bytes a row.  A round: buf; each
//   row's |buf| partial over the block's columns by a butterfly of the lanes
//   that own them (else, for tiles of several groups or odd widths, through
//   a shared buffer, one warp a (row, group)); each partial sent to every
//   block of the cluster with st.async, completing on that block's exchange
//   mbarrier (no cluster barrier: cluster.sync() fences all of device
//   memory); once a block's barrier has all C x n partials, thread i
//   combines row i's in rank order into its scale; then deq into a shared
//   buffer, a block barrier, and the mix: for j = 0 .. n-1 one 16-byte
//   shared load of W^T[j][i0..i0+3] (a broadcast) and one of deq[j][c0..
//   c0+3] feed 16 FMAs.  Buffers and exchange slots alternate between
//   rounds.  W is read from shared memory where the W stack fits, else
//   (large n) through the L1 from device memory.
// * stream (any n, where no ring fits): a block owns one group at a time and
//   streams it through device memory every round: a pass that reduces each
//   node's |buf| over the group (one warp a node, as above), then a pass in
//   which each thread quantizes and mixes its columns and writes x and res.
//   Round r > 0 reads what round r - 1 wrote: into the outputs where both are
//   f32, else (a bf16 output would round a round's state) into an f32 scratch
//   slot of the block's own.  The mix pass takes a slab of columns at a
//   time: their deq into shared memory, a block barrier (a column's n inputs
//   are all read before any output of it is written), then each thread
//   accumulates a chunk of 16 output rows of one column, W^T read through
//   the L1 16 bytes (4 rows) a load.
//
// Every route: fixed-order reductions and no atomics (a rerun gives the same
// bits), and the mix of column c as fmaf(W[i][j], deq[j][c], acc) over j =
// 0 .. n-1 in order, so for int8 (a max, order-free) the three routes give
// the same bits; sign's sums differ in order between routes.  bf16 inputs
// are widened to f32 as they are read and the results rounded to nearest
// even as they are stored, so a bf16 launch gives the bits of the f32 launch
// on upcast copies, cast back.  Every route reads all n inputs of a column
// before it writes any output of it, so a launch may run in place (out == x,
// res_out == res).
//
// Numerics: IEEE division (no --use_fast_math), rintf for half to even, and
// buf, deq and buf - deq through the _rn intrinsics, which the compiler may
// not contract into an FMA: res then has the reference's bits.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kRegsNodes = 16;
constexpr int kRegsGroup = kThreads;  // a group fits one block even at VEC = 1
constexpr int kStreamThreads = 512;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamChunk = 16;      // output rows a stream thread adds up
constexpr int kRingThreads = 256;
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;      // 227 KB, the most a block may use
constexpr int kRouteRegs = 0, kRouteRing = 1, kRouteStream = 2;
constexpr int kFillTma = 0, kFillWords = 1, kFillElems = 2;
constexpr int kMaxBox = 256;         // a TMA box's most elements a dimension

// ---- element access: f32 or bf16 as f32 ----------------------------------

__device__ __forceinline__ float ld1(const void* p, long long i, bool bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void st1(void* p, long long i, float v, bool bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}
// 4 consecutive values from p + i (16-byte aligned f32, 8-byte aligned bf16)
__device__ __forceinline__ void ld4(const void* p, long long i, bool bf,
                                    float* v) {
  if (bf) {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
    const float4 f =
        *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
}
__device__ __forceinline__ void st4(void* p, long long i, const float* v,
                                    bool bf) {
  if (bf) {
    uint2 u;
    u.x = pack_bf16(v[0], v[1]);
    u.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}
// VEC consecutive values (VEC 1 or 4), aligned to VEC values
template <int VEC>
__device__ __forceinline__ void ldv(const void* p, long long i, bool bf,
                                    float* v) {
  if (VEC == 4)
    ld4(p, i, bf, v);
  else
    v[0] = ld1(p, i, bf);
}
template <int VEC>
__device__ __forceinline__ void stv(void* p, long long i, const float* v,
                                    bool bf) {
  if (VEC == 4)
    st4(p, i, v, bf);
  else
    st1(p, i, v[0], bf);
}
// 4 f32 values to / from shared memory (16-byte aligned)
__device__ __forceinline__ void sts4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// ---- the quantizer, shared by the routes ---------------------------------

// SCHEME 0 = sign (sum of |buf|), 1 = int8 (max of |buf|).
template <int SCHEME>
__device__ __forceinline__ float combine(float a, float b) {
  return SCHEME == 0 ? __fadd_rn(a, b) : fmaxf(a, b);
}

// A (node, group) row's combined |buf| -> its scale.
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

// ---------------------------------------------------------------------------
// The regs route (n <= 16, a power-of-two group <= 256)
// ---------------------------------------------------------------------------

// x, res, out, res_out are not __restrict__: the launch may run in place.
template <int N, int VEC, int SCHEME>
__global__ void __launch_bounds__(kThreads)
    quantized_gossip_mix_kernel(const float* __restrict__ ws, const void* x,
                                const void* res, void* out, void* res_out,
                                int R, int n, long long D, int group, int ef,
                                int write_res, int xb, int rb) {
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
        ldv<VEC>(x, (long long)i * D + c, xb, xv[i]);
        ldv<VEC>(res, (long long)i * D + c, rb, rv[i]);
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
        const float s = scale_of<SCHEME>(part[i], count);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float b = xv[i][v];
          const float d = dequant<SCHEME>(b, s);
          if (ef) rv[i][v] = __fsub_rn(b, d);
          xv[i][v] = d;
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
          stv<VEC>(out, (long long)i * D + c, xv[i], xb);
          if (write_res) stv<VEC>(res_out, (long long)i * D + c, rv[i], rb);
        }
      }
    }
  }
}

template <int N, int VEC, int SCHEME>
cudaError_t launch(const float* ws, const void* x, const void* res, void* out,
                   void* res_out, int R, int n, long long D, int group,
                   int ef, int write_res, int xb, int rb,
                   cudaStream_t stream) {
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
                                           group, ef, write_res, xb, rb);
  return cudaGetLastError();
}

template <int SCHEME>
cudaError_t dispatch(const float* ws, const void* x, const void* res,
                     void* out, void* res_out, int R, int n, long long D,
                     int group, int ef, int write_res, int vec, int xb,
                     int rb, cudaStream_t s) {
  if (vec == 4) {
    if (n > 8 || group % 4 != 0) return cudaErrorInvalidValue;
    if (n <= 4)
      return launch<4, 4, SCHEME>(ws, x, res, out, res_out, R, n, D, group,
                                  ef, write_res, xb, rb, s);
    return launch<8, 4, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                                write_res, xb, rb, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  if (n <= 4)
    return launch<4, 1, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                                write_res, xb, rb, s);
  if (n <= 8)
    return launch<8, 1, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                                write_res, xb, rb, s);
  return launch<16, 1, SCHEME>(ws, x, res, out, res_out, R, n, D, group, ef,
                               write_res, xb, rb, s);
}

// ---------------------------------------------------------------------------
// The ring route
// ---------------------------------------------------------------------------

struct RingArgs {
  const float* wt;  // (R, n, n4): W_r transposed, rows zero-padded to n4
  const void* x;
  const void* res;
  void* out;
  void* res_out;
  long long D;
  int R, n, n4, group;
  int cols;     // a block's columns of a tile (a multiple of 4)
  int seg;      // columns of a reduction segment: group (C = 1) or cols
  int segs;     // segments of a block's tile: cols / seg
  int csize;    // blocks of a cluster
  int stages;   // stages of the ring
  int ef, write_res, xb, rb;
  int fill;     // kFillTma, kFillWords or kFillElems
  int vst;      // 16-byte (f32) or 8-byte (bf16) stores of a unit's row
  int w_smem;   // W^T staged in shared memory (else read from device memory)
};

// Shared memory of a block, in this order from a 128-byte aligned base: the
// stages' mbarriers (8 x 8 bytes) and the two exchange mbarriers (128 bytes
// in all), W^T (when staged), two f32 buffers of n x cols (buf / deq,
// alternating by round), two exchange slots of csize x n x segs partials
// (alternating by round), n row scales, then, from the next multiple of 128
// bytes, the
// stages, each the x rows then the res rows of a tile as stored, each part
// padded to 128 bytes.  The wrapper's launch_geometry computes the same sum.
struct RingSmem {
  uint64_t* full;   // a stage's tile has landed
  uint64_t* xbar;   // a round's partials have all arrived (two, by parity)
  float* wt;
  float* wb;
  float* exch;
  float* scale;     // a round's row scales (the lane-reduced tiles), each
                    // written and read by the warp that owns the row
  unsigned char* stage;
  int x_bytes;      // a stage's x rows, padded to 16 bytes; the res rows follow
  int stage_bytes;  // x and res rows, each padded to 16 bytes
  int wb_floats, exch_floats;
};

__device__ __forceinline__ RingSmem ring_smem(unsigned char* raw,
                                              const RingArgs& a) {
  RingSmem s;
  unsigned char* base = raw + ((128 - (smem_addr(raw) & 127)) & 127);
  s.full = reinterpret_cast<uint64_t*>(base);
  s.xbar = s.full + kMaxStages;
  s.wt = reinterpret_cast<float*>(base + 128);
  const int wt_floats = a.w_smem ? a.R * a.n * a.n4 : 0;
  s.wb = s.wt + wt_floats;
  s.wb_floats = a.n * a.cols;
  s.exch = s.wb + 2 * s.wb_floats;
  s.exch_floats = a.csize * a.n * a.segs;
  s.scale = s.exch + 2 * s.exch_floats;
  // the stages 128-byte aligned, as a TMA box's destination must be
  const int used =
      (int)(reinterpret_cast<unsigned char*>(s.scale + a.n) - base);
  s.stage = base + ((used + 127) & ~127);
  s.x_bytes = (a.n * a.cols * (a.xb ? 2 : 4) + 127) & ~127;
  s.stage_bytes = s.x_bytes + ((a.n * a.cols * (a.rb ? 2 : 4) + 127) & ~127);
  return s;
}

// The shared::cluster address of this block's shared address `addr` in the
// block of the cluster with rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// v to the shared::cluster address `addr` (another block's shared memory),
// completing 4 bytes on that block's mbarrier at `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
      " [%0], %1, [%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
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

// The block's tile k (columns col0 .. col0 + ncol - 1 of every node row)
// into stage s: one 2-D box of x and one of res (n rows x cols, columns past
// D zero-filled) issued by thread 0, or 4-byte cp.async or plain copies by
// every thread, which then arrive on the barrier (initialised with 1 or
// blockDim.x arrivals to match).
__device__ __forceinline__ void ring_fill(const RingArgs& a,
                                          const RingSmem& sm,
                                          const CUtensorMap* map_x,
                                          const CUtensorMap* map_r, int s,
                                          long long col0, int ncol) {
  const int t = threadIdx.x;
  const int ex = a.xb ? 2 : 4, er = a.rb ? 2 : 4;
  unsigned char* sx = sm.stage + (size_t)s * sm.stage_bytes;
  unsigned char* sr = sx + sm.x_bytes;
  const unsigned char* gx = static_cast<const unsigned char*>(a.x);
  const unsigned char* gr = static_cast<const unsigned char*>(a.res);
  if (a.fill == kFillTma) {
    if (t == 0) {
      mbar_arrive_expect_tx(&sm.full[s],
                            (uint32_t)a.n * a.cols * (uint32_t)(ex + er));
      tma_load_2d(sx, map_x, &sm.full[s], (int)col0, 0);
      tma_load_2d(sr, map_r, &sm.full[s], (int)col0, 0);
    }
    return;
  }
  if (a.fill == kFillWords) {  // each row slice 4-byte aligned
    const int wx = ncol * ex / 4, wr = ncol * er / 4;
    for (int k = t; k < a.n * wx; k += blockDim.x) {
      const int i = k / wx, w = k - i * wx;
      cp_async4_zfill(sx + (size_t)i * a.cols * ex + 4 * w,
                      gx + ((long long)i * a.D + col0) * ex + 4 * w, 4);
    }
    for (int k = t; k < a.n * wr; k += blockDim.x) {
      const int i = k / wr, w = k - i * wr;
      cp_async4_zfill(sr + (size_t)i * a.cols * er + 4 * w,
                      gr + ((long long)i * a.D + col0) * er + 4 * w, 4);
    }
    cp_async_mbar_arrive(&sm.full[s]);
    return;
  }
  for (int k = t; k < a.n * ncol; k += blockDim.x) {  // element copies
    const int i = k / ncol, c = k - i * ncol;
    const long long g = (long long)i * a.D + col0 + c;
    if (a.xb)
      reinterpret_cast<__nv_bfloat16*>(sx)[i * a.cols + c] =
          static_cast<const __nv_bfloat16*>(a.x)[g];
    else
      reinterpret_cast<float*>(sx)[i * a.cols + c] =
          static_cast<const float*>(a.x)[g];
    if (a.rb)
      reinterpret_cast<__nv_bfloat16*>(sr)[i * a.cols + c] =
          static_cast<const __nv_bfloat16*>(a.res)[g];
    else
      reinterpret_cast<float*>(sr)[i * a.cols + c] =
          static_cast<const float*>(a.res)[g];
  }
  mbar_arrive(&sm.full[s]);
}

// x_i = sum_j W^T[j][i] deq[j] over j = 0 .. n-1 in order, for the unit's 4
// rows (W^T column offset wt, row stride n4) and 4 columns (deq column
// offset deq, row stride cols); W^T from shared memory or (WSM false)
// through the L1 from device memory.  Unrolled by 2: the loads of the next
// j are in flight under this one's 16 FMAs, and the registers stay within
// two blocks an SM.
template <bool WSM>
__device__ __forceinline__ void ring_mix(const float* wt, const float* deq,
                                         int n, int n4, int cols,
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const float4 w = WSM ? *reinterpret_cast<const float4*>(wt + j * n4)
                         : __ldg(reinterpret_cast<const float4*>(
                               wt + (size_t)j * n4));
    float dv[4];
    lds4(deq + j * cols, dv);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(wv[p], dv[q], acc[p][q]);
  }
}

// A (node, segment)'s partial |buf| over one row of the buffer, seg columns
// from p: lane l takes 4-column runs 4l, 4l + 128, ... (seg % 4 == 0) or
// columns l, l + 32, ..., each in order, then the butterfly.
template <int SCHEME>
__device__ __forceinline__ float row_partial(const float* p, int seg,
                                             int lane) {
  float acc = 0.f;
  if ((seg & 3) == 0) {
    for (int c = 4 * lane; c < seg; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      acc = combine<SCHEME>(acc, fabsf(v.x));
      acc = combine<SCHEME>(acc, fabsf(v.y));
      acc = combine<SCHEME>(acc, fabsf(v.z));
      acc = combine<SCHEME>(acc, fabsf(v.w));
    }
  } else {
    for (int c = lane; c < seg; c += 32) acc = combine<SCHEME>(acc, fabsf(p[c]));
  }
  return warp_combine<SCHEME>(acc);
}

// The scale of (row i, segment g) from the exchange slot: the cluster's
// partials combined in rank order.
template <int SCHEME>
__device__ __forceinline__ float ring_scale(const float* slot, int stride,
                                            int csize, float count) {
  float part[kMaxCluster];
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    part[k] = k < csize ? slot[k * stride] : 0.f;
  float acc = part[0];
#pragma unroll
  for (int k = 1; k < kMaxCluster; ++k)
    if (k < csize) acc = combine<SCHEME>(acc, part[k]);
  return scale_of<SCHEME>(acc, count);
}

// grid: (active clusters) x csize blocks in clusters of csize; block
// kRingThreads (two blocks an SM at U = 1: 128 registers a thread).
// Cluster c takes cluster tiles c, c + clusters, ...; a cluster tile is
// csize x cols columns (one group when csize > 1).  Unit u = t + 256 v (4
// rows x 4 columns) has row group u / CG and column group u % CG (CG = cols
// / 4), so a warp's lanes own consecutive columns of its rows and a warp
// holds whole row groups.  Where CG is a power of two <= 32 and a block's
// tile is one segment (`lanered`), a row's partial over the tile is the
// butterfly of those lanes' registers and its scale is computed and read
// within the warp; else buf goes through the shared buffer and one warp a
// (row, segment) reduces it.
template <int U, int SCHEME>
__global__ void __launch_bounds__(kRingThreads, U == 1 ? 2 : 1)
    quantized_gossip_mix_ring_kernel(const __grid_constant__ RingArgs a,
                                     const __grid_constant__ CUtensorMap
                                         map_x,
                                     const __grid_constant__ CUtensorMap
                                         map_r) {
  constexpr int CB = 4;  // a unit's columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const RingSmem sm = ring_smem(smem_raw, a);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = a.n, cols = a.cols, csize = a.csize, segs = a.segs;
  const long long cid = blockIdx.x / csize;
  const long long nclusters = gridDim.x / csize;
  const long long ccols = (long long)csize * cols;
  const long long ctiles = (a.D + ccols - 1) / ccols;
  const long long my_tiles =
      ctiles > cid ? (ctiles - cid + nclusters - 1) / nclusters : 0;

  if (t == 0) {
    if (a.fill == kFillTma) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_r))
                   : "memory");
    }
    for (int s = 0; s < a.stages; ++s)
      mbar_init(&sm.full[s], a.fill == kFillTma ? 1 : (int)blockDim.x);
    mbar_init(&sm.xbar[0], 1);
    mbar_init(&sm.xbar[1], 1);
    mbar_fence_init();
  }
  if (a.w_smem) {
    const int wsize = a.R * n * a.n4;
    for (int k = t; k < wsize; k += blockDim.x) sm.wt[k] = a.wt[k];
  }
  // every block of the cluster has started (its shared memory and barriers
  // may be written) and this block's barriers and W^T are ready
  cluster.sync();

  auto tile_col0 = [&](long long k) {
    return (cid + k * nclusters) * ccols + (long long)rank * cols;
  };
  auto tile_ncol = [&](long long col0) {
    return (int)(a.D - col0 < cols ? a.D - col0 : cols);
  };
  for (long long k = 0; k < a.stages && k < my_tiles; ++k) {
    const long long c0 = tile_col0(k);
    ring_fill(a, sm, &map_x, &map_r, (int)k, c0, tile_ncol(c0));
  }

  // This block's slot (`rank`) of both exchanges and both exchange
  // barriers; a block's partial of (row, segment) rs goes to slot + 4 rs in
  // every block of the cluster, mapped there by cluster_addr.
  const uint32_t my_slot[2] = {
      smem_addr(sm.exch + rank * n * segs),
      smem_addr(sm.exch + sm.exch_floats + rank * n * segs)};
  const uint32_t my_bar[2] = {smem_addr(&sm.xbar[0]), smem_addr(&sm.xbar[1])};
  const uint32_t xbytes = (uint32_t)sm.exch_floats * 4u;

  // the thread's units: rows i0 .. i0 + 3 (rows past n are padding) and
  // columns c0 .. c0 + CB - 1 of the tile, in segment g0 (the unit's
  // columns share it when seg % CB == 0)
  const int CG = cols / CB;
  const bool segcb = a.seg % CB == 0;
  const bool lanered = segs == 1 && CG <= 32 && (CG & (CG - 1)) == 0;
  // unit u = t + 256 v: row group u / CG, column group u % CG
  const int RG = a.n4 / 4;
  int ui0[U], uc0[U], ug0[U], urows[U];
#pragma unroll
  for (int v = 0; v < U; ++v) {
    const int u = t + v * kRingThreads;
    ui0[v] = 4 * (u / CG);
    uc0[v] = CB * (u % CG);
    ug0[v] = uc0[v] / a.seg;
    // valid rows of the unit (0 for a thread without it)
    urows[v] = u / CG < RG ? (n - ui0[v] < 4 ? n - ui0[v] : 4) : 0;
  }
  const float count = (float)a.group;
  float xr[U][4][CB], rr[U][4][CB];
  unsigned q = 0;  // rounds so far: the buffer and exchange slot parity

  for (long long k = 0; k < my_tiles; ++k) {
    const int s = (int)(k % a.stages);
    const long long col0 = tile_col0(k);
    const int ncol = tile_ncol(col0);
    mbar_wait(&sm.full[s], (uint32_t)((k / a.stages) & 1));
    const unsigned char* sx = sm.stage + (size_t)s * sm.stage_bytes;
    const unsigned char* sr = sx + sm.x_bytes;
#pragma unroll
    for (int v = 0; v < U; ++v) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float xv[CB], rv[CB];
#pragma unroll
        for (int c = 0; c < CB; ++c) xv[c] = rv[c] = 0.f;
        if (p < urows[v]) {
          const long long e = (long long)(ui0[v] + p) * cols + uc0[v];
          ldv<CB>(sx, e, a.xb, xv);
          ldv<CB>(sr, e, a.rb, rv);
        }
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const bool live = uc0[v] + c < ncol;  // stale past a short tile
          xr[v][p][c] = live ? xv[c] : 0.f;
          rr[v][p][c] = live ? rv[c] : 0.f;
        }
      }
    }

    for (int r = 0; r < a.R; ++r, ++q) {
      float* wb = sm.wb + (q & 1) * sm.wb_floats;
      const float* ex_slot = sm.exch + (q & 1) * sm.exch_floats;
      const uint32_t slot = my_slot[q & 1], bar = my_bar[q & 1];
      // buf = x + res
#pragma unroll
      for (int v = 0; v < U; ++v)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int c = 0; c < CB; ++c)
            xr[v][p][c] = __fadd_rn(xr[v][p][c], rr[v][p][c]);
      // each (node, segment)'s |buf| over the block's columns, to every
      // block of the cluster (slot `rank` of its exchange), completing on
      // that block's barrier of this parity
      if (lanered) {
#pragma unroll
        for (int v = 0; v < U; ++v) {
          float pr[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float acc = 0.f;
#pragma unroll
            for (int c = 0; c < CB; ++c)
              acc = combine<SCHEME>(acc, fabsf(xr[v][p][c]));
            pr[p] = acc;
          }
          // each row's partial over the row group's CG lanes (every lane
          // ends with the same bits); lane li of the group sends row li % 4
          // to rank li / 4
#pragma unroll
          for (int p = 0; p < 4; ++p)
            for (int off = CG >> 1; off > 0; off >>= 1)
              pr[p] = combine<SCHEME>(
                  pr[p], __shfl_xor_sync(0xffffffffu, pr[p], off));
          for (int li = lane & (CG - 1); li < 4 * csize; li += CG) {
            const int p = li & 3, rk = li >> 2;
            if (p < urows[v]) {
              const float val = p == 0 ? pr[0] : p == 1 ? pr[1]
                                               : p == 2 ? pr[2] : pr[3];
              st_async(cluster_addr(slot + 4u * (ui0[v] + p), rk), val,
                       cluster_addr(bar, rk));
            }
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < U; ++v) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (p < urows[v])
              sts4(wb + (ui0[v] + p) * cols + uc0[v], xr[v][p]);
          }
        }
        __syncthreads();
        for (int rs = warp; rs < n * segs; rs += blockDim.x / 32) {
          const int i = rs / segs, g = rs - i * segs;
          const float part =
              row_partial<SCHEME>(wb + i * cols + g * a.seg, a.seg, lane);
          if (lane < csize)
            st_async(cluster_addr(slot + 4u * rs, lane), part,
                     cluster_addr(bar, lane));
        }
      }
      if (t == 0) mbar_arrive_expect_tx(&sm.xbar[q & 1], xbytes);
      // every block's partials of this round are here, and so every warp
      // of this block is done reading buf and (round 0) the stage
      mbar_wait(&sm.xbar[q & 1], (q >> 1) & 1);
      if (r == 0 && k + a.stages < my_tiles) {
        const long long c0 = tile_col0(k + a.stages);
        ring_fill(a, sm, &map_x, &map_r, s, c0, tile_ncol(c0));
      }
      // quantize -> dequantize (the error into rr), deq into the buffer
      if (lanered) {
        // each row's scale once, by a lane of the warp that owns the row
        // (a warp holds whole row groups), for the warp's lanes to read
#pragma unroll
        for (int v = 0; v < U; ++v)
          for (int k = lane & (CG - 1); k < urows[v]; k += CG)
            sm.scale[ui0[v] + k] =
                ring_scale<SCHEME>(ex_slot + ui0[v] + k, n, csize, count);
        __syncwarp();
      }
#pragma unroll
      for (int v = 0; v < U; ++v) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (p >= urows[v]) continue;
          const int i = ui0[v] + p;
          float sc[CB];
          if (lanered) {
            const float s0 = sm.scale[i];
#pragma unroll
            for (int c = 0; c < CB; ++c) sc[c] = s0;
          } else if (segcb) {
            const float s0 = ring_scale<SCHEME>(ex_slot + i * segs + ug0[v],
                                                n * segs, csize, count);
#pragma unroll
            for (int c = 0; c < CB; ++c) sc[c] = s0;
          } else {
#pragma unroll
            for (int c = 0; c < CB; ++c)
              sc[c] = ring_scale<SCHEME>(
                  ex_slot + i * segs + (uc0[v] + c) / a.seg, n * segs, csize,
                  count);
          }
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            const float b = xr[v][p][c];
            const float d = dequant<SCHEME>(b, sc[c]);
            if (a.ef) rr[v][p][c] = __fsub_rn(b, d);
            xr[v][p][c] = d;
          }
          sts4(wb + i * cols + uc0[v], xr[v][p]);
        }
      }
      __syncthreads();
      // x = W_r @ deq
      const float* wt = (a.w_smem ? sm.wt : a.wt) + (size_t)r * n * a.n4;
#pragma unroll
      for (int v = 0; v < U; ++v) {
        if (urows[v] == 0) continue;
        if (a.w_smem)
          ring_mix<true>(wt + ui0[v], wb + uc0[v], n, a.n4, cols, xr[v]);
        else
          ring_mix<false>(wt + ui0[v], wb + uc0[v], n, a.n4, cols, xr[v]);
      }
    }

    // store the unit's rows of x and res, once
#pragma unroll
    for (int v = 0; v < U; ++v) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p >= urows[v]) continue;
        const long long g = (long long)(ui0[v] + p) * a.D + col0 + uc0[v];
        if (a.vst && uc0[v] + CB <= ncol) {
          stv<CB>(a.out, g, xr[v][p], a.xb);
          if (a.write_res) stv<CB>(a.res_out, g, rr[v][p], a.rb);
        } else {
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            if (uc0[v] + c >= ncol) continue;
            st1(a.out, g + c, xr[v][p][c], a.xb);
            if (a.write_res) st1(a.res_out, g + c, rr[v][p][c], a.rb);
          }
        }
      }
    }
  }
  // nothing is in flight: every filled stage was waited on, and every
  // partial sent to this block arrived before its last round went on
}

// The (D, n) view of a contiguous (n, D) tensor cut in boxes of cols
// columns x all n rows (n, cols <= kMaxBox); columns past D read as zeros.
bool tile_map(CUtensorMap* map, const void* ptr, int bf, int n, long long D,
              int cols) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const int e = bf ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)D * e};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)n};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ring launch: as many clusters as are resident at once (capped by the
// cluster tiles), each walking its tiles.  With `grid` given, only the
// blocks of that launch are written there and nothing is launched.
template <int U, int SCHEME>
cudaError_t launch_ring(const RingArgs& a, int smem, cudaStream_t stream,
                        int* grid) {
  cudaError_t err =
      allow_smem<quantized_gossip_mix_ring_kernel<U, SCHEME>>(kMaxSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kRingThreads);
  cfg.gridDim = dim3(a.csize);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, quantized_gossip_mix_ring_kernel<U, SCHEME>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const long long ccols = (long long)a.csize * a.cols;
  const long long ctiles = (a.D + ccols - 1) / ccols;
  if (clusters > ctiles) clusters = (int)ctiles;
  cfg.gridDim = dim3(clusters * a.csize);
  if (grid) {
    *grid = clusters * a.csize;
    return cudaSuccess;
  }
  CUtensorMap map_x = {}, map_r = {};
  if (a.fill == kFillTma &&
      !(tile_map(&map_x, a.x, a.xb, a.n, a.D, a.cols) &&
        tile_map(&map_r, a.res, a.rb, a.n, a.D, a.cols)))
    return cudaErrorInvalidValue;
  err = cudaLaunchKernelEx(&cfg,
                           quantized_gossip_mix_ring_kernel<U, SCHEME>, a,
                           map_x, map_r);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The stream route
// ---------------------------------------------------------------------------

struct StreamArgs {
  const float* wt;  // (R, n, npad): W_r^T, rows padded with zeros
  const void* x;
  const void* res;
  void* out;
  void* res_out;
  float* tmp;       // slots x (n x group x 2) f32 scratch, or null
  int slots;
  long long D;
  int R, n, npad, group, ef, write_res, xb, rb;
  int sw;           // the slab of columns the mix pass takes at a time
};

// Element i of a device-memory array, f32 or bf16, by global-space loads and
// stores: through a generic pointer the compiler would not know the space
// and would emit generic accesses (half the stream route's speed).  In
// program order, so a launch in place reads each value before it writes it.
__device__ __forceinline__ float gld(const void* p, long long i, bool bf) {
  if (bf) {
    unsigned short u;
    asm volatile("ld.global.u16 %0, [%1];"
                 : "=h"(u)
                 : "l"(static_cast<const __nv_bfloat16*>(p) + i));
    return __uint_as_float((uint32_t)u << 16);
  }
  float v;
  asm volatile("ld.global.f32 %0, [%1];"
               : "=f"(v)
               : "l"(static_cast<const float*>(p) + i));
  return v;
}
__device__ __forceinline__ void gst(void* p, long long i, float v, bool bf) {
  if (bf) {
    const unsigned short u = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    asm volatile("st.global.u16 [%0], %1;" ::"l"(
                     static_cast<__nv_bfloat16*>(p) + i),
                 "h"(u)
                 : "memory");
  } else {
    asm volatile("st.global.f32 [%0], %1;" ::"l"(static_cast<float*>(p) + i),
                 "f"(v)
                 : "memory");
  }
}

// An (n, columns) view of device memory: element (i, c) at p[i * ld + c].
// View<false> (a launch of f32 x and res) holds a float pointer and loads
// plainly, so the compiler keeps the accesses global and batches a loop's
// loads; View<true> (a launch with a bf16 input) holds the dtype beside the
// pointer and goes through gld / gst.
template <bool BF>
struct View;
template <>
struct View<false> {
  float* p;
  long long ld;
  __device__ __forceinline__ float get(int i, int c) const {
    return p[(long long)i * ld + c];
  }
  __device__ __forceinline__ void put(int i, int c, float v) const {
    p[(long long)i * ld + c] = v;
  }
};
template <>
struct View<true> {
  void* p;
  long long ld;
  bool bf;
  __device__ __forceinline__ float get(int i, int c) const {
    return gld(p, (long long)i * ld + c, bf);
  }
  __device__ __forceinline__ void put(int i, int c, float v) const {
    gst(p, (long long)i * ld + c, v, bf);
  }
};

// The view of an (n, D) input or output from column c0 on.
template <bool BF>
__device__ __forceinline__ View<BF> view_at(const void* p, long long D,
                                            bool bf, long long c0) {
  if constexpr (BF)
    return View<true>{
        const_cast<unsigned char*>(static_cast<const unsigned char*>(p)) +
            c0 * (bf ? 2 : 4),
        D, bf};
  else
    return View<false>{const_cast<float*>(static_cast<const float*>(p)) + c0,
                       D};
}

// A block's f32 scratch rows (n x group from p).
__device__ __forceinline__ View<true> scratch_view(float* p, int group) {
  return View<true>{p, group, false};
}

// smem: the group's n scales (padded to 4), then a slab's deq (n x sw).
// BF: x or res is bf16.
template <int SCHEME, bool BF>
__global__ void __launch_bounds__(kStreamThreads)
    quantized_gossip_mix_stream_kernel(const __grid_constant__ StreamArgs a) {
  using V = View<BF>;
  constexpr int CH = kStreamChunk;
  extern __shared__ float smem[];
  const int n = a.n, group = a.group, sw = a.sw, npad = a.npad;
  float* sc_s = smem;
  float* deq_s = sc_s + ((n + 3) & ~3);
  const int chunks = npad / CH;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float count = (float)group;
  const long long groups = a.D / group;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long c0 = g * group;
    const V in_x = view_at<BF>(a.x, a.D, a.xb, c0);
    const V in_r = view_at<BF>(a.res, a.D, a.rb, c0);
    const V out_x = view_at<BF>(a.out, a.D, a.xb, c0);
    const V out_r = view_at<BF>(a.res_out, a.D, a.rb, c0);
    // a round's state between rounds: the outputs (both f32), or this
    // block's f32 scratch slot (a bf16 launch of R > 1; the grid has at
    // most `slots` blocks)
    V mid_x = out_x, mid_r = out_r;
    if constexpr (BF) {
      if (a.tmp) {
        float* tx = a.tmp + (size_t)blockIdx.x * 2 * n * group;
        mid_x = scratch_view(tx, group);
        mid_r = scratch_view(tx + (size_t)n * group, group);
      }
    }
    for (int r = 0; r < a.R; ++r) {
      // round 0 reads the inputs, later rounds what the last one wrote; with
      // error feedback off the residual stays the input's
      const V sx = r == 0 ? in_x : mid_x;
      const V sr = (r == 0 || !a.ef) ? in_r : mid_r;
      const V dx = r == a.R - 1 ? out_x : mid_x;
      const V dr = r == a.R - 1 ? out_r : mid_r;
      for (int i = warp; i < n; i += kStreamWarps) {
        float acc = 0.f;
        for (int c = lane; c < group; c += 32)
          acc = combine<SCHEME>(acc, fabsf(__fadd_rn(sx.get(i, c),
                                                     sr.get(i, c))));
        acc = warp_combine<SCHEME>(acc);
        if (lane == 0) sc_s[i] = scale_of<SCHEME>(acc, count);
      }
      __syncthreads();
      const float* wr = a.wt + (size_t)r * n * npad;
      for (int s0 = 0; s0 < group; s0 += sw) {
        const int wcols = group - s0 < sw ? group - s0 : sw;
        for (int k = threadIdx.x; k < n * wcols; k += blockDim.x) {
          const int j = k / wcols, c = s0 + k - j * wcols;
          const float b = __fadd_rn(sx.get(j, c), sr.get(j, c));
          const float d = dequant<SCHEME>(b, sc_s[j]);
          if (a.ef) dr.put(j, c, __fsub_rn(b, d));
          deq_s[j * sw + (c - s0)] = d;
        }
        __syncthreads();  // the slab's inputs are all read
        // x[i0 .. i0 + CH) of column cc: W^T's padded rows need no i < n
        // test until the store
        for (int k = threadIdx.x; k < chunks * wcols; k += blockDim.x) {
          const int ch = k / wcols, cc = k - ch * wcols, i0 = ch * CH;
          float acc[CH];
#pragma unroll
          for (int i = 0; i < CH; ++i) acc[i] = 0.f;
          for (int j = 0; j < n; ++j) {
            const float d = deq_s[j * sw + cc];
            const float4* wp =
                reinterpret_cast<const float4*>(wr + (size_t)j * npad + i0);
#pragma unroll
            for (int q = 0; q < CH / 4; ++q) {
              const float4 w = __ldg(wp + q);
              acc[4 * q] = fmaf(w.x, d, acc[4 * q]);
              acc[4 * q + 1] = fmaf(w.y, d, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(w.z, d, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(w.w, d, acc[4 * q + 3]);
            }
          }
#pragma unroll
          for (int i = 0; i < CH; ++i)
            if (i0 + i < n) dx.put(i0 + i, s0 + cc, acc[i]);
        }
        __syncthreads();  // deq_s is written again by the next slab
      }
      __syncthreads();  // the next round reads these columns and sc_s
    }
    if (!a.ef && a.write_res) {  // the residual passes through
      for (int i = 0; i < n; ++i)
        for (int c = threadIdx.x; c < group; c += blockDim.x)
          out_r.put(i, c, in_r.get(i, c));
    }
  }
}

template <int SCHEME, bool BF>
cudaError_t launch_stream(const StreamArgs& a, int smem, cudaStream_t stream) {
  auto kern = quantized_gossip_mix_stream_kernel<SCHEME, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kStreamThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (long long)sms * per_sm;
  const long long groups = a.D / a.group;
  if (blocks > groups) blocks = groups;
  if (a.tmp && blocks > a.slots) blocks = a.slots;
  kern<<<(int)blocks, kStreamThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The ring kernels built: one unit a thread or two.
template <int SCHEME>
cudaError_t dispatch_ring(const RingArgs& a, int units, int smem,
                          cudaStream_t s, int* grid) {
  if (units == 1) return launch_ring<1, SCHEME>(a, smem, s, grid);
  if (units == 2) return launch_ring<2, SCHEME>(a, smem, s, grid);
  return cudaErrorInvalidValue;
}

template <int U, int SCHEME>
cudaError_t ring_resources(int* r) {
  return kernel_resources<quantized_gossip_mix_ring_kernel<U, SCHEME>>(0, r);
}
template <int SCHEME>
cudaError_t stream_resources(int* r) {
  return kernel_resources<quantized_gossip_mix_stream_kernel<SCHEME, false>>(
      0, r);
}

// The ring route's arguments from the launch's shapes and parameters p (see
// quantized_gossip_mix_launch); false where they do not describe a ring.
bool ring_args(RingArgs* a, const void* wt, const void* x, const void* res,
               void* out, void* res_out, int R, int n, long long D,
               int group, int ef, int write_res, int xb, int rb,
               const int* p) {
  *a = RingArgs{};
  a->wt = static_cast<const float*>(wt);
  a->x = x;
  a->res = res;
  a->out = out;
  a->res_out = res_out;
  a->D = D;
  a->R = R;
  a->n = n;
  a->group = group;
  a->cols = p[1];
  a->csize = p[2];
  a->stages = p[3];
  a->fill = p[4];
  a->vst = p[5];
  a->w_smem = p[6];
  a->n4 = p[7];
  a->ef = ef;
  a->write_res = write_res;
  a->xb = xb;
  a->rb = rb;
  // a cluster splits one group; a lone block takes whole groups
  const bool split = a->csize > 1;
  if (a->cols < 4 || a->cols % 4 != 0 || a->csize < 1 ||
      (p[0] != 1 && p[0] != 2) ||
      (a->n4 / 4) * (a->cols / 4) > p[0] * kRingThreads ||
      a->csize > kMaxCluster || (a->csize & (a->csize - 1)) != 0 ||
      a->stages < 1 || a->stages > kMaxStages || a->n4 < n ||
      a->n4 % 4 != 0 ||
      (split ? (long long)a->cols * a->csize != group
             : a->cols % group != 0) ||
      a->fill < kFillTma || a->fill > kFillElems ||
      (a->fill == kFillTma && (a->cols > kMaxBox || n > kMaxBox)) ||
      wt == nullptr)
    return false;
  a->seg = split ? a->cols : group;
  a->segs = a->cols / a->seg;
  return true;
}

}  // namespace

// ws: (R, n, n) f32 (the regs route reads it); wt: W_r transposed, rows
// padded with zeros, (R, n, n4) f32 for the ring, (R, n, npad) for the
// stream route (may be null for regs); x, res, out, res_out: (n, D)
// contiguous, f32 or (xb, rb) bf16, out may be x and res_out may be res;
// group >= 1 dividing D; scheme 0 = sign, 1 = int8; ef: error feedback
// on/off; write_res: store res_out (0 only when res is unchanged and res_out
// == res).  route 0 = regs (n <= 16, group a power of two <= 256; p0 = vec
// 1 or 4); route 1 = ring (p0 = units a thread, 1 or 2; p1 = cols, p2 =
// csize, p3 = stages, p4 = fill, p5 = vst, p6 = w_smem, p7 = n4); route 2 =
// stream (p0 = slab columns, p1 = npad, a multiple of 16; tmp: f32 scratch
// of `slots` blocks or null).  smem: the dynamic shared bytes the wrapper
// computed.  Launches on `stream` and returns the launch's cudaError_t (0 =
// queued).
extern "C" int quantized_gossip_mix_launch(
    const void* ws, const void* wt, const void* x, const void* res, void* out,
    void* res_out, void* tmp, int slots, int R, int n, long long D, int group,
    int scheme, int ef, int write_res, int xb, int rb, int route, int smem,
    const int* p, void* stream) {
  if (R < 1 || n < 1 || D < 1 || group < 1 || D % group != 0 ||
      (scheme != 0 && scheme != 1) || smem < 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(ws);
  if (route == kRouteRegs) {
    if (n > kRegsNodes || group > kRegsGroup || (group & (group - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    if (scheme == 0)
      return (int)dispatch<0>(w, x, res, out, res_out, R, n, D, group, ef,
                              write_res, p[0], xb, rb, s);
    return (int)dispatch<1>(w, x, res, out, res_out, R, n, D, group, ef,
                            write_res, p[0], xb, rb, s);
  }
  if (route == kRouteRing) {
    RingArgs a;
    if (!ring_args(&a, wt, x, res, out, res_out, R, n, D, group, ef,
                   write_res, xb, rb, p))
      return (int)cudaErrorInvalidValue;
    if (scheme == 0) return (int)dispatch_ring<0>(a, p[0], smem, s, nullptr);
    return (int)dispatch_ring<1>(a, p[0], smem, s, nullptr);
  }
  if (route == kRouteStream) {
    StreamArgs a = {};
    a.wt = static_cast<const float*>(wt);
    a.x = x;
    a.res = res;
    a.out = out;
    a.res_out = res_out;
    a.tmp = static_cast<float*>(tmp);
    a.slots = slots;
    a.D = D;
    a.R = R;
    a.n = n;
    a.group = group;
    a.ef = ef;
    a.write_res = write_res;
    a.xb = xb;
    a.rb = rb;
    a.sw = p[0];
    a.npad = p[1];
    if (a.sw < 1 || a.npad < n || a.npad % kStreamChunk != 0 ||
        wt == nullptr || (a.tmp && slots < 1))
      return (int)cudaErrorInvalidValue;
    const bool bf = xb || rb;
    if (scheme == 0)
      return (int)(bf ? launch_stream<0, true>(a, smem, s)
                      : launch_stream<0, false>(a, smem, s));
    return (int)(bf ? launch_stream<1, true>(a, smem, s)
                    : launch_stream<1, false>(a, smem, s));
  }
  return (int)cudaErrorInvalidValue;
}

// The compiled ring or stream kernel a launch runs (route 1: variant = units
// a thread; route 2: its f32 instance, variant unused): out[0] registers and
// out[1] spilled (local) bytes a thread, out[2] static shared bytes, out[3]
// threads a block.
extern "C" int quantized_gossip_mix_resources(int route, int variant,
                                              int scheme, int* out) {
  int r[4] = {0, 0, 0, 0};
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kRouteRing) {
    out[3] = kRingThreads;
    if (variant == 1)
      err = scheme == 0 ? ring_resources<1, 0>(r) : ring_resources<1, 1>(r);
    else if (variant == 2)
      err = scheme == 0 ? ring_resources<2, 0>(r) : ring_resources<2, 1>(r);
  } else if (route == kRouteStream) {
    out[3] = kStreamThreads;
    err = scheme == 0 ? stream_resources<0>(r) : stream_resources<1>(r);
  }
  if (scheme != 0 && scheme != 1) err = cudaErrorInvalidValue;
  out[0] = r[0];
  out[1] = r[1];
  out[2] = r[2];
  return (int)err;
}

// The blocks a ring launch with these shapes and parameters p runs (active
// clusters x csize, capped by the tiles), into *grid; launches nothing.
extern "C" int quantized_gossip_mix_ring_grid(int R, int n, long long D,
                                              int group, int scheme, int xb,
                                              int rb, int smem, const int* p,
                                              int* grid) {
  RingArgs a;
  static const float dummy = 0.f;
  if (!ring_args(&a, &dummy, nullptr, nullptr, nullptr, nullptr, R, n, D,
                 group, 1, 1, xb, rb, p) ||
      smem < 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (scheme == 0) return (int)dispatch_ring<0>(a, p[0], smem, 0, grid);
  return (int)dispatch_ring<1>(a, p[0], smem, 0, grid);
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* quantized_gossip_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
