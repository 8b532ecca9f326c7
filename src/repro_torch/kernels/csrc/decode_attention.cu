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
// scratch.
//
// What bounds it on this card: bytes.  Every cache slot's k and v are read
// once, 2 * C * hd values per (b, j), against 4 * G * C * hd flops: at the
// serve path's decode (C = 2048, J = 16, G = 1, hd = 64, bf16) 8.4 MB, 2.5 us
// at 3.35 TB/s.  To come near that the card needs many bytes in flight on
// many SMs, and one block per (b, j) gives 16 blocks for 132 SMs.
//
// What the design does (flash-decoding inside one thread-block cluster):
// the cache axis is split S ways (S = `splits`, 1 .. 8, chosen by the
// wrapper so that B * J * S fills the SMs), and the S blocks of one (b, j)
// form a cluster.  Block r streams slots [r C / S, (r + 1) C / S) in tiles
// of 64 through a ring of cp.async stages (k, v and kpos; q joins the first
// group), k and v kept in their own dtype in shared memory (16-byte chunks
// XOR-swizzled by slot, so the reads below hit distinct banks) and widened
// to f32 in registers; the next tiles are in flight while one is computed.
// Per tile: two threads per slot compute its scores for the G rows (a
// shuffle joins the two halves of hd), one warp per row takes the tile's
// max and sum, and for the PV product a thread owns one column of hd and a
// share of the slots, row by row, its running sums in shared memory.  Each
// block then writes its rows' (m, l, acc) into rank 0's shared memory
// (distributed shared memory), and after one cluster barrier rank 0
// combines the splits in rank order:
//
//     M = max_r m_r,  L = sum_r e^(m_r - M) l_r,
//     o = sum_r e^(m_r - M) acc_r / max(L, 1e-30),
//
// a fixed order, so reruns give the same bits.  One launch, no atomics, no
// second pass.  (A first version kept the G rows' PV sums in registers,
// each behind a branch on G, which serialised the PV loop: 0.030 ms at the
// serve path's decode on an H100, this one 0.009.)
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

#include "hopper_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;       // cache slots per tile
constexpr int kThreads = 128;   // two per slot in the score phase
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;       // query rows per KV head the kernel takes
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr float kNegInf = -1e30f;
constexpr int kMaxGridY = 65535;

template <typename T, int HD>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);      // values per 16-byte chunk
  static constexpr int CPR = HD / VEC;            // chunks per cache row
  static constexpr int SWZ = (CPR < 8 ? CPR : 8) - 1;
  static constexpr int TILE_BYTES = kTile * HD * (int)sizeof(T);
  // as many stages of k and v as fit in 64 KB, 2 to 4
  static constexpr int NS0 = 65536 / (2 * TILE_BYTES);
  static constexpr int STAGES = NS0 < 2 ? 2 : (NS0 > 4 ? 4 : NS0);
  static constexpr int NP = kThreads / HD;        // slot shares in PV
  // K and V rings (own dtype), kpos per stage, q (own dtype), then f32:
  // S (G x kTile), the PV sums (NP x G x HD), m, l, alpha
  static constexpr int RING_BYTES = 2 * STAGES * TILE_BYTES;
  static constexpr int KPOS_BYTES = STAGES * kTile * 4;
  static constexpr int Q_BYTES = kMaxG * HD * (int)sizeof(T);
  static constexpr int BASE_BYTES =
      RING_BYTES + KPOS_BYTES + Q_BYTES +
      (int)sizeof(float) * (kMaxG * kTile + NP * kMaxG * HD + 3 * kMaxG);
  // + rank 0's gather of every split's (m, l, acc): splits x (2 G + G HD)
  static int smem_bytes(int splits, int G) {
    return BASE_BYTES + (int)sizeof(float) * splits * (2 * G + G * HD);
  }
};

// Where value e of slot s lies in a tile of the ring.
template <typename T, int HD>
__device__ __forceinline__ int swz(int s, int e) {
  using C = Cfg<T, HD>;
  return s * HD + (((e / C::VEC) ^ (s & C::SWZ)) * C::VEC) + e % C::VEC;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + NS * kTile * HD;
  int* sKp = reinterpret_cast<int*>(smem + Cf::RING_BYTES);
  T* sQ = reinterpret_cast<T*>(smem + Cf::RING_BYTES + Cf::KPOS_BYTES);
  float* sS = reinterpret_cast<float*>(smem + Cf::RING_BYTES +
                                       Cf::KPOS_BYTES + Cf::Q_BYTES);
  float* sO = sS + kMaxG * kTile;
  float* sM = sO + NP * kMaxG * HD;
  float* sL = sM + kMaxG;
  float* sA = sL + kMaxG;
  float* sGather = sA + kMaxG;   // rank 0: split r at r (2 G + G HD)

  cg::cluster_group cluster = cg::this_cluster();
  // every block has started before any writes to another's shared memory:
  // arrive now, wait (long after) just before the first such write
  cluster_arrive_relaxed();
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int rank = (int)cluster.block_rank();   // == blockIdx.x % splits
  const int j = blockIdx.x / splits, b = blockIdx.y;
  const long long row = (long long)J * HD;      // stride of k between slots
  const T* kb = k + (long long)b * C * row + (long long)j * HD;
  const T* vb = v + (long long)b * C * row + (long long)j * HD;
  const int chunk = (C + splits - 1) / splits;
  const int c_begin = rank * chunk;
  const int c_end = min(C, c_begin + chunk);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTile - 1) / kTile
                                      : 0;

  // q of the G rows, into the first group
  const T* qb = q + ((long long)b * J + j) * G * HD;
  for (int i = t; i < G * CPR; i += kThreads)
    cp_async16_zfill(sQ + i * VEC, qb + i * VEC, 16);
  // tile `it` of this split into stage `it % NS`: CPR / 2 chunks of k and
  // of v per thread, slots past c_end as zeros; its kpos, 4 slots a chunk
  auto issue = [&](int it) {
    if (it < n_tiles) {
      const int c0 = c_begin + it * kTile;
      T* dk = sK + (it % NS) * kTile * HD;
      T* dv = sV + (it % NS) * kTile * HD;
#pragma unroll
      for (int n = 0; n < kTile * CPR / kThreads; ++n) {
        const int i = t + n * kThreads;
        const int s = i / CPR, e = (i % CPR) * VEC;
        const bool in = c0 + s < c_end;
        const long long off = in ? (long long)(c0 + s) * row + e : 0;
        cp_async16_zfill(dk + swz<T, HD>(s, e), kb + off, in ? 16 : 0);
        cp_async16_zfill(dv + swz<T, HD>(s, e), vb + off, in ? 16 : 0);
      }
      if (t < kTile / 4) {
        const int c = c0 + 4 * t;
        const int n = min(4, max(0, c_end - c));
        cp_async16_zfill(sKp + (it % NS) * kTile + 4 * t, kpos + (n ? c : 0),
                         4 * n);
      }
    }
    cp_async_commit();   // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int it = 0; it < NS - 1; ++it) issue(it);

  if (t < G) {
    sM[t] = kNegInf;
    sL[t] = 0.f;
  }
  // PV: this thread owns column d of rows 0 .. G - 1 over the tile's slots
  // part, part + NP, ...; its running sums sit in sO
  const int d = t % HD, part = t / HD;
  for (int g = 0; g < G; ++g) sO[(part * kMaxG + g) * HD + d] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<NS - 2>();   // this thread's copies of tile `it` landed
    __syncthreads();           // everyone's did; tile it - 1 is consumed
    issue(it + NS - 1);        // into the stage tile it - 1 used
    const T* tk = sK + (it % NS) * kTile * HD;
    const T* tv = sV + (it % NS) * kTile * HD;
    const int c0 = c_begin + it * kTile;

    // scores: slot s = t / 2, half h = t % 2 of hd
    {
      const int s = t >> 1, h = t & 1;
      const int c = c0 + s;
      const int kp = sKp[(it % NS) * kTile + s];
      const bool valid = c < c_end && kp >= 0 && kp <= pos &&
                         (window == 0 || kp > pos - window);
      float kr[HD / 2];
#pragma unroll
      for (int n = 0; n < CPR / 2; ++n) {
        const int e = (h * (CPR / 2) + n) * VEC;
        unpack_f32(T(), *reinterpret_cast<const uint4*>(tk + swz<T, HD>(s, e)),
                   kr + n * VEC);
      }
      for (int g = 0; g < G; ++g) {
        const T* qg = sQ + g * HD + h * (HD / 2);
        float a = 0.f;
#pragma unroll
        for (int n = 0; n < CPR / 2; ++n) {
          float qv[VEC];
          unpack_f32(T(), *reinterpret_cast<const uint4*>(qg + n * VEC), qv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) a = fmaf(qv[e], kr[n * VEC + e], a);
        }
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        if (h == 0)
          sS[g * kTile + s] =
              c >= c_end ? -INFINITY : (valid ? a * scale : kNegInf);
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per row
    for (int g = warp; g < G; g += kWarps) {
      float sv[kTile / 32];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        sv[i] = sS[g * kTile + lane + 32 * i];
        mx = fmaxf(mx, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const float p = expf(sv[i] - m_new);
        sum += p;
        sS[g * kTile + lane + 32 * i] = round_to<T>(p);
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
    for (int g = 0; g < G; ++g) {
      const float* p = sS + g * kTile;
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / NP; ++i) {
        const int s = part + NP * i;
        a = fmaf(p[s], to_f32(tv[swz<T, HD>(s, d)]), a);
      }
      float& og = sO[(part * kMaxG + g) * HD + d];
      og = fmaf(og, sA[g], a);
    }
  }
  cp_async_wait<0>();   // no copy may land after the block has moved on
  __syncthreads();      // every share's sums are in sO

  // this split's (m, l, acc) into rank 0's gather, the NP shares summed in
  // order; then rank 0 alone combines the splits in rank order
  cluster_wait();   // every block of the cluster has started
  const int stride = 2 * G + G * HD;
  float* dst = cluster.map_shared_rank(sGather, 0) + rank * stride;
  if (t < G) {
    dst[t] = sM[t];
    dst[G + t] = sL[t];
  }
  if (part == 0)
    for (int g = 0; g < G; ++g) {
      float a = sO[g * HD + d];
      for (int p = 1; p < NP; ++p) a += sO[(p * kMaxG + g) * HD + d];
      dst[2 * G + g * HD + d] = a;
    }
  cluster.sync();   // every split's state has landed in rank 0
  if (rank != 0) return;
  T* ob = o + ((long long)b * J + j) * G * HD;
  for (int i = t; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float M = kNegInf;
    for (int r = 0; r < splits; ++r) M = fmaxf(M, sGather[r * stride + g]);
    float L = 0.f, out = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* st = sGather + r * stride;
      const float w = expf(st[g] - M);
      L = fmaf(w, st[G + g], L);
      out = fmaf(w, st[2 * G + i], out);
    }
    ob[i] = from_f32<T>(out / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kpos, void* o, int B, int C, int J, int G,
                   int splits, int pos, int window, float scale,
                   cudaStream_t stream) {
  using Cf = Cfg<T, HD>;
  cudaError_t err = allow_smem<decode_attention_kernel<T, HD>>(
      Cf::smem_bytes(kMaxSplits, kMaxG));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(J * splits, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cf::smem_bytes(splits, G);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, HD>,
                           static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), kpos, static_cast<T*>(o),
                           C, J, G, splits, pos, window, scale);
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
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, 1, J, G, hd), k and v: (B, C, J, hd), o: (B, 1, J * G, hd), all
// contiguous, 16-byte aligned and of one dtype, f32 (dtype 0) or bf16
// (dtype 1); kpos: (C,) int32; hd 32, 64 or 128; 1 <= G <= 16; window 0 =
// none; 1 <= splits <= 8, and with splits > 1 C a multiple of 64 * splits.
// One launch on `stream` of J * splits x B blocks in clusters of `splits`;
// returns the launch's cudaError_t (0 = queued).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* kpos,
                                       void* o, int B, int C, int J, int G,
                                       int hd, int splits, int pos,
                                       int window, float scale, int dtype,
                                       void* stream) {
  if (B < 1 || C < 1 || J < 1 || G < 1 || G > kMaxG || window < 0 ||
      B > kMaxGridY || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && C % (kTile * splits) != 0))
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
        Cfg<T, HD>::smem_bytes(kMaxSplits, kMaxG), out);             \
  }
  if (dtype == 0) {
    DECODE_CASE(float, 32) DECODE_CASE(float, 64) DECODE_CASE(float, 128)
  } else if (dtype == 1) {
    DECODE_CASE(__nv_bfloat16, 32) DECODE_CASE(__nv_bfloat16, 64)
    DECODE_CASE(__nv_bfloat16, 128)
  }
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
