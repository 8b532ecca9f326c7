// Edge-list gossip segment sum for Hopper (sm_90a): one round of sparse
// gossip in Laplacian form, the per-receiver update
//
//     delta[s] = sum_{e in [offsets[s], offsets[s+1])} w[e] * (x[src[e]] - x[dst[e]])
//
// for an (n, D) node-stacked state x, with the round's edges grouped by
// receiver segment (the caller sorts them once per staged plan, stably, so
// each segment's edges keep the plan's order).  The caller then applies
// x[slots[s]] += delta[s] outside the kernel.
//
// Replaces the TPU kernel `sparse_segment_mix` of
// src/repro/kernels/sparse_gossip.py (the Pallas `_kernel`, launched by
// `pl.pallas_call` at line 64).  The TPU kernel keeps its (S, bd) output
// tile in VMEM and streams gathered (E, bd) copies xs = x[src], xd = x[dst]
// through it as a one-hot matmul on the MXU, because a TPU has no
// scatter-add.  What it keeps out of device memory is the output.  Here
// what has to stay out of L2 traffic is the input: a round touches only a
// few hundred distinct rows, and every edge reads two of them.
//
// Two variants, chosen by the wrapper from shapes alone
// (sparse_gossip.launch_geometry):
//
// * staged (the main path).  The caller compacts the round once per staged
//   plan: rows (U,) = the distinct ids of src and dst, and each edge's
//   local ids lsrc, ldst in [0, U).  A block owns one column tile of 32*VEC
//   columns and one group of segments, and copies x[rows, tile] into its
//   shared memory with cp.async (16, 8 or 4 bytes a copy, or 2 for bf16,
//   as x's rows and address allow) before any edge is walked; every edge
//   then reads its endpoints from there.  At the sampled-client main path
//   (U <= 256 rows, D = 784, E ~26k, 7 tiles x 15-16 groups) a round reads
//   its rows from L2 once per group, ~12 MB, instead of 2*E*D*4 ~ 162 MB.
//   With no more segments than the tile's warps, warp k takes segment k
//   alone; otherwise the segments are dealt by edge count: warp k takes
//   those whose first edge falls in the k-th of groups*warps equal slices
//   of the round's edges.  A warp walks its segments' edges in order, a
//   lane holding VEC columns: 32 edges at a time go from registers (loaded
//   a chunk ahead, as local ids) into a per-warp ring in shared memory,
//   kBatch edges at a time are read from it with all their row reads
//   issued before the FMAs, and the receiver's row is read again only when
//   an edge names another one (a gossip round's segment has one receiver).
// * gather (the design before this one): one block per (segment, column
//   chunk), a thread walking the segment's edges and reading both rows
//   straight from x.  It is launched only when U rows of the narrowest
//   tile do not fit in a block's shared memory.
//
// What bounds the staged variant: the work is small (3*E*D = 62 MFLOP, ~1
// us at the f32 peak), and the rows it reads are under 1 MB.  clock64
// stamps in a development copy split a block's time between what comes
// before its walk (the launch and the staging) and the walk, and found the
// walk bound by instruction issue, not by shared memory: a warp spends
// about 20 instructions an edge (the eight f32 subtractions and FMAs of
// VEC = 4, the rest the edge's broadcast read, its row address, the
// receiver check and the loop), four warps share a scheduler, and the
// block's longest segment sets its time.
//
// Both variants sum each segment in the plan's edge order with
// fmaf(w, xs - xd, acc), with no float atomics, so reruns are bit-equal and
// the two variants give the same bits.
//
// Plain C interface, built by nvcc and loaded with ctypes (kernels/build.py).

#include "hopper_common.cuh"

namespace {

constexpr int kGatherThreads = 128;
constexpr int kMaxWarps = 16;
constexpr int kBatch = 4;   // edges whose loads a warp issues together
constexpr int kMaxGridY = 65535;
constexpr int kMaxSmem = 232448;  // a block's most dynamic shared memory

// VEC consecutive elements moved as one aligned load/store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// ---- gather variant ---------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const T* __restrict__ x, const long long* __restrict__ src,
                  const long long* __restrict__ dst,
                  const float* __restrict__ w,
                  const long long* __restrict__ offsets,
                  float* __restrict__ delta, long long D) {
  const long long s = blockIdx.x;  // the receiver segment
  const long long c =
      ((long long)blockIdx.y * kGatherThreads + threadIdx.x) * VEC;
  if (c >= D) return;  // VEC divides D (checked by the host)
  const long long lo = offsets[s];
  const long long hi = offsets[s + 1];
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
#pragma unroll 4
  for (long long e = lo; e < hi; ++e) {
    const float we = w[e];
    const Pack<T, VEC> ps =
        *reinterpret_cast<const Pack<T, VEC>*>(x + src[e] * D + c);
    const Pack<T, VEC> pd =
        *reinterpret_cast<const Pack<T, VEC>*>(x + dst[e] * D + c);
#pragma unroll
    for (int v = 0; v < VEC; ++v)
      acc[v] = fmaf(we, to_f32(ps.v[v]) - to_f32(pd.v[v]), acc[v]);
  }
  Pack<float, VEC> out;
#pragma unroll
  for (int v = 0; v < VEC; ++v) out.v[v] = acc[v];
  *reinterpret_cast<Pack<float, VEC>*>(delta + s * D + c) = out;
}

template <typename T, int VEC>
cudaError_t launch_gather(const T* x, const long long* src,
                          const long long* dst, const float* w,
                          const long long* offsets, float* delta, int S,
                          long long D, cudaStream_t stream) {
  const long long chunks = (D / VEC + kGatherThreads - 1) / kGatherThreads;
  if (chunks > kMaxGridY) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)S, (unsigned)chunks);
  gather_kernel<T, VEC>
      <<<grid, kGatherThreads, 0, stream>>>(x, src, dst, w, offsets, delta, D);
  return cudaGetLastError();
}

// ---- staged variant ---------------------------------------------------------

// One edge as a warp reads it: the local ids of its two rows and its
// weight (16 bytes: one broadcast load).  Ids, not byte offsets: the
// product with the row stride is taken where the row is read, so no
// instruction waits on an edge's load before the edge is walked.
struct alignas(16) Edge {
  int s, d;
  float w;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

// x[rows[u], c0 : c0 + cols] for u < U into shared memory, row u at u *
// row_bytes, in copies of CB bytes (16, 8 or 4 by cp.async; 2, a bf16 at a
// time through registers, where x allows nothing wider).  A warp takes 32
// rows at a time: one load of their ids, then each lane copies pieces of
// them, cols * sizeof(T) / CB pieces a row.
template <typename T, int CB>
__device__ __forceinline__ void stage_rows(unsigned char* smem,
                                           const T* __restrict__ x,
                                           const long long* __restrict__ rows,
                                           int U, long long D, long long c0,
                                           int cols, int row_bytes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int per_row = cols * (int)sizeof(T) / CB;
  for (int u0 = warp * 32; u0 < U; u0 += warps * 32) {
    const int nr = min(32, U - u0);
    const long long mine = lane < nr ? rows[u0 + lane] : 0;
    const int n = nr * per_row;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int k = i / per_row;
      const long long r = __shfl_sync(0xffffffffu, mine, k & 31);
      if (i < n) {
        const int j = i - k * per_row;
        const unsigned char* from =
            reinterpret_cast<const unsigned char*>(x + r * D + c0) + j * CB;
        unsigned char* to = smem + (u0 + k) * row_bytes + j * CB;
        if constexpr (CB >= 4)
          cp_async<CB>(to, from);
        else
          *reinterpret_cast<T*>(to) = *reinterpret_cast<const T*>(from);
      }
    }
  }
}

// Grid (column tiles, segment groups), `warps` warps a block.  Shared
// memory: the staged tile (U rows of 32 * VEC values), a 32-edge ring per
// warp, and the warps' first segments (warps + 1 ints).
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxWarps * 32)
    staged_kernel(const T* __restrict__ x, const long long* __restrict__ rows,
                  int U, const int* __restrict__ lsrc,
                  const int* __restrict__ ldst, const float* __restrict__ w,
                  const long long* __restrict__ offsets,
                  float* __restrict__ delta, int S, long long D, int cb) {
  constexpr int kTile = 32 * VEC;
  constexpr int kRowBytes = kTile * (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  Edge* ring = reinterpret_cast<Edge*>(smem + U * kRowBytes);
  int* first_seg = reinterpret_cast<int*>(ring + warps * 32);
  const long long c0 = (long long)blockIdx.x * kTile;
  const int cols = (int)min((long long)kTile, D - c0);

  // 1. the tile of every row the round touches, in flight while the warps
  // find their segments
  if (cb == 16)
    stage_rows<T, 16>(smem, x, rows, U, D, c0, cols, kRowBytes);
  else if (cb == 8)
    stage_rows<T, 8>(smem, x, rows, U, D, c0, cols, kRowBytes);
  else if (cb == 4)
    stage_rows<T, 4>(smem, x, rows, U, D, c0, cols, kRowBytes);
  else if constexpr (sizeof(T) == 2)
    stage_rows<T, 2>(smem, x, rows, U, D, c0, cols, kRowBytes);
  cp_async_commit();

  // 2. the segments of this block's warps.  With no more segments than the
  // tile's nw warps, warp k takes segment k alone.  Otherwise segment s goes
  // to warp bucket(offsets[s]) = the slice of E / nw edges its first edge
  // falls in; first_seg[k] is the first segment of this block's warp k (k =
  // warps: one past its last), written by the one s with bucket(s - 1) < k
  // <= bucket(s), taking bucket(-1) = -1 and bucket(S) = nw.
  const long long k_lo = (long long)blockIdx.y * warps;
  const long long nw = (long long)gridDim.y * warps;
  if (S <= nw) {
    if (threadIdx.x <= warps)
      first_seg[threadIdx.x] = (int)min((long long)S, k_lo + threadIdx.x);
  } else {
    const long long off0 = offsets[0];
    const long long edges = offsets[S] - off0;
    auto bucket = [&](int s) {
      return s < 0 ? -1LL
             : s == S ? nw
             : edges == 0
                 ? 0LL
                 : min((offsets[s] - off0) * nw / edges, nw - 1);
    };
    for (int s = threadIdx.x; s <= S; s += blockDim.x) {
      const long long k1 = min(bucket(s), k_lo + warps);
      for (long long k = max(bucket(s - 1) + 1, k_lo); k <= k1; ++k)
        first_seg[k - k_lo] = s;
    }
  }
  __syncthreads();

  // edge indices fit in 32 bits (the wrapper checks E)
  const int sb = first_seg[warp], se = first_seg[warp + 1];
  int e = (int)offsets[sb];
  const int e_end = (int)offsets[se];
  auto edge_at = [&](int i) {
    Edge r = {0, 0, 0.f};
    if (i < e_end) {
      r.s = lsrc[i];
      r.d = ldst[i];
      r.w = w[i];
    }
    return r;
  };
  Edge next = edge_at(e + lane);  // the first chunk, ahead of the wait
  cp_async_wait<0>();
  __syncthreads();
  if (sb >= se) return;  // no block barrier follows

  // 3. walk the warp's segments in order; ring holds edges [base, base+32)
  Edge* mine = ring + warp * 32;
  const int lane_bytes = lane * VEC * (int)sizeof(T);
  auto row_at = [&](int u) {
    return *reinterpret_cast<const Pack<T, VEC>*>(smem + lane_bytes +
                                                 u * kRowBytes);
  };
  const long long c = c0 + lane * VEC;
  int base = e - 32;
  // the receiver's row (as f32), read again only when an edge names
  // another one: a gossip round's segment has one receiver, so this halves
  // the shared-memory reads
  int d_row = -1;
  float xd[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) xd[v] = 0.f;
  auto take_d = [&](const Pack<T, VEC>& p, int u) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) xd[v] = to_f32(p.v[v]);
    d_row = u;
  };
  for (int s = sb; s < se; ++s) {
    const int hi = (int)offsets[s + 1];
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    while (e < hi) {
      if (e == base + 32) {  // the next chunk into the ring
        base = e;
        __syncwarp();
        mine[lane] = next;
        __syncwarp();
        next = edge_at(base + 32 + lane);
      }
      const int end = min(hi, base + 32) - base;
      int k = e - base;
      // kBatch edges at a time: every load issued before the first FMA,
      // the FMAs then in edge order
      for (; k + kBatch <= end; k += kBatch) {
        Edge r[kBatch];
        Pack<T, VEC> ps[kBatch];
        bool same = true;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          r[j] = mine[k + j];
          same &= r[j].d == d_row;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) ps[j] = row_at(r[j].s);
        if (same) {  // uniform across the warp
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[v] = fmaf(r[j].w, to_f32(ps[j].v[v]) - xd[v], acc[v]);
        } else {
          Pack<T, VEC> pd[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) pd[j] = row_at(r[j].d);
#pragma unroll
          for (int j = 0; j < kBatch; ++j)
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[v] = fmaf(r[j].w, to_f32(ps[j].v[v]) - to_f32(pd[j].v[v]),
                            acc[v]);
          take_d(pd[kBatch - 1], r[kBatch - 1].d);
        }
      }
      for (; k < end; ++k) {
        const Edge r = mine[k];
        const Pack<T, VEC> ps = row_at(r.s);
        if (r.d != d_row) take_d(row_at(r.d), r.d);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = fmaf(r.w, to_f32(ps.v[v]) - xd[v], acc[v]);
      }
      e = base + end;
    }
    float* out = delta + (long long)s * D;
    if (D % VEC == 0 && c + VEC <= D) {
      Pack<float, VEC> p;
#pragma unroll
      for (int v = 0; v < VEC; ++v) p.v[v] = acc[v];
      *reinterpret_cast<Pack<float, VEC>*>(out + c) = p;
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        if (c + v < D) out[c + v] = acc[v];
    }
  }
}

long long staged_smem(int U, int vec, int elem, int warps) {
  return (long long)U * 32 * vec * elem + warps * 32 * (int)sizeof(Edge) +
         (warps + 1) * (int)sizeof(int);
}

template <typename T, int VEC>
cudaError_t launch_staged(const T* x, const long long* rows, int U,
                          const int* lsrc, const int* ldst, const float* w,
                          const long long* offsets, float* delta, int S,
                          long long D, int groups, int warps, int cb,
                          cudaStream_t stream) {
  const long long smem = staged_smem(U, VEC, sizeof(T), warps);
  const long long tiles = (D + 32 * VEC - 1) / (32 * VEC);
  if (smem > kMaxSmem || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<staged_kernel<T, VEC>>(kMaxSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  staged_kernel<T, VEC><<<grid, warps * 32, (size_t)smem, stream>>>(
      x, rows, U, lsrc, ldst, w, offsets, delta, S, D, cb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_staged(const void* x, const long long* rows, int U,
                            const int* lsrc, const int* ldst, const float* w,
                            const long long* offsets, float* delta, int S,
                            long long D, int vec, int groups, int warps,
                            int cb, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (cb != 16 && cb != 8 && cb != 4 && !(cb == 2 && sizeof(T) == 2))
    return cudaErrorInvalidValue;
  if (vec == 4)
    return launch_staged<T, 4>(xt, rows, U, lsrc, ldst, w, offsets, delta, S,
                               D, groups, warps, cb, s);
  if (vec == 2)
    return launch_staged<T, 2>(xt, rows, U, lsrc, ldst, w, offsets, delta, S,
                               D, groups, warps, cb, s);
  if (vec == 1)
    return launch_staged<T, 1>(xt, rows, U, lsrc, ldst, w, offsets, delta, S,
                               D, groups, warps, cb, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_gather(const void* x, const long long* src,
                            const long long* dst, const float* w,
                            const long long* offsets, float* delta, int S,
                            long long D, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (vec == 4) {
    if (D % 4 != 0) return cudaErrorInvalidValue;
    return launch_gather<T, 4>(xt, src, dst, w, offsets, delta, S, D, s);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return launch_gather<T, 1>(xt, src, dst, w, offsets, delta, S, D, s);
}

}  // namespace

// The staged variant.  x: (n, D) contiguous, f32 (dtype 0) or bf16 (dtype
// 1); rows: (U,) int64 distinct node ids; lsrc, ldst: the round's edges
// grouped by segment as int32 ids into rows; w: f32; offsets: (S + 1,)
// int64, segment s owning edges [offsets[s], offsets[s+1]); delta: (S, D)
// f32, every entry written.  vec 1, 2 or 4 (a tile of 32 * vec columns),
// groups of segments on the grid's y axis, warps a block, cb the bytes of
// one staging copy (it divides D * sizeof(x) and x's address).  Indices
// are trusted: the wrapper documents them.  Launches on `stream` and
// returns the launch's cudaError_t (0 = queued).
extern "C" int sparse_segment_mix_staged_launch(
    const void* x, const void* rows, int U, const void* lsrc,
    const void* ldst, const void* w, const void* offsets, void* delta, int S,
    long long D, int dtype, int vec, int groups, int warps, int cb,
    void* stream) {
  if (S < 1 || D < 1 || U < 0 || groups < 1 || groups > kMaxGridY ||
      warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* rp = static_cast<const long long*>(rows);
  const int* ls = static_cast<const int*>(lsrc);
  const int* ld = static_cast<const int*>(ldst);
  const float* wp = static_cast<const float*>(w);
  const long long* op = static_cast<const long long*>(offsets);
  float* out = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch_staged<float>(x, rp, U, ls, ld, wp, op, out, S, D,
                                       vec, groups, warps, cb, s);
  if (dtype == 1)
    return (int)dispatch_staged<__nv_bfloat16>(x, rp, U, ls, ld, wp, op, out,
                                               S, D, vec, groups, warps, cb,
                                               s);
  return (int)cudaErrorInvalidValue;
}

// The gather variant.  x as above; src, dst, w: the round's edges grouped
// by segment, int64, int64, f32; offsets and delta as above; vec 4 (D % 4
// == 0 and x 16-byte aligned) or 1.
extern "C" int sparse_segment_mix_gather_launch(const void* x,
                                                const void* src,
                                                const void* dst,
                                                const void* w,
                                                const void* offsets,
                                                void* delta, int S,
                                                long long D, int dtype,
                                                int vec, void* stream) {
  if (S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* sp = static_cast<const long long*>(src);
  const long long* dp = static_cast<const long long*>(dst);
  const float* wp = static_cast<const float*>(w);
  const long long* op = static_cast<const long long*>(offsets);
  float* out = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch_gather<float>(x, sp, dp, wp, op, out, S, D, vec, s);
  if (dtype == 1)
    return (int)dispatch_gather<__nv_bfloat16>(x, sp, dp, wp, op, out, S, D,
                                               vec, s);
  return (int)cudaErrorInvalidValue;
}

// A variant's compiled kernel (0 staged, 1 gather) for (dtype, vec):
// registers and local (spilled) bytes per thread, static shared bytes, the
// dynamic shared bytes of a launch staging U rows (0 for gather) and
// threads per block, into out[0..4].  Returns 0, or a cudaError_t.
extern "C" int sparse_segment_mix_resources(int variant, int dtype, int vec,
                                            int U, int* out) {
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
#define SPARSE_CASE(T, V)                                                  \
  if (vec == V) {                                                          \
    if (variant == 0) {                                                    \
      out[4] = kMaxWarps * 32;                                             \
      return (int)kernel_resources<staged_kernel<T, V>>(                   \
          (int)staged_smem(U, V, sizeof(T), kMaxWarps), out);              \
    }                                                                      \
    out[4] = kGatherThreads;                                               \
    if constexpr (V != 2)                                                  \
      return (int)kernel_resources<gather_kernel<T, V>>(0, out);           \
  }
  if (dtype == 0) {
    SPARSE_CASE(float, 1) SPARSE_CASE(float, 2) SPARSE_CASE(float, 4)
  } else if (dtype == 1) {
    SPARSE_CASE(__nv_bfloat16, 1) SPARSE_CASE(__nv_bfloat16, 2)
    SPARSE_CASE(__nv_bfloat16, 4)
  }
#undef SPARSE_CASE
  return (int)cudaErrorInvalidValue;
}

// The message of a cudaError_t, for the wrapper's exception.
extern "C" const char* sparse_segment_mix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
