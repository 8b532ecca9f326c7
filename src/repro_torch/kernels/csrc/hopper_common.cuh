// Device and host helpers shared by the Hopper kernels (flash_attention.cu,
// decode_attention.cu, sparse_segment_mix.cu, linear_recurrence.cu):
// conversions between the input dtype (f32 or bf16) and f32, the vectorised
// load of f32 tiles into shared memory (the f32 flash kernel), the
// asynchronous copies Hopper offers (cp.async with commit / wait groups or
// completing on an mbarrier, mbarriers, and TMA tile loads that complete on
// an mbarrier), the host lookup of cuTensorMapEncodeTiled, the dynamic
// shared-memory attribute and a kernel's compiled resources.
//
// Included by each source (kernels/build.py rebuilds a source's library when
// a header it includes changes).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// p as the PV product sees it: rounded to the value dtype.
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  return to_f32(from_f32<T>(p));
}

// Two f32 as one bf16x2 register, lo in the low half (round to nearest).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 16 bytes of T as f32: 4 values for f32, 8 for bf16 (a bf16 is the top
// half of an f32).
__device__ __forceinline__ void unpack_f32(float, const uint4& u, float* d) {
  d[0] = __uint_as_float(u.x);
  d[1] = __uint_as_float(u.y);
  d[2] = __uint_as_float(u.z);
  d[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack_f32(__nv_bfloat16, const uint4& u,
                                           float* d) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[2 * i] = __uint_as_float(w[i] << 16);
    d[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Rows r0 .. r0 + R - 1 of `a` (and of `b` when TWO), HD f32 values each,
// row stride `stride` values, into shared memory with row strides `lda`
// (`ldb`) floats; rows at or past n_rows read as zeros.  Each of the
// block's NT threads moves 16-byte vectors and issues up to CHUNK loads of
// each source before it stores any, so the loads do not wait on one
// another.  The sources must be 16-byte aligned (the wrappers see to it).
template <int NT, int HD, int R, int CHUNK, bool TWO>
__device__ __forceinline__ void load_tiles(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           long long stride, int r0,
                                           int n_rows, float* sa, int lda,
                                           float* sb, int ldb) {
  constexpr int PER_ROW = HD / 4;
  constexpr int N = R * PER_ROW / NT;  // vectors per thread and source
  constexpr int CH = N < CHUNK ? N : CHUNK;
  static_assert(N * NT == R * PER_ROW && N % CH == 0,
                "a tile splits evenly over the threads");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += CH) {
    float4 ra[CH], rb[CH];
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int i = threadIdx.x + (n0 + n) * NT;
      const int r = i / PER_ROW, e = (i % PER_ROW) * 4;
      const long long off = (long long)(r0 + r) * stride + e;
      const bool in = r0 + r < n_rows;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      ra[n] = in ? *reinterpret_cast<const float4*>(a + off) : zero;
      if (TWO) rb[n] = in ? *reinterpret_cast<const float4*>(b + off) : zero;
    }
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int i = threadIdx.x + (n0 + n) * NT;
      const int r = i / PER_ROW, e = (i % PER_ROW) * 4;
      *reinterpret_cast<float4*>(sa + r * lda + e) = ra[n];
      if (TWO) *reinterpret_cast<float4*>(sb + r * ldb + e) = rb[n];
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: 16-byte copies global -> shared, in commit groups --------

// 16 bytes to dst: the first `bytes` (0 .. 16) from src, the rest zeros.
// dst and src 16-byte aligned; src is not read where bytes is 0.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// 4 bytes to dst: the first `bytes` (0 or 4) from src, the rest zeros.  dst
// and src 4-byte aligned; src is not read where bytes is 0.
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; call after the inits, before a block barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Arrive on bar once every cp.async this thread issued before has landed;
// the arrival is one of the count the barrier was initialised with.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Block until the phase of parity `parity` has completed.  A wait that
// polls 2^26 times (a second or more; a tile takes microseconds) traps, so
// a fault that loses an arrival ends the kernel with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// One box of a 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst; completes `bytes` on bar (see arrive_expect_tx).
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory at dst; completes `bytes` on bar (see arrive_expect_tx).
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The box of a 3-D tensor map at (c0, c1, c2) from shared memory at src
// (elements past the tensor's bounds are not written), in this thread's
// current bulk group.  The threads that wrote src make their writes visible
// to the copy with proxy_fence_async() before they synchronise with this
// thread.
__device__ __forceinline__ void tma_store_3d(const void* tmap,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(tmap)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups are still reading
// their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Order this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA) accesses to them.
__device__ __forceinline__ void proxy_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- host ----------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda);
// null where the driver does not have it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Let `Kernel` take `bytes` of dynamic shared memory: the attribute is set
// once per device (of the first 32) and kernel, not on every launch.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static unsigned done = 0u;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

// Registers, local (spilled) bytes per thread and static shared bytes per
// block of `Kernel`, and `dynamic` shared bytes, into out[0..3].
template <auto Kernel>
cudaError_t kernel_resources(int dynamic, int* out) {
  cudaFuncAttributes a = {};
  const cudaError_t err = cudaFuncGetAttributes(&a, Kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = dynamic;
  return err;
}

}  // namespace
