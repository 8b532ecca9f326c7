// Device and host helpers shared by the Hopper kernels (flash_attention.cu,
// decode_attention.cu, sparse_segment_mix.cu): conversions between the
// input dtype (f32 or bf16) and f32, the vectorised load of f32 tiles into
// shared memory (the f32 flash kernel), the asynchronous copies Hopper
// offers (cp.async with commit / wait groups, mbarriers, and TMA tile loads
// that complete on an mbarrier), the dynamic shared-memory attribute and a
// kernel's compiled resources.
//
// Included by each source (kernels/build.py rebuilds a source's library when
// a header it includes changes).

#pragma once

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

// ---- host ----------------------------------------------------------------

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
