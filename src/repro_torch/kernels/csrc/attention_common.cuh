// Device helpers shared by flash_attention.cu and decode_attention.cu:
// conversions between the input dtype (f32 or bf16) and f32, and the
// vectorised load of K / V / Q tiles into shared memory as f32.
//
// Included by each source (kernels/build.py rebuilds a source's library when
// a header it includes changes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// 16 bytes of T as f32 into shared memory at d (4 floats for f32, 8 for
// bf16, whose value is the top half of an f32).
__device__ __forceinline__ void store_f32(float, const uint4& u, float* d) {
  *reinterpret_cast<float4*>(d) =
      make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                  __uint_as_float(u.z), __uint_as_float(u.w));
}
__device__ __forceinline__ void store_f32(__nv_bfloat16, const uint4& u,
                                          float* d) {
  *reinterpret_cast<float4*>(d) = make_float4(
      __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  *reinterpret_cast<float4*>(d + 4) = make_float4(
      __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
      __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}

// Rows r0 .. r0 + R - 1 of `a` (and of `b` when TWO), HD values each, row
// stride `stride` values, into shared memory as f32 with row strides `lda`
// (`ldb`) floats; rows at or past n_rows read as zeros.  Each of the
// block's NT threads moves 16-byte vectors and issues up to CHUNK loads of
// each source before it stores any, so the loads do not wait on one
// another.  The sources must be 16-byte aligned (the wrappers see to it);
// HD * sizeof(T) is a multiple of 16 for every HD the kernels take.
template <int NT, typename T, int HD, int R, int CHUNK, bool TWO>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           long long stride, int r0,
                                           int n_rows, float* sa, int lda,
                                           float* sb, int ldb) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  constexpr int N = R * PER_ROW / NT;  // vectors per thread and source
  constexpr int CH = N < CHUNK ? N : CHUNK;
  static_assert(N * NT == R * PER_ROW && N % CH == 0,
                "a tile splits evenly over the threads");
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += CH) {
    uint4 ra[CH], rb[CH];
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int i = threadIdx.x + (n0 + n) * NT;
      const int r = i / PER_ROW, e = (i % PER_ROW) * VEC;
      const long long off = (long long)(r0 + r) * stride + e;
      const bool in = r0 + r < n_rows;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      ra[n] = in ? *reinterpret_cast<const uint4*>(a + off) : zero;
      if (TWO) rb[n] = in ? *reinterpret_cast<const uint4*>(b + off) : zero;
    }
#pragma unroll
    for (int n = 0; n < CH; ++n) {
      const int i = threadIdx.x + (n0 + n) * NT;
      const int r = i / PER_ROW, e = (i % PER_ROW) * VEC;
      store_f32(T(), ra[n], sa + r * lda + e);
      if (TWO) store_f32(T(), rb[n], sb + r * ldb + e);
    }
  }
}

// p as the PV product sees it: rounded to the value dtype.
template <typename T>
__device__ __forceinline__ float round_to(float p) {
  return to_f32(from_f32<T>(p));
}

}  // namespace
