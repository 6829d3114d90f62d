// Multiply-accumulate, widening loads and narrowing stores over the sample
// and tap types of the port's kernels (polyphase.cu, resample.cu).
//
// Complex values stay interleaved, as torch stores them: a complex64 sample
// is a float2 {re, im} and a complex128 one a double2, read over the
// tensor's data without a split into planes. A real tap against a complex
// sample costs 2 real multiply-adds, a complex tap 4; each real one is an
// FMA in the sample's precision.
//
// A real sample against a complex tap (float against float2, double
// against double2) costs 2 FMAs, (r + 0i)(a + bi)'s nonzero products in
// the complex tap's order: the bits of the complex-sample entry on the
// sample cast to complex, up to the sign of a zero.
//
// Narrow reads: int16, uint8, int8, __half and __nv_bfloat16 samples are
// read as stored and widened to float (``widen``) before the float
// multiply-adds; each of these types converts to float exactly, so a
// narrow read gives the float32 kernel's bits on the widened values.
//
// Integer words: uint32_t and uint64_t multiply-adds wrap modulo 2^32 or
// 2^64 (unsigned arithmetic: signed overflow is undefined in C++), which
// are the low bits of the exact two's-complement sum; the entries read
// int32/int64 tensors (and uint32/uint64 ones) as these words.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mr {

// A stored value as the type it is staged and summed in: the same type, or
// float for a narrow read (exact).
template <typename S, typename T>
__device__ __forceinline__ S widen(T v) {
  return static_cast<S>(v);
}
template <>
__device__ __forceinline__ float widen<float, __half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An accumulator stored as the output type: the same type, or rounded to
// nearest even into float16 or bfloat16.
template <typename O, typename T>
__device__ __forceinline__ O narrow(T v) {
  return static_cast<O>(v);
}
template <>
__device__ __forceinline__ __half narrow<__half, float>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float mac(float acc, float w, float b) {
  return fmaf(w, b, acc);
}
__device__ __forceinline__ double mac(double acc, double w, double b) {
  return fma(w, b, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int8_t w, int8_t b) {
  return acc + (int32_t)w * (int32_t)b;
}
__device__ __forceinline__ float2 mac(float2 acc, float2 w, float b) {
  return make_float2(fmaf(w.x, b, acc.x), fmaf(w.y, b, acc.y));
}
__device__ __forceinline__ double2 mac(double2 acc, double2 w, double b) {
  return make_double2(fma(w.x, b, acc.x), fma(w.y, b, acc.y));
}
__device__ __forceinline__ float2 mac(float2 acc, float w, float2 b) {
  return make_float2(fmaf(w, b.x, acc.x), fmaf(w, b.y, acc.y));
}
__device__ __forceinline__ double2 mac(double2 acc, double w, double2 b) {
  return make_double2(fma(w, b.x, acc.x), fma(w, b.y, acc.y));
}
__device__ __forceinline__ uint32_t mac(uint32_t acc, uint32_t w,
                                        uint32_t b) {
  return acc + w * b;
}
__device__ __forceinline__ uint64_t mac(uint64_t acc, uint64_t w,
                                        uint64_t b) {
  return acc + w * b;
}
__device__ __forceinline__ float2 mac(float2 acc, float2 w, float2 b) {
  return make_float2(fmaf(-w.y, b.y, fmaf(w.x, b.x, acc.x)),
                     fmaf(w.y, b.x, fmaf(w.x, b.y, acc.y)));
}
__device__ __forceinline__ double2 mac(double2 acc, double2 w, double2 b) {
  return make_double2(fma(-w.y, b.y, fma(w.x, b.x, acc.x)),
                      fma(w.y, b.x, fma(w.x, b.y, acc.y)));
}

// The zero of an accumulator or staged sample type.
template <typename T>
__device__ __forceinline__ T zero() {
  return T{};
}

// The real type of a sample or tap type (a tap polynomial's argument).
template <typename T> struct Real { using type = T; };
template <> struct Real<float2> { using type = float; };
template <> struct Real<double2> { using type = double; };

}  // namespace mr
