// Device-memory bandwidth probes for Hopper (sm_90a): a flat copy of any
// type, and a 1:ratio expand of float32 rows with a float32, bfloat16,
// float16 or int8 store.
//
// Replaces the TPU kernels of multirate_tpu/utils/metrics.py:
// stream_copy_gbps (a balanced HBM copy whose (R, 1024) tiles are stored
// relabelled as (8R, 128), the same flat bytes) and stream_expand_gbps
// ((R, 128) float32 rows written as (R, ratio*128), each row repeated ratio
// times, narrowed to bf16 or to int8 as clip(32*x, -127, 127)). The tile
// relabelling and the 128-lane narrow stores are TPU layout workarounds and
// are not carried over; what is computed is:
//
//   copy:    dst[i] = src[i] for every byte i < nbytes
//   expand:  y[r, k*W + w] = cast(x[r, w]) for k < ratio, w < W
//            cast: float32 as is; bfloat16 and float16 round to nearest
//            even; int8 = (int8)trunc(clamp(32*x, -127, 127)), truncated
//            toward zero as XLA's convert and numpy's astype do.
//
// Bound: bytes, by construction. A copy of n bytes moves 2n through device
// memory (256 MB for the 32 M float32 default, 76 us at 3.35 TB/s); an
// expand of n float32 inputs moves (4 + ratio*sizeof(out))*n (160 MB at
// 1:4 with float32 stores for 8 M inputs). Neither does arithmetic worth
// counting, so the kernel's only job is to keep enough 16-byte accesses in
// flight.
//
// Design (correct and simple first): grid-stride loops of 256 threads.
// - copy: each thread moves 16-byte words to a destination that the wrapper
//   allocates (16-byte aligned); the source may sit at any byte offset (a
//   view), so it is read in the widest word its address allows (16, 8, 4,
//   2 or 1 bytes) and the pieces assembled into one 16-byte store. The last
//   nbytes % 16 bytes are copied one per thread (the masked tail).
// - expand: each thread reads 4 consecutive floats as one 16-byte load and
//   stores them, cast, ratio times: 16-byte stores for float32, 8 for the
//   16-bit types, 4 for int8 (W % 4 == 0 keeps every store aligned).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 on each SM
constexpr int kErrBadArg = -1;

int64_t blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const unsigned char* __restrict__ src,
            unsigned char* __restrict__ dst, int64_t nbytes) {
  constexpr int kWords = 16 / sizeof(Word);
  const int64_t n16 = nbytes / 16;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = t0; i < n16; i += stride) {
    union {
      uint4 v;
      Word w[kWords];
    } u;
    const Word* s = reinterpret_cast<const Word*>(src + 16 * i);
#pragma unroll
    for (int k = 0; k < kWords; ++k) u.w[k] = s[k];
    reinterpret_cast<uint4*>(dst)[i] = u.v;
  }
  const int64_t tail = nbytes - 16 * n16;
  if (t0 < tail) dst[16 * n16 + t0] = src[16 * n16 + t0];
}

template <typename Word>
int launch_copy(const void* src, void* dst, int64_t nbytes, void* stream) {
  copy_kernel<Word><<<(unsigned)blocks_for(nbytes / 16), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const unsigned char*)src, (unsigned char*)dst, nbytes);
  return cudaGetLastError();
}

// Four float32 values cast to Out, packed into one store.
template <typename Out> struct Pack;
template <> struct Pack<float> {
  using T = float4;
  __device__ static T make(float4 v) { return v; }
};
template <> struct Pack<__nv_bfloat16> {
  using T = uint2;
  __device__ static T make(float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    return make_uint2(*reinterpret_cast<unsigned*>(&a),
                      *reinterpret_cast<unsigned*>(&b));
  }
};
template <> struct Pack<__half> {
  using T = uint2;
  __device__ static T make(float4 v) {
    __half2 a = __floats2half2_rn(v.x, v.y);
    __half2 b = __floats2half2_rn(v.z, v.w);
    return make_uint2(*reinterpret_cast<unsigned*>(&a),
                      *reinterpret_cast<unsigned*>(&b));
  }
};
template <> struct Pack<int8_t> {
  using T = char4;
  __device__ static signed char q(float v) {
    return (signed char)__float2int_rz(fminf(fmaxf(32.0f * v, -127.0f),
                                             127.0f));
  }
  __device__ static T make(float4 v) {
    return make_char4(q(v.x), q(v.y), q(v.z), q(v.w));
  }
};

template <typename Out>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const float4* __restrict__ x, Out* __restrict__ y,
              int64_t rows, int width, int ratio) {
  using P = Pack<Out>;
  const int w4 = width / 4;
  const int64_t n4 = rows * w4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const int64_t r = i / w4;
    const int c = (int)(i - r * w4);
    const typename P::T v = P::make(x[i]);
    Out* yr = y + r * ratio * (int64_t)width + 4 * c;
    for (int k = 0; k < ratio; ++k)
      *reinterpret_cast<typename P::T*>(yr + (int64_t)k * width) = v;
  }
}

template <typename Out>
int launch_expand(const void* x, void* y, int64_t rows, int width, int ratio,
                  void* stream) {
  if (rows < 0 || width <= 0 || width % 4 != 0 || ratio <= 0)
    return kErrBadArg;
  if (rows == 0) return cudaSuccess;
  expand_kernel<Out><<<(unsigned)blocks_for(rows * (width / 4)), kThreads, 0,
                       (cudaStream_t)stream>>>((const float4*)x, (Out*)y,
                                               rows, width, ratio);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dst[0, nbytes) = src[0, nbytes). dst is 16-byte aligned; src may lie at
// any byte offset. Returns a cudaError_t code.
int mr_probe_copy(const void* src, void* dst, int64_t nbytes, void* stream) {
  if (nbytes < 0 || ((uintptr_t)dst & 15)) return kErrBadArg;
  if (nbytes == 0) return cudaSuccess;
  const uintptr_t a = (uintptr_t)src;
  if (!(a & 15)) return launch_copy<uint4>(src, dst, nbytes, stream);
  if (!(a & 7)) return launch_copy<uint2>(src, dst, nbytes, stream);
  if (!(a & 3)) return launch_copy<uint32_t>(src, dst, nbytes, stream);
  if (!(a & 1)) return launch_copy<uint16_t>(src, dst, nbytes, stream);
  return launch_copy<uint8_t>(src, dst, nbytes, stream);
}

// y (rows, ratio*width) from float32 x (rows, width): y[r, k*width + w] =
// cast(x[r, w]). x and y contiguous and 16-byte aligned, width % 4 == 0.
// Returns a cudaError_t code, or kErrBadArg. One entry per store type:
// mr_probe_expand_<name>.
#define MR_PROBE_EXPAND(name, Out)                                          \
  int mr_probe_expand_##name(const void* x, void* y, int64_t rows,         \
                             int width, int ratio, void* stream) {         \
    return launch_expand<Out>(x, y, rows, width, ratio, stream);           \
  }

MR_PROBE_EXPAND(f32, float)
MR_PROBE_EXPAND(bf16, __nv_bfloat16)
MR_PROBE_EXPAND(f16, __half)
MR_PROBE_EXPAND(s8, int8_t)

#undef MR_PROBE_EXPAND

const char* mr_error_string(int code) {
  if (code == kErrBadArg) return "argument the probe kernel does not take";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
