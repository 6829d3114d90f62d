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
// Design.
// - copy: one block of 256 threads for each 8 KB chunk, each thread moving
//   two 16-byte words, coalesced, both loads issued before the stores; the
//   grid covers the whole copy (15,625 blocks for 32 M float32), so the
//   block scheduler keeps every SM full to the end. Tried on the H100 and
//   slower (PERF.md): a grid-stride loop with one load in flight a thread,
//   a persistent grid of 132 x 8 blocks with 8 loads in flight a thread,
//   with or without streaming cache hints, and a TMA bulk copy through a
//   ring of shared-memory stages (cp.async.bulk with an mbarrier). The
//   destination is allocated by the wrapper (16-byte aligned); the source
//   may sit at any byte offset (a view), so it is read in the widest word
//   its address allows (16, 8, 4, 2 or 1 bytes) and the pieces assembled
//   into one 16-byte store. A partial last chunk is masked and the last
//   nbytes % 16 bytes are copied one per thread.
// - expand: the copy's shape, one block of 256 threads for each chunk of
//   output words, both of a thread's words loaded before any store, and
//   every store 16 bytes wide. A 16-byte word of the store type holds V
//   outputs (4 float32, 8 bfloat16 or float16, 16 int8), so a thread packs
//   V floats, read as V/4 16-byte loads, into one word and stores it ratio
//   times. When W % V == 0 (the ceilings' rows of 128) each word is V
//   consecutive floats of one row, stored at the same column of each of
//   its ratio copies. Otherwise a copy's start is not 16-byte aligned in
//   y, so each thread takes one 16-byte word of y itself and gathers its
//   V/4 groups of 4 (W % 4 == 0 keeps a group inside one copy of one row);
//   only the last word of y, when y's size is not a multiple of 16 bytes,
//   is stored 4 outputs at a time. Indices are 64-bit, as in the copy.
//   (The first design, a grid-stride loop of 2,112 blocks with one load in
//   flight a thread and 8- or 4-byte narrow stores, reached 67-76% of 3.35
//   TB/s; PERF.md.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyUnroll = 2;  // 16-byte words a thread
constexpr int kErrBadArg = -1;

// 16 bytes of src at word i, read in words of the source's alignment.
template <typename Word>
__device__ __forceinline__ uint4 load16(const unsigned char* src, int64_t i) {
  constexpr int kWords = 16 / sizeof(Word);
  union {
    uint4 v;
    Word w[kWords];
  } u;
  const Word* s = reinterpret_cast<const Word*>(src + 16 * i);
#pragma unroll
  for (int k = 0; k < kWords; ++k) u.w[k] = s[k];
  return u.v;
}

template <typename Word>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const unsigned char* __restrict__ src,
            unsigned char* __restrict__ dst, int64_t nbytes) {
  const int64_t n16 = nbytes / 16;
  const int64_t i0 = (int64_t)blockIdx.x * kCopyUnroll * blockDim.x +
                     threadIdx.x;
  uint4* d = reinterpret_cast<uint4*>(dst);
  uint4 v[kCopyUnroll];
#pragma unroll
  for (int k = 0; k < kCopyUnroll; ++k) {
    const int64_t i = i0 + (int64_t)k * blockDim.x;
    if (i < n16) v[k] = load16<Word>(src, i);
  }
#pragma unroll
  for (int k = 0; k < kCopyUnroll; ++k) {
    const int64_t i = i0 + (int64_t)k * blockDim.x;
    if (i < n16) d[i] = v[k];
  }
  const int64_t tail = nbytes - 16 * n16;
  const int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 < tail) dst[16 * n16 + t0] = src[16 * n16 + t0];
}

template <typename Word>
int launch_copy(const void* src, void* dst, int64_t nbytes, void* stream) {
  const int64_t per_block = (int64_t)kCopyUnroll * kThreads;
  const int64_t blocks = (nbytes / 16 + per_block - 1) / per_block;
  copy_kernel<Word><<<(unsigned)(blocks < 1 ? 1 : blocks), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const unsigned char*)src, (unsigned char*)dst, nbytes);
  return cudaGetLastError();
}

// Four float32 values cast to Out, packed into one store (4*sizeof(Out)
// bytes).
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

// G = 16 / (4 * sizeof(Out)) groups of 4 floats cast and packed into one
// 16-byte word.
template <typename Out>
__device__ __forceinline__ uint4 pack16(const float4* v) {
  constexpr int G = 4 / sizeof(Out);
  union {
    uint4 w;
    typename Pack<Out>::T p[G];
  } u;
#pragma unroll
  for (int g = 0; g < G; ++g) u.p[g] = Pack<Out>::make(v[g]);
  return u.w;
}

constexpr int kExpandUnroll = 2;  // 16-byte output words a thread

// W % V == 0: word i of x's rows, in Out, is row r = i / wpr, column word
// c = i % wpr (wpr = W / V words a row); it is stored at column word c of
// each of row r's ratio copies.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
expand_rows(const float4* __restrict__ x, uint4* __restrict__ y,
            int64_t n_words, int64_t wpr, int ratio) {
  constexpr int G = 4 / sizeof(Out);
  const int64_t i0 =
      (int64_t)blockIdx.x * (kExpandUnroll * kThreads) + threadIdx.x;
  float4 v[kExpandUnroll][G];
#pragma unroll
  for (int u = 0; u < kExpandUnroll; ++u) {
    const int64_t i = i0 + (int64_t)u * kThreads;
    if (i < n_words) {
#pragma unroll
      for (int g = 0; g < G; ++g) v[u][g] = x[i * G + g];
    }
  }
#pragma unroll
  for (int u = 0; u < kExpandUnroll; ++u) {
    const int64_t i = i0 + (int64_t)u * kThreads;
    if (i < n_words) {
      const uint4 w = pack16<Out>(v[u]);
      const int64_t r = i / wpr;
      uint4* yr = y + r * ratio * wpr + (i - r * wpr);
      for (int k = 0; k < ratio; ++k) yr[k * wpr] = w;
    }
  }
}

// Any W % 4 == 0: thread i stores word i of y, gathering each group of 4
// outputs from its row and column of x; a last partial word goes out 4
// outputs at a time.
template <typename Out>
__global__ void __launch_bounds__(kThreads)
expand_words(const float4* __restrict__ x, Out* __restrict__ y,
             int64_t n_out, int64_t width, int ratio) {
  constexpr int G = 4 / sizeof(Out);
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t e0 = i * (4 * G);  // first output of the word
  if (e0 >= n_out) return;
  float4 v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t e = e0 + 4 * g;
    if (e < n_out) {
      const int64_t seg = e / width;  // copy seg % ratio of row seg / ratio
      v[g] = x[((seg / ratio) * width + (e - seg * width)) / 4];
    }
  }
  if (e0 + 4 * G <= n_out) {
    *reinterpret_cast<uint4*>(y + e0) = pack16<Out>(v);
  } else {
    for (int g = 0; e0 + 4 * g < n_out; ++g)
      *reinterpret_cast<typename Pack<Out>::T*>(y + e0 + 4 * g) =
          Pack<Out>::make(v[g]);
  }
}

template <typename Out>
int launch_expand(const void* x, void* y, int64_t rows, int width, int ratio,
                  void* stream) {
  if (rows < 0 || width <= 0 || width % 4 != 0 || ratio <= 0 ||
      ((uintptr_t)x & 15) || ((uintptr_t)y & 15))
    return kErrBadArg;
  if (rows == 0) return cudaSuccess;
  constexpr int V = 16 / sizeof(Out);
  const cudaStream_t s = (cudaStream_t)stream;
  if (width % V == 0) {
    const int64_t n_words = rows * (width / V);
    const int64_t per_block = (int64_t)kExpandUnroll * kThreads;
    expand_rows<Out><<<(unsigned)((n_words + per_block - 1) / per_block),
                       kThreads, 0, s>>>((const float4*)x, (uint4*)y,
                                         n_words, width / V, ratio);
  } else {
    const int64_t n_out = rows * ratio * (int64_t)width;
    const int64_t words = (n_out + V - 1) / V;
    expand_words<Out><<<(unsigned)((words + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>((const float4*)x, (Out*)y, n_out,
                                          width, ratio);
  }
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
