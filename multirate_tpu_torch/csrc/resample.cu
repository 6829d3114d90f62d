// Arbitrary-rate and Farrow resampler for Hopper (sm_90a): float32 (channel-
// and time-major), and channel-major float64, complex64 and complex128
// signals against real or complex tables.
//
// Replaces the TPU kernels of multirate_tpu/ops/pallas/ that resample at a
// real rate:
//   gridsel.py  gridsel_resample_fused, gridsel_farrow_horner_fused
//               (one channel) and gridsel_resample_batch,
//               gridsel_farrow_horner_batch (channels sharing one state);
//   select4.py  chan_resample_v4, chan_resample_farrow_v4 (channel-major
//               "chansel") and chan_resample_tm, chan_resample_farrow_tm
//               (time-major);
//   select3.py  window_resample_v3, window_resample_farrow_v3 (one channel);
//   select.py   window_select_pallas, window_select_farrow_pallas (any
//               dtype: the TPU's float64 route, and complex signals as
//               re/im planes and complex taps as split banks).
// They differ in TPU layout work: banded K tiles built from host tap rows,
// one-hot bf16 selects, 128-lane DMA blocks, alpha packed to 16-21 bits.
// Output by output each computes the windowed dot below, which this kernel
// computes directly, in the signal's type, with exact integer indices:
//
//   D = nphi << 32,  delta = nphi/rate in 32-bit fixed point (< 2^44)
//   u_n = u0 + n*delta,  e_n = d0 - 1 + u_n / D   (window start in xext)
//   r_n = u_n % D,  phi_n = r_n >> 32,  alpha_n = (r_n % 2^32) * 2^-32
//   tap_n[t] = sum_p table[p, t, phi_n] * alpha_n^p       (Horner)
//   y[c, n]  = sum_{t < T} xext[c, e_n + t] * tap_n[t]
//   xext[c]  = [history (T - 1 samples) ++ x[c]]
//
// Arbitrary: table = (pfb, dpfb), so tap = pfb + alpha * dpfb (one fmaf).
// Farrow: the reference's taps are sum_k coeffs[k, t] * psi^k at
// psi = 1 + phi + alpha in [1, nphi + 1). Horner over psi in float32 would
// sum terms of size psi^P (about 1e6 at nphi 32, P 4) to taps below 1, so
// the host re-centres each tap polynomial at psi = phi + 1 in float64
// (ops/params.py farrow_table) and rounds the (P+1, T, nphi) table to the
// taps' type; the kernel then runs Horner over alpha in [0, 1), where no
// term exceeds the tap's own scale. One code path serves both methods.
//
// Types, by signal X and table W: float32/float32, float64/float64, and
// complex64 (float2) or complex128 (double2) samples, interleaved as torch
// stores them, against a real table of their precision or a complex one of
// their type (mac.cuh). Taps are evaluated in W, alpha in W's real type.
//
// Exactness:
// - a tile's base (u0 + n0*delta) / D is formed in 128 bits (__umul64hi):
//   n*delta passes 2^63 near n = 2^19.3 at nphi 1024, rate 0.3. The host
//   keeps u0 + n_out*delta below 2^96, so its top 64 bits divide by nphi;
// - inside a tile, r0 + j*delta < 2^44 + 2^10 * 2^44 fits 64 bits, and its
//   top 32 bits (< 2^23) give the window offset and phase by a 32-bit
//   division by nphi;
// - alpha is the 32-bit remainder converted once and scaled by 2^-32
//   exactly: in float (__uint2float_rn, round to nearest) for float32
//   tables, and exactly in double for float64 and complex128 ones, where
//   the 32-bit remainder is a double with no rounding at all. Either way
//   each output depends only on (r_n, its window), never on its tile:
//   chunked == whole bit for bit in every type.
//
// Design (correct and simple first):
// - grid.x walks tiles of outputs, grid.y channels (channel-major: one
//   channel per block, one thread per output) or groups of 32 channels
//   (time-major: a lane per channel, a warp per output, so the 32 lanes
//   share one output's taps and read x rows and write y rows coalesced);
//   blocks loop over tiles and channels (grid-stride);
// - the table (2*T*nphi words for arbitrary, 2.5 KB in float at the bench's
//   taps) sits in shared memory when it fits in 96 KB, else is read through
//   L1; the span follows it at a 16-byte boundary;
// - each tile's input span (about tile*delta/D + T samples, times the
//   group's channels) is loaded cooperatively into shared memory, reading
//   the history or x by index: [history ++ x] is never built in device
//   memory. The host halves the tile until the span fits; when one
//   output's window cannot fit it returns an error and nothing runs.
//
// Bound: device memory moves sizeof(X) bytes per input and per output; per
// output the kernel reads T window words and T*(P+1) table words from
// shared memory and issues T*(P+1) multiply-adds in W (and T in X) plus
// the index math (one 64-bit multiply, one 32-bit division). Measured
// times live in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mac.cuh"

namespace {

using mr::mac;

constexpr int kThreads = 256;
constexpr int kLanes = 32;          // channels per block, time-major
constexpr int kMaxTileCM = 1024;    // outputs per tile, channel-major
constexpr int kMaxTileTM = 256;     // outputs per tile, time-major
constexpr int64_t kMaxGridX = 1024;
constexpr int64_t kMaxGridY = 65535;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kTableSmemLimit = 96 * 1024;
constexpr int kErrTooLarge = -1;
constexpr float kTwoPowMinus32 = 2.3283064365386963e-10f;  // exactly 2^-32

// (q, r) = divmod(u0 + n0*delta, nphi << 32), exact for a sum below 2^96.
__device__ __forceinline__ void tile_base(uint64_t n0, uint64_t delta,
                                          uint64_t u0, uint32_t nphi,
                                          uint64_t* q, uint64_t* r) {
  const uint64_t lo = n0 * delta;
  uint64_t hi = __umul64hi(n0, delta);
  const uint64_t sum = lo + u0;
  hi += sum < lo;                                // carry
  const uint64_t top = (hi << 32) | (sum >> 32); // the sum >> 32
  *q = top / nphi;
  *r = ((top - *q * nphi) << 32) | (sum & 0xffffffffull);
}

// The interpolation factor of a 32-bit remainder: exact in double, round
// to nearest in float.
__device__ __forceinline__ void to_alpha(uint32_t r, float* a) {
  *a = __uint2float_rn(r) * kTwoPowMinus32;
}
__device__ __forceinline__ void to_alpha(uint32_t r, double* a) {
  *a = (double)r * 0x1p-32;
}

template <typename A>
struct Pos {
  uint32_t off;  // window start, relative to the tile's first window
  uint32_t phi;  // phase column
  A alpha;       // interpolation factor in [0, 1)
};

// Output j of a tile whose first output has remainder r0 < D.
template <typename A>
__device__ __forceinline__ Pos<A> position(uint64_t r0, uint64_t delta,
                                           uint32_t nphi, uint32_t j) {
  const uint64_t v = r0 + (uint64_t)j * delta;
  const uint32_t hi = (uint32_t)(v >> 32);
  Pos<A> p;
  p.off = hi / nphi;
  p.phi = hi - p.off * nphi;
  to_alpha((uint32_t)v, &p.alpha);
  return p;
}

// v * alpha + c for a real or complex table word v, c and a real alpha.
__device__ __forceinline__ float horner(float v, float a, float c) {
  return fmaf(v, a, c);
}
__device__ __forceinline__ double horner(double v, double a, double c) {
  return fma(v, a, c);
}
__device__ __forceinline__ float2 horner(float2 v, float a, float2 c) {
  return make_float2(fmaf(v.x, a, c.x), fmaf(v.y, a, c.y));
}
__device__ __forceinline__ double2 horner(double2 v, double a, double2 c) {
  return make_double2(fma(v.x, a, c.x), fma(v.y, a, c.y));
}

// sum_p c[p * stride] * alpha^p, by Horner from the top coefficient.
template <typename W, typename A>
__device__ __forceinline__ W eval_tap(const W* c, int P1, int stride,
                                      A alpha) {
  W v = c[(P1 - 1) * stride];
  for (int p = P1 - 2; p >= 0; --p) v = horner(v, alpha, c[p * stride]);
  return v;
}

// Bytes of a table in shared memory, rounded up so the span after it is
// 16-byte aligned (a complex128 span word is a 16-byte load).
__host__ __device__ __forceinline__ size_t table_bytes(int P1, int T,
                                                       int nphi,
                                                       size_t elem) {
  return ((size_t)P1 * T * nphi * elem + 15) & ~(size_t)15;
}

template <typename X, typename W, bool kTimeMajor, bool kTableInSmem>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                const W* __restrict__ table, X* __restrict__ y,
                int64_t C, int64_t xlen, int T, int nphi, int P1,
                uint64_t delta, uint64_t u0, int64_t d0, int64_t n_out,
                int tile, int64_t n_tiles) {
  using A = typename mr::Real<W>::type;
  constexpr int kCB = kTimeMajor ? kLanes : 1;  // channels per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TN = T * nphi;  // stride between the table's coefficients
  W* s_table = reinterpret_cast<W*>(smem_raw);
  X* s_x = reinterpret_cast<X*>(
      smem_raw + (kTableInSmem ? table_bytes(P1, T, nphi, sizeof(W)) : 0));
  const W* tb = table;
  if (kTableInSmem) {
    for (int i = threadIdx.x; i < P1 * TN; i += blockDim.x)
      s_table[i] = table[i];
    tb = s_table;  // published by the __syncthreads below, before any use
  }
  const int H = T - 1;
  // this thread's channel in the group, first output and output stride
  const int tid = (int)threadIdx.x, nthreads = (int)blockDim.x;
  const int slot = kTimeMajor ? tid % kLanes : 0;
  const int j_first = kTimeMajor ? tid / kLanes : tid;
  const int j_step = kTimeMajor ? nthreads / kLanes : nthreads;

  for (int64_t g = blockIdx.y; g * kCB < C; g += gridDim.y) {
    const int64_t c = g * kCB + slot;
    for (int64_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
      const int64_t n0 = ti * tile;
      uint64_t q0, r0;
      tile_base((uint64_t)n0, delta, u0, (uint32_t)nphi, &q0, &r0);
      const int64_t e0 = d0 - 1 + (int64_t)q0;  // xext index, first window
      const int nt = (int)(n_out - n0 < tile ? n_out - n0 : tile);
      const int span = (int)position<A>(r0, delta, (uint32_t)nphi,
                                        (uint32_t)(nt - 1)).off + T;

      __syncthreads();  // the previous tile is done reading s_x
      for (int i = threadIdx.x; i < span * kCB; i += blockDim.x) {
        const int64_t cc = g * kCB + i % kCB;
        const int64_t e = e0 + i / kCB;
        X v = mr::zero<X>();
        if (cc < C) {
          v = e < H ? hist[cc * H + e]
                    : x[kTimeMajor ? (e - H) * C + cc : cc * xlen + (e - H)];
        }
        s_x[i] = v;
      }
      __syncthreads();

      if (c < C) {
        for (int j = j_first; j < nt; j += j_step) {
          const Pos<A> p = position<A>(r0, delta, (uint32_t)nphi,
                                       (uint32_t)j);
          const X* w = s_x + (int)p.off * kCB + slot;
          const W* coef = tb + p.phi;
          X acc = mr::zero<X>();
          for (int t = 0; t < T; ++t) {
            acc = mac(acc, w[t * kCB],
                      eval_tap(coef + t * nphi, P1, TN, p.alpha));
          }
          y[kTimeMajor ? (n0 + j) * C + c : c * n_out + n0 + j] = acc;
        }
      }
    }
  }
}

// Launch on x (C, xlen) -> y (C, n_out), or time-major x (xlen, C) ->
// y (n_out, C); see the extern "C" entries for the contract.
template <typename X, typename W, bool kTimeMajor>
int launch(const void* x, const void* hist, const void* table, void* y,
           int64_t C, int64_t xlen, int T, int nphi, int P1, uint64_t delta,
           uint64_t u0, int64_t d0, int64_t n_out, void* stream) {
  if (C <= 0 || n_out <= 0) return cudaSuccess;
  const size_t t_bytes = table_bytes(P1, T, nphi, sizeof(W));
  const bool table_smem = t_bytes <= kTableSmemLimit;
  const size_t avail = kSmemLimit - (table_smem ? t_bytes : 0);
  const uint64_t D = (uint64_t)nphi << 32;
  const size_t cb = kTimeMajor ? kLanes : 1;
  auto span_bytes = [&](int nb) {
    const uint64_t span = (D - 1 + (uint64_t)(nb - 1) * delta) / D + T;
    return (size_t)span * cb * sizeof(X);
  };
  int tile = kTimeMajor ? kMaxTileTM : kMaxTileCM;
  while (tile > 1 && span_bytes(tile) > avail) tile /= 2;
  if (span_bytes(tile) > avail) return kErrTooLarge;
  const size_t smem = (table_smem ? t_bytes : 0) + span_bytes(tile);
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  const int64_t groups = (C + (int64_t)cb - 1) / (int64_t)cb;
  const dim3 grid((unsigned)(n_tiles < kMaxGridX ? n_tiles : kMaxGridX),
                  (unsigned)(groups < kMaxGridY ? groups : kMaxGridY));
  auto kern = table_smem ? resample_kernel<X, W, kTimeMajor, true>
                         : resample_kernel<X, W, kTimeMajor, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const X*)x, (const X*)hist, (const W*)table, (X*)y, C, xlen, T, nphi,
      P1, delta, u0, d0, n_out, tile, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Channel-major (time_major = 0): x (C, xlen) -> y (C, n_out).
// Time-major (time_major = 1):    x (xlen, C) -> y (n_out, C).
// hist (C, T-1) and table (P1, T, nphi) in both; all float32, contiguous,
// on the current device. The caller guarantees 0 < nphi << 32 < 2^44,
// 0 < delta < 2^44, u0 + n_out*delta < 2^96, d0 >= 1, and that every
// window lies inside [history ++ x]: d0 + (u0 + (n_out-1)*delta) / D <=
// xlen. Returns a cudaError_t code, or kErrTooLarge when one output's
// window cannot fit in shared memory.
int mr_resample_f32(const void* x, const void* hist, const void* table,
                    void* y, int64_t C, int64_t xlen, int T, int nphi, int P1,
                    uint64_t delta, uint64_t u0, int64_t d0, int64_t n_out,
                    int time_major, void* stream) {
  auto run = time_major ? launch<float, float, true>
                        : launch<float, float, false>;
  return run(x, hist, table, y, C, xlen, T, nphi, P1, delta, u0, d0, n_out,
             stream);
}

// Channel-major only, as mr_resample_f32 with time_major = 0: x and hist
// (and y) of the signal type X, the table of type W, complex ones 8- or
// 16-byte aligned. One entry per (signal, table) pair: mr_resample_<name>.
#define MR_RESAMPLE(name, X, W)                                              \
  int mr_resample_##name(const void* x, const void* hist, const void* table, \
                         void* y, int64_t C, int64_t xlen, int T, int nphi,  \
                         int P1, uint64_t delta, uint64_t u0, int64_t d0,    \
                         int64_t n_out, void* stream) {                      \
    return launch<X, W, false>(x, hist, table, y, C, xlen, T, nphi, P1,     \
                               delta, u0, d0, n_out, stream);                \
  }

MR_RESAMPLE(f64, double, double)
MR_RESAMPLE(c64, float2, float)
MR_RESAMPLE(c64c, float2, float2)
MR_RESAMPLE(c128, double2, double)
MR_RESAMPLE(c128c, double2, double2)

#undef MR_RESAMPLE

const char* mr_error_string(int code) {
  if (code == kErrTooLarge) return "one output's window exceeds shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
