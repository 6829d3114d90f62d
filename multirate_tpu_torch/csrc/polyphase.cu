// Polyphase FIR / rational resampler for Hopper (sm_90a): float32, float64,
// complex64 and complex128 (against real or complex taps), and the quantized
// bfloat16 and int8 modes, with float32 or narrow float stores.
//
// Replaces the TPU kernels multirate_tpu/ops/pallas/rational2.py
// rational_supercycle_zc (float32, bf16, int8 and out_dtype modes; a
// complex64 signal reaches it as two float32 planes) and
// rational_supercycle_grouped (float32, bf16, float64) in the same file, and
// multirate_tpu/ops/pallas/rational.py rational_supercycle_pallas (any float
// type; complex as 2 to 4 planar real applies). Those kernels compute a
// banded matrix product Y = X3 @ K whose K is a host-built stack chosen by
// the entry (phase, deficit). Output by output that product is the
// polyphase dot below, which is what this kernel computes, with the index
// math done in closed form so no K stack exists:
//
//   t_n  = (phi0 - 1) + n*M,  in_n = d0 + t_n / L,  phi_n = t_n % L
//   y[c, n] = sum_{t < T} xext[c, in_n - 1 + t] * bank[t, phi_n]
//   xext[c] = [history tail (T - 1 samples) ++ x[c]]
//
// The standard FIR is (L, M) = (1, 1), the interpolator (L, 1), the
// decimator (1, M); their banks are the reversed taps as (T, 1).
//
// One template serves every mode, by signal type X (x and the history), tap
// type W (the bank) and output type Out:
// - float32, float64: an FMA in that type into an accumulator of that type;
// - complex64, complex128 (float2/double2, interleaved as torch stores
//   them: no planar split, which at the 8 M complex64 row would cost a read
//   and write of 64 MB of x and a recombine of 59 MB of y, more traffic
//   than the kernel's whole bound): against a real bank of their precision
//   2 real FMAs per tap, against a complex bank 4 (mac.cuh);
// - bf16 (the TPU's single bf16 MXU pass with f32 accumulation): span and
//   bank are staged widened to float; a bf16 x bf16 product is exact in
//   float32, so the FMA adds exact products. Global reads stay 2 bytes;
// - int8 (the TPU's s8 x s8 -> s32 pass): span and bank staged as int8,
//   integer multiply-accumulate in int32, exact, so chunked == whole bit for
//   bit. The caller keeps T * 128 * 127 below 2^31;
// - narrow store (out_dtype): the float32 accumulator is stored through
//   __float2bfloat16_rn / __float2half_rn, round to nearest even, as
//   acc.astype(bf16) in JAX.
//
// Design (correct and simple first):
// - grid.y walks channels, grid.x walks tiles of up to 1024 outputs; a block
//   loops over tiles (grid-stride), so the bank is staged once per block;
// - the bank (T*L staged elements, 14 KB in float at the 147//160 headline,
//   28 KB in double, 56 KB in complex128) is staged in shared memory when it
//   fits in 96 KB, else read through the L1 cache; the span follows it at a
//   16-byte boundary;
// - each tile's input span (about tile*M/L + T samples) is loaded
//   cooperatively and coalesced into shared memory, reading the history
//   tail or x by index: there is no [history ++ x] concat in device memory;
// - each thread computes whole outputs, a T-term dot from shared memory,
//   and stores them coalesced;
// - tile bases are int64 (t_n passes 2^31 near 13 M outputs at M = 160);
//   offsets inside a tile are int32 (the host keeps tile*M below 2^31).
//
// Bound: device memory moves sizeof(X) bytes per input and sizeof(Out)*L/M
// bytes per output (about 62 MB, 18 us at 3.35 TB/s, for the 8 M-sample
// float32 headline block; 45 MB for bf16 in, 37 MB for int8 in, 123 MB and
// 37 us for float64 or complex64), so the kernel is memory-bound in
// principle (float64 at the H100's 34 TFLOP/s FP64 rate needs 10 us for the
// headline's 176 M multiply-adds). This first version reads two
// shared-memory words per multiply-add (T = 24 at the headline), and a
// warp's tap reads (columns (r0 + 13j) mod 147) conflict across banks, so it
// is bound by shared-memory wavefronts, not by HBM, in every mode (measured
// times: PERF.md); 8- and 16-byte words take more wavefronts still. Keeping
// each thread on one phase, so its T taps sit in registers, is the next
// step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mac.cuh"

namespace {

using mr::mac;

constexpr int kThreads = 256;
constexpr int kMaxTile = 1024;     // outputs per tile
constexpr int64_t kMaxGridX = 1024;
constexpr int64_t kMaxGridY = 65535;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kBankSmemLimit = 96 * 1024;
constexpr int kErrTooLarge = -1;

// The staged (shared-memory) types of a (signal, tap) pair and its
// accumulator: the types themselves, but bf16 staged as float and int8
// summed in int32.
template <typename X, typename W> struct Mode {
  using XStage = X;
  using WStage = W;
  using Acc = X;
};
template <> struct Mode<__nv_bfloat16, __nv_bfloat16> {
  using XStage = float;
  using WStage = float;
  using Acc = float;
};
template <> struct Mode<int8_t, int8_t> {
  using XStage = int8_t;
  using WStage = int8_t;
  using Acc = int32_t;
};

template <typename T>
__device__ __forceinline__ T stage(T v) { return v; }
__device__ __forceinline__ float stage(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ void store(T* p, T v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

// Bytes of a staged bank, rounded up so the span after it is 16-byte
// aligned (a complex128 span word is a 16-byte load).
__host__ __device__ __forceinline__ size_t bank_bytes(int T, int L,
                                                      size_t elem) {
  return ((size_t)T * L * elem + 15) & ~(size_t)15;
}

template <typename X, typename W, typename Out, bool kBankInSmem>
__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const X* __restrict__ x, const X* __restrict__ hist,
                 const W* __restrict__ bank, Out* __restrict__ y,
                 int64_t C, int64_t xlen, int T, int L, int M, int phi0,
                 int64_t d0, int64_t n_out, int tile, int64_t n_tiles) {
  using XStage = typename Mode<X, W>::XStage;
  using WStage = typename Mode<X, W>::WStage;
  using Acc = typename Mode<X, W>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WStage* s_bank = reinterpret_cast<WStage*>(smem_raw);
  XStage* s_x = reinterpret_cast<XStage*>(
      smem_raw + (kBankInSmem ? bank_bytes(T, L, sizeof(WStage)) : 0));
  if (kBankInSmem) {
    // published by the __syncthreads below, before any use
    for (int i = threadIdx.x; i < T * L; i += blockDim.x)
      s_bank[i] = stage(bank[i]);
  }
  const int H = T - 1;

  for (int64_t c = blockIdx.y; c < C; c += gridDim.y) {
    const X* xc = x + c * xlen;
    const X* hc = hist + c * H;
    Out* yc = y + c * n_out;
    for (int64_t tile_i = blockIdx.x; tile_i < n_tiles; tile_i += gridDim.x) {
      const int64_t n0 = tile_i * tile;
      const int64_t t0 = (int64_t)(phi0 - 1) + n0 * M;
      const int64_t e0 = d0 - 1 + t0 / L;  // xext index of the first window
      const int r0 = (int)(t0 % L);
      const int nt = (int)(n_out - n0 < tile ? n_out - n0 : tile);
      const int span = (r0 + (nt - 1) * M) / L + T;

      __syncthreads();  // the previous tile is done reading s_x
      for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const int64_t e = e0 + i;
        s_x[i] = e < H ? stage(hc[e]) : stage(xc[e - H]);
      }
      __syncthreads();

      for (int j = threadIdx.x; j < nt; j += blockDim.x) {
        const int tj = r0 + j * M;
        const int off = tj / L;
        const int ph = tj - off * L;
        const XStage* w = s_x + off;
        Acc acc = mr::zero<Acc>();
        if constexpr (kBankInSmem) {
          const WStage* b = s_bank + ph;
          for (int t = 0; t < T; ++t) acc = mac(acc, w[t], b[t * L]);
        } else {
          const W* b = bank + ph;
          for (int t = 0; t < T; ++t) acc = mac(acc, w[t], stage(b[t * L]));
        }
        store(yc + n0 + j, acc);
      }
    }
  }
}

template <typename X, typename W, typename Out>
int launch(const void* x, const void* hist, const void* bank, void* y,
           int64_t C, int64_t xlen, int T, int L, int M, int phi0,
           int64_t d0, int64_t n_out, void* stream) {
  using XStage = typename Mode<X, W>::XStage;
  using WStage = typename Mode<X, W>::WStage;
  if (C <= 0 || n_out <= 0) return cudaSuccess;
  const size_t b_bytes = bank_bytes(T, L, sizeof(WStage));
  const bool bank_smem = b_bytes <= kBankSmemLimit;
  const size_t avail = kSmemLimit - (bank_smem ? b_bytes : 0);
  auto span_max = [&](int nb) {
    return (size_t)((L - 1 + (int64_t)(nb - 1) * M) / L + T);
  };
  int tile = kMaxTile;
  while (tile > 1 && span_max(tile) * sizeof(XStage) > avail) tile /= 2;
  if (span_max(tile) * sizeof(XStage) > avail) return kErrTooLarge;
  const size_t smem =
      (bank_smem ? b_bytes : 0) + span_max(tile) * sizeof(XStage);
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  const dim3 grid((unsigned)(n_tiles < kMaxGridX ? n_tiles : kMaxGridX),
                  (unsigned)(C < kMaxGridY ? C : kMaxGridY));
  auto kern = bank_smem ? polyphase_kernel<X, W, Out, true>
                        : polyphase_kernel<X, W, Out, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const X*)x, (const X*)hist, (const W*)bank, (Out*)y, C, xlen, T, L,
      M, phi0, d0, n_out, tile, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (C, n_out) = polyphase(x (C, xlen), hist (C, T-1), bank (T, L)); x and
// hist of the signal type, bank of the tap type, all contiguous, on the
// current device, complex ones 8- or 16-byte aligned. The caller guarantees
// that every window lies inside [history ++ x]: d0 >= 1, 1 <= phi0 <= L and
// d0 + ((phi0-1) + (n_out-1)*M) / L <= xlen. Returns a cudaError_t code, or
// kErrTooLarge when one tile's span cannot fit in shared memory. One entry
// per (signal, tap, output) triple the modes use: mr_polyphase_<name>.
#define MR_POLYPHASE(name, X, W, Out)                                        \
  int mr_polyphase_##name(const void* x, const void* hist, const void* bank, \
                          void* y, int64_t C, int64_t xlen, int T, int L,    \
                          int M, int phi0, int64_t d0, int64_t n_out,        \
                          void* stream) {                                    \
    return launch<X, W, Out>(x, hist, bank, y, C, xlen, T, L, M, phi0, d0,  \
                             n_out, stream);                                 \
  }

MR_POLYPHASE(f32, float, float, float)
MR_POLYPHASE(bf16, __nv_bfloat16, __nv_bfloat16, float)
MR_POLYPHASE(s8, int8_t, int8_t, int32_t)
MR_POLYPHASE(f32_bf16out, float, float, __nv_bfloat16)
MR_POLYPHASE(f32_f16out, float, float, __half)
MR_POLYPHASE(bf16_bf16out, __nv_bfloat16, __nv_bfloat16, __nv_bfloat16)
MR_POLYPHASE(bf16_f16out, __nv_bfloat16, __nv_bfloat16, __half)
MR_POLYPHASE(f64, double, double, double)
MR_POLYPHASE(c64, float2, float, float2)
MR_POLYPHASE(c64c, float2, float2, float2)
MR_POLYPHASE(c128, double2, double, double2)
MR_POLYPHASE(c128c, double2, double2, double2)

#undef MR_POLYPHASE

const char* mr_error_string(int code) {
  if (code == kErrTooLarge) return "tile span exceeds shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
