// Polyphase FIR / rational resampler for Hopper (sm_90a): float32, and the
// quantized bfloat16 and int8 modes, with float32 or narrow float stores.
//
// Replaces the TPU kernel multirate_tpu/ops/pallas/rational2.py
// rational_supercycle_zc in its float32, bf16, int8 and out_dtype modes (and
// the float32 and bf16 cases of rational_supercycle_grouped in the same file,
// and the float32 real case of multirate_tpu/ops/pallas/rational.py
// rational_supercycle_pallas). Those kernels compute a banded matrix product
// Y = X3 @ K whose K is a host-built stack chosen by the entry (phase,
// deficit). Output by output that product is the polyphase dot below, which
// is what this kernel computes, with the index math done in closed form so
// no K stack exists:
//
//   t_n  = (phi0 - 1) + n*M,  in_n = d0 + t_n / L,  phi_n = t_n % L
//   y[c, n] = sum_{t < T} xext[c, in_n - 1 + t] * bank[t, phi_n]
//   xext[c] = [history tail (T - 1 samples) ++ x[c]]
//
// The standard FIR is (L, M) = (1, 1), the interpolator (L, 1), the
// decimator (1, M); their banks are the reversed taps as (T, 1).
//
// One template serves every mode, by storage type In and output type Out:
// - float32: float32 FMA into a float32 accumulator;
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
// - the bank (T*L staged elements, 14 KB in float at the 147//160 headline)
//   is staged in shared memory when it fits in 96 KB, else read through the
//   L1 cache;
// - each tile's input span (about tile*M/L + T samples) is loaded
//   cooperatively and coalesced into shared memory, reading the history
//   tail or x by index: there is no [history ++ x] concat in device memory;
// - each thread computes whole outputs, a T-term dot from shared memory,
//   and stores them coalesced;
// - tile bases are int64 (t_n passes 2^31 near 13 M outputs at M = 160);
//   offsets inside a tile are int32 (the host keeps tile*M below 2^31).
//
// Bound: device memory moves sizeof(In) bytes per input and sizeof(Out)*L/M
// bytes per output (about 62 MB, 18 us at 3.35 TB/s, for the 8 M-sample
// float32 headline block; 45 MB for bf16 in, 37 MB for int8 in), so the
// kernel is memory-bound in principle. This first version reads two
// shared-memory words per multiply-add (T = 24 at the headline), and a
// warp's tap reads (columns (r0 + 13j) mod 147) conflict across banks, so it
// is bound by shared-memory wavefronts, not by HBM, in every mode (measured
// times: PERF.md). Keeping each thread on one phase, so its T taps sit in
// registers, is the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 1024;     // outputs per tile
constexpr int64_t kMaxGridX = 1024;
constexpr int64_t kMaxGridY = 65535;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kBankSmemLimit = 96 * 1024;
constexpr int kErrTooLarge = -1;

// The staged (shared-memory) type and the accumulator of a storage type.
template <typename In> struct Mode;
template <> struct Mode<float> {
  using Stage = float;
  using Acc = float;
};
template <> struct Mode<__nv_bfloat16> {
  using Stage = float;
  using Acc = float;
};
template <> struct Mode<int8_t> {
  using Stage = int8_t;
  using Acc = int32_t;
};

__device__ __forceinline__ float stage(float v) { return v; }
__device__ __forceinline__ float stage(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int8_t stage(int8_t v) { return v; }

__device__ __forceinline__ float mac(float acc, float w, float b) {
  return fmaf(w, b, acc);
}
__device__ __forceinline__ int32_t mac(int32_t acc, int8_t w, int8_t b) {
  return acc + (int32_t)w * (int32_t)b;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store(int32_t* p, int32_t v) { *p = v; }

template <typename In, typename Out, bool kBankInSmem>
__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const In* __restrict__ x, const In* __restrict__ hist,
                 const In* __restrict__ bank, Out* __restrict__ y,
                 int64_t C, int64_t xlen, int T, int L, int M, int phi0,
                 int64_t d0, int64_t n_out, int tile, int64_t n_tiles) {
  using Stage = typename Mode<In>::Stage;
  using Acc = typename Mode<In>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* smem = reinterpret_cast<Stage*>(smem_raw);
  Stage* s_x = smem + (kBankInSmem ? T * L : 0);
  if (kBankInSmem) {
    // published by the __syncthreads below, before any use
    for (int i = threadIdx.x; i < T * L; i += blockDim.x)
      smem[i] = stage(bank[i]);
  }
  const int H = T - 1;

  for (int64_t c = blockIdx.y; c < C; c += gridDim.y) {
    const In* xc = x + c * xlen;
    const In* hc = hist + c * H;
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
        const Stage* w = s_x + off;
        Acc acc = 0;
        if constexpr (kBankInSmem) {
          const Stage* b = smem + ph;
          for (int t = 0; t < T; ++t) acc = mac(acc, w[t], b[t * L]);
        } else {
          const In* b = bank + ph;
          for (int t = 0; t < T; ++t) acc = mac(acc, w[t], stage(b[t * L]));
        }
        store(yc + n0 + j, acc);
      }
    }
  }
}

template <typename In, typename Out>
int launch(const void* x, const void* hist, const void* bank, void* y,
           int64_t C, int64_t xlen, int T, int L, int M, int phi0,
           int64_t d0, int64_t n_out, void* stream) {
  using Stage = typename Mode<In>::Stage;
  if (C <= 0 || n_out <= 0) return cudaSuccess;
  const size_t bank_bytes = (size_t)T * L * sizeof(Stage);
  const bool bank_smem = bank_bytes <= kBankSmemLimit;
  const size_t avail = kSmemLimit - (bank_smem ? bank_bytes : 0);
  auto span_max = [&](int nb) {
    return (size_t)((L - 1 + (int64_t)(nb - 1) * M) / L + T);
  };
  int tile = kMaxTile;
  while (tile > 1 && span_max(tile) * sizeof(Stage) > avail) tile /= 2;
  if (span_max(tile) * sizeof(Stage) > avail) return kErrTooLarge;
  const size_t smem =
      (bank_smem ? bank_bytes : 0) + span_max(tile) * sizeof(Stage);
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  const dim3 grid((unsigned)(n_tiles < kMaxGridX ? n_tiles : kMaxGridX),
                  (unsigned)(C < kMaxGridY ? C : kMaxGridY));
  auto kern = bank_smem ? polyphase_kernel<In, Out, true>
                        : polyphase_kernel<In, Out, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const In*)x, (const In*)hist, (const In*)bank, (Out*)y, C, xlen, T, L,
      M, phi0, d0, n_out, tile, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y (C, n_out) = polyphase(x (C, xlen), hist (C, T-1), bank (T, L)); x, hist
// and bank of one storage type, all contiguous, on the current device. The
// caller guarantees that every window lies inside [history ++ x]: d0 >= 1,
// 1 <= phi0 <= L and d0 + ((phi0-1) + (n_out-1)*M) / L <= xlen. Returns a
// cudaError_t code, or kErrTooLarge when one tile's span cannot fit in
// shared memory. One entry per (storage, output) pair the modes use:
// mr_polyphase_<name>.
#define MR_POLYPHASE(name, In, Out)                                          \
  int mr_polyphase_##name(const void* x, const void* hist, const void* bank, \
                          void* y, int64_t C, int64_t xlen, int T, int L,    \
                          int M, int phi0, int64_t d0, int64_t n_out,        \
                          void* stream) {                                    \
    return launch<In, Out>(x, hist, bank, y, C, xlen, T, L, M, phi0, d0,     \
                           n_out, stream);                                   \
  }

MR_POLYPHASE(f32, float, float)
MR_POLYPHASE(bf16, __nv_bfloat16, float)
MR_POLYPHASE(s8, int8_t, int32_t)
MR_POLYPHASE(f32_bf16out, float, __nv_bfloat16)
MR_POLYPHASE(f32_f16out, float, __half)
MR_POLYPHASE(bf16_bf16out, __nv_bfloat16, __nv_bfloat16)
MR_POLYPHASE(bf16_f16out, __nv_bfloat16, __half)

#undef MR_POLYPHASE

const char* mr_error_string(int code) {
  if (code == kErrTooLarge) return "tile span exceeds shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
