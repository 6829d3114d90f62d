// Polyphase FIR / rational resampler, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel multirate_tpu/ops/pallas/rational2.py
// rational_supercycle_zc (and the float32 real case of
// rational_supercycle_grouped in the same file and of
// multirate_tpu/ops/pallas/rational.py rational_supercycle_pallas). Those
// kernels compute a banded matrix product Y = X3 @ K whose K is a host-built
// stack chosen by the entry (phase, deficit). Output by output that product
// is the polyphase dot below, which is what this kernel computes, with the
// index math done in closed form so no K stack exists:
//
//   t_n  = (phi0 - 1) + n*M,  in_n = d0 + t_n / L,  phi_n = t_n % L
//   y[c, n] = sum_{t < T} xext[c, in_n - 1 + t] * bank[t, phi_n]
//   xext[c] = [history tail (T - 1 samples) ++ x[c]]
//
// The standard FIR is (L, M) = (1, 1), the interpolator (L, 1), the
// decimator (1, M); their banks are the reversed taps as (T, 1).
//
// Design (correct and simple first):
// - grid.y walks channels, grid.x walks tiles of up to 1024 outputs; a block
//   loops over tiles (grid-stride), so the bank is staged once per block;
// - the bank (T*L floats, 14 KB at the 147//160 headline) is staged in
//   shared memory when it fits in 96 KB, else read through the L1 cache;
// - each tile's input span (about tile*M/L + T samples) is loaded
//   cooperatively and coalesced into shared memory, reading the history
//   tail or x by index: there is no [history ++ x] concat in device memory;
// - each thread computes whole outputs, a T-term float32 FMA dot from
//   shared memory, and stores them coalesced;
// - tile bases are int64 (t_n passes 2^31 near 13 M outputs at M = 160);
//   offsets inside a tile are int32 (the host keeps tile*M below 2^31).
//
// Bound: device memory moves 4 bytes per input and 4*L/M bytes per output
// (about 62 MB, 18 us at 3.35 TB/s, for the 8 M-sample headline block), so
// the kernel is memory-bound in principle. This first version reads two
// shared-memory words per FMA (T = 24 at the headline), 1.4 GB of
// shared-memory loads, and a warp's tap reads (columns (r0 + 13j) mod 147)
// conflict across banks, so it is bound by shared-memory wavefronts, not by
// HBM (measured times: PERF.md). Keeping each thread on one phase, so its T
// taps sit in registers, is the next step.

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

template <bool kBankInSmem>
__global__ void __launch_bounds__(kThreads)
polyphase_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                 const float* __restrict__ bank, float* __restrict__ y,
                 int64_t C, int64_t xlen, int T, int L, int M, int phi0,
                 int64_t d0, int64_t n_out, int tile, int64_t n_tiles) {
  extern __shared__ float smem[];
  float* s_x = smem + (kBankInSmem ? T * L : 0);
  const float* bk = bank;
  if (kBankInSmem) {
    for (int i = threadIdx.x; i < T * L; i += blockDim.x) smem[i] = bank[i];
    bk = smem;  // published by the __syncthreads below, before any use
  }
  const int H = T - 1;

  for (int64_t c = blockIdx.y; c < C; c += gridDim.y) {
    const float* xc = x + c * xlen;
    const float* hc = hist + c * H;
    float* yc = y + c * n_out;
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
        s_x[i] = e < H ? hc[e] : xc[e - H];
      }
      __syncthreads();

      for (int j = threadIdx.x; j < nt; j += blockDim.x) {
        const int tj = r0 + j * M;
        const int off = tj / L;
        const int ph = tj - off * L;
        const float* w = s_x + off;
        const float* b = bk + ph;
        float acc = 0.f;
        for (int t = 0; t < T; ++t) acc = fmaf(w[t], b[t * L], acc);
        yc[n0 + j] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

// y (C, n_out) = polyphase(x (C, xlen), hist (C, T-1), bank (T, L)); all
// float32, contiguous, on the current device. The caller guarantees that
// every window lies inside [history ++ x]: d0 >= 1, 1 <= phi0 <= L and
// d0 + ((phi0-1) + (n_out-1)*M) / L <= xlen. Returns a cudaError_t code,
// or kErrTooLarge when one tile's span cannot fit in shared memory.
int mr_polyphase_f32(const void* x, const void* hist, const void* bank,
                     void* y, int64_t C, int64_t xlen, int T, int L, int M,
                     int phi0, int64_t d0, int64_t n_out, void* stream) {
  if (C <= 0 || n_out <= 0) return cudaSuccess;
  const size_t bank_bytes = (size_t)T * L * sizeof(float);
  const bool bank_smem = bank_bytes <= kBankSmemLimit;
  const size_t avail = kSmemLimit - (bank_smem ? bank_bytes : 0);
  auto span_max = [&](int nb) {
    return (size_t)((L - 1 + (int64_t)(nb - 1) * M) / L + T);
  };
  int tile = kMaxTile;
  while (tile > 1 && span_max(tile) * sizeof(float) > avail) tile /= 2;
  if (span_max(tile) * sizeof(float) > avail) return kErrTooLarge;
  const size_t smem =
      (bank_smem ? bank_bytes : 0) + span_max(tile) * sizeof(float);
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  const dim3 grid((unsigned)(n_tiles < kMaxGridX ? n_tiles : kMaxGridX),
                  (unsigned)(C < kMaxGridY ? C : kMaxGridY));
  auto kern = bank_smem ? polyphase_kernel<true> : polyphase_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)hist, (const float*)bank, (float*)y, C,
      xlen, T, L, M, phi0, d0, n_out, tile, n_tiles);
  return cudaGetLastError();
}

const char* mr_error_string(int code) {
  if (code == kErrTooLarge) return "tile span exceeds shared memory";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
