// Polyphase FIR / rational resampler for Hopper (sm_90a): float32, float64,
// complex64 and complex128 (against real or complex taps), real samples
// against complex taps, the quantized bfloat16 and int8 modes, narrow reads
// of int16, uint8, float16, bfloat16 and int8 samples against float32 or
// complex64 taps, with float32 or narrow float stores, and exact 32- and
// 64-bit integer words.
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
// One template per variant serves every mode, by signal type X (x and the
// history), tap type W (the bank) and output type Out:
// - float32, float64: an FMA in that type into an accumulator of that type;
// - complex64, complex128 (float2/double2, interleaved as torch stores
//   them: no planar split, which at the 8 M complex64 row would cost more
//   traffic than the kernel's whole bound): against a real bank of their
//   precision 2 real FMAs per tap, against a complex bank 4 (mac.cuh);
// - bf16 (the TPU's single bf16 MXU pass with f32 accumulation): staged
//   widened to float; a bf16 x bf16 product is exact in float32;
// - int8 (the TPU's s8 x s8 -> s32 pass): staged as int8, exact int32 sums
//   (__dp4a on packed bytes in the register variant), so chunked == whole
//   bit for bit. The caller keeps T * 128 * 127 below 2^31;
// - narrow reads (16-bit PCM, uint8 I/Q, float16, and bf16 or int8 against
//   float taps): the raw samples are staged as stored, so a tile's span
//   moves 2 or 1 bytes a sample, and each is widened to float as it is
//   read from shared memory (mac.cuh widen, exact); from there on the
//   float32 mode's arithmetic in the same order, so each output equals the
//   float32 entry's on the widened values bit for bit, in every variant;
// - narrow store (out_dtype): the float32 accumulator is stored through
//   __float2bfloat16_rn / __float2half_rn, round to nearest even;
// - real samples against complex taps (float or a narrow read against
//   float2, double against double2): staged real (4 or 8 bytes a sample,
//   half a complex one's), 2 FMAs a tap into a complex accumulator
//   (mac.cuh), each output the complex-sample entry's bits on the samples
//   cast to complex, up to the sign of a zero;
// - integer words (int32 or int64 tensors, and uint32/uint64 ones as their
//   bits): staged as uint32_t/uint64_t, whose multiply-adds wrap modulo
//   2^32 or 2^64 (unsigned: signed overflow is undefined), the low bits of
//   the exact sum, stored as the signed word's bits. A 64-bit multiply-add
//   is several instructions on Hopper.
//
// What bounds it. Device memory moves sizeof(X) bytes per input and
// sizeof(Out)*L/M per output (62 MB, 18.3 us at 3.35 TB/s, for the 8 M
// float32 headline block at 147//160); the multiply-adds (176 M there) take
// 5.3 us at 67 TFLOP/s float32. So the kernel is bound by bytes, unless the
// dot's operands come from shared memory: at one 4-byte shared read per
// multiply-add the headline moves 705 MB through shared memory, more than
// 24 us at ~30 TB/s, and a warp's reads at lane strides of about M/L words
// conflict across banks. Each variant is about keeping shared reads per
// multiply-add well under one. Tensor cores would not help: float32 needs
// full float32 products (TF32's ~1e-3 fails the 8e-5 oracle tripwire), and
// every mode is bound by bytes once shared reads are cut.
//
// Five variants, chosen by the host (mr_plan.cpp, through
// ops/cuda/polyphase.py plan()), never
// after a failure:
// - "bcast" (L == 1: the FIR and the decimators, any T): every output has
//   the same taps, read from shared memory at one address per warp (a
//   broadcast). The span is split by input phase mod M, so a 1//M
//   decimation becomes M stride-1 dots; each thread owns R consecutive
//   outputs (R odd: lanes R words apart never share a bank) and slides a
//   rotating window of R registers, one shared read per step feeding R
//   multiply-adds. Tap rows are zero-padded to a multiple of R, so the
//   unrolled steps carry no branch.
// - "slide" (interpolators, M / gcd(L, M) == 1, T in {24, 37}): outputs n
//   and n + Q (Q = L / gcd) share their phase and their windows start one
//   input apart, so a thread keeps one phase's T taps in registers and
//   computes R outputs of that phase from one run of T + R - 1 window
//   words: (T + R - 1) / R shared reads a multiply-add's T.
// - "reg" (other L > 1, T in {24, 37}, Q <= 256*R, windows of R
//   neighbouring outputs within E samples): each thread owns R
//   neighbouring outputs of one period of Q outputs and keeps their taps in
//   registers for the whole launch, walking periods (P = M / gcd inputs
//   apart) with the same registers. The R windows overlap, so each tap
//   vector is stored shifted by its window's offset d_r <= E into U = T + E
//   registers, zero outside, and the R dots read one run of U window words:
//   U shared reads feed R*U multiply-adds (R = 4 for 4-byte taps, 2 for
//   8-byte, 1 for 16-byte). int8 packs taps four to a register and reads
//   aligned words, shifted into place with a funnel shift, into __dp4a.
//   The cost is E/T more multiply-adds and R*U tap registers (ptxas reports
//   them in build.log). Like the TPU's banded product, a non-finite sample
//   reaches the E outputs whose padded (zero) taps cover it.
// - "reg.tma" ("reg"'s float32 launches at T = 24 with P a multiple of 4,
//   16-byte aligned channels and enough tiles to keep a persistent grid
//   busy): "reg"'s outputs, taps and sums, fed another way. "reg" at
//   147//160 ran at 66% of its bytes bound with no unit saturated (shared
//   reads ~54% busy, issue ~35%, device memory 66%): latency-bound, with 3
//   warps a scheduler waiting on 28 scalar shared reads a period, on the
//   cp.async double buffer (at most ~17.6 KB of input in flight an SM) and
//   on two block barriers a tile. Here one producer warp a block keeps a
//   ring of tile buffers full with bulk copies (cp.async.bulk, completing
//   on an mbarrier: no register or instruction of the consumers goes into
//   a copy) while four consumer warps wait on each buffer's "full" barrier
//   and release it on its "empty" one (an arrival a warp), so no block
//   barrier remains. A thread's window starts at the same word of a
//   16-byte word in every period, so its taps are stored shifted by that
//   (UA = 32 registers an output at T = 24, not 28) and it reads 8 aligned
//   16-byte words a period, not 28 scalars: fewer shared wavefronts and 8
//   independent loads in flight, for 14% more multiply-adds (zero taps) at
//   167 registers, 2 blocks of 160 threads an SM. Tiles of 12 periods a
//   thread (23 KB at 147//160) in a ring of 2 were the fastest of a sweep
//   on the H100 (tools/polyphase_runs.py): the dot is then ~73% of the
//   consumers' clocks and the release ~13%, and madi's call runs at ~83%
//   of its bytes bound, not 66%.// - "general" (anything else: other T, Q too large for the mapping, a bank
//   over 96 KB such as 48 complex128 taps at 147//160): the first design,
//   kept as is. Each thread computes whole outputs, two shared reads per
//   multiply-add (window and bank), the bank in shared memory or read
//   through L1; each tile is staged synchronously.
// "reg", "slide" and "bcast" stage each tile's input span with 16-byte
// cp.async copies into a double buffer, so tile i + 1 loads while tile i
// computes (a span that reaches into the history is stored synchronously;
// there is no [history ++ x] in device memory). "slide" and "bcast" gather
// a tile's outputs in shared memory before coalesced stores; "reg" stores
// each thread's R neighbouring outputs straight to device memory, which
// measured faster for it. "reg" and "slide" run a persistent grid of at
// most the blocks the card holds at once, so taps load once a block;
// "bcast" (taps in shared memory) runs one block a tile, which measured
// faster for it (PERF.md).
// Tiles are sized by the host so the grid fills the card (2 x 132 blocks
// where there are enough outputs); "reg" takes tiles of about three
// periods a thread, the fastest in a sweep on the H100. Tile bases are
// int64 and offsets inside a tile int32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "geometry.cuh"
#include "mac.cuh"
#include "pipeline.cuh"

namespace {

using mr::mac;
using mr::widen;
using namespace mr::polyphase;
using namespace mr::pipe;
using mr::kMaxGridX;
using mr::launch_kernel;
using mr::round16;

constexpr int kErrTooLarge = -1;
constexpr int kErrBadPlan = -2;

// The staged (shared-memory) types of a (signal, tap) pair and its
// accumulator: the types themselves, but bf16 staged as float, int8 summed
// in int32, and a narrow read against float taps widened to float.
template <typename X, typename W> struct Mode {
  using XStage = X;
  using WStage = W;
  using Acc = X;
};
struct FloatMode {
  using XStage = float;
  using WStage = float;
  using Acc = float;
};
template <> struct Mode<__nv_bfloat16, __nv_bfloat16> : FloatMode {};
template <> struct Mode<int8_t, int8_t> {
  using XStage = int8_t;
  using WStage = int8_t;
  using Acc = int32_t;
};
template <> struct Mode<int16_t, float> : FloatMode {};
template <> struct Mode<uint8_t, float> : FloatMode {};
template <> struct Mode<__half, float> : FloatMode {};
template <> struct Mode<int8_t, float> : FloatMode {};
template <> struct Mode<__nv_bfloat16, float> : FloatMode {};
// integer words: summed as unsigned words, which wrap (store reinterprets)
template <> struct Mode<int32_t, int32_t> {
  using XStage = uint32_t;
  using WStage = uint32_t;
  using Acc = uint32_t;
};
template <> struct Mode<int64_t, int64_t> {
  using XStage = uint64_t;
  using WStage = uint64_t;
  using Acc = uint64_t;
};
// a real sample (a narrow read widened to float) against a complex tap
template <typename W> struct RealSampleMode {
  using XStage = typename mr::Real<W>::type;
  using WStage = W;
  using Acc = W;
};
template <> struct Mode<float, float2> : RealSampleMode<float2> {};
template <> struct Mode<double, double2> : RealSampleMode<double2> {};
template <> struct Mode<int16_t, float2> : RealSampleMode<float2> {};
template <> struct Mode<uint8_t, float2> : RealSampleMode<float2> {};
template <> struct Mode<__half, float2> : RealSampleMode<float2> {};
template <> struct Mode<int8_t, float2> : RealSampleMode<float2> {};
template <> struct Mode<__nv_bfloat16, float2> : RealSampleMode<float2> {};

// The register variant's outputs per thread R and tap padding E (U = T+E
// registers a tap vector), and the broadcast variant's outputs per thread:
// by the size of a staged tap and sample (geometry.cuh).
// The register variant's blocks an SM must hold: 2 caps int8 and float64
// (with float64 taps) at 128 registers a thread, which ran them faster on
// the H100; the other modes spill under that cap and ran slower (PERF.md).
template <typename X, typename W> struct Shape {
  using XS = typename Mode<X, W>::XStage;
  using WS = typename Mode<X, W>::WStage;
  static constexpr int kR = reg_r(sizeof(WS));
  static constexpr int kE = reg_e(sizeof(WS));
  static constexpr int kRegMinBlocks =
      sizeof(XS) == 1 ||
              (std::is_same<X, double>::value && std::is_same<W, double>::value)
          ? 2
          : 1;
  static constexpr int kBcastR = bcast_r(sizeof(XS));
  static constexpr int kSlideR = kBcastR;
};

template <typename T>
__device__ __forceinline__ void store(T* p, T v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
// a wrapped word's bits, as the signed word the tensor holds
__device__ __forceinline__ void store(int32_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
__device__ __forceinline__ void store(int64_t* p, uint64_t v) {
  *reinterpret_cast<uint64_t*>(p) = v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

// Stage xext[e0, e0 + n) of one channel into ``raw`` as raw samples; returns
// the index in raw of sample e0 (the same in every thread). Where the span
// lies in x and the channel's x is 16-byte aligned, threads issue 16-byte
// cp.async copies from the 16-byte boundary at or below it (bytes past x's
// end are filled with zeros) and return at once, so the copy overlaps what
// the block does next; a span that reaches into the history is stored
// synchronously.
template <typename X>
__device__ __forceinline__ int stage_raw(X* raw, const X* hc, const X* xc,
                                         int H, int64_t xlen, int64_t e0,
                                         int n) {
  if (e0 >= H && ((uintptr_t)xc & 15) == 0) {
    const char* base = reinterpret_cast<const char*>(xc);
    const int64_t b0 = (e0 - H) * (int64_t)sizeof(X);
    const int64_t a0 = b0 & ~(int64_t)15;
    const int64_t end = xlen * (int64_t)sizeof(X);
    const int chunks = (int)((b0 - a0 + (int64_t)n * sizeof(X) + 15) / 16);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int64_t a = a0 + 16 * (int64_t)c;
      const int64_t left = end - a;
      const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
      cp_async16(reinterpret_cast<char*>(raw) + 16 * c, base + (bytes ? a : 0),
                 bytes);
    }
    return (int)((b0 - a0) / (int64_t)sizeof(X));
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t e = e0 + i;
    raw[i] = e < H ? hc[e] : (e - H < xlen ? xc[e - H] : X{});
  }
  return 0;
}

// The clock split of the reg and reg.tma kernels (pipeline.cuh's macros,
// built with -DMR_CLOCKS by tools/polyphase_runs.py; mr_polyphase_clocks).
enum ClockPart {
  kClkTaps = 0,     // the prologue: taps into registers, barriers set up
  kClkStage = 1,    // staging issued (reg: cp.async; reg.tma: the producer)
  kClkWait = 2,     // waiting for a tile's samples (and reg's barrier)
  kClkDot = 3,      // the multiply-adds and their shared reads
  kClkStore = 4,    // the stores
  kClkRelease = 5,  // the tile released (reg: its trailing barrier)
  kClkFree = 6,     // reg.tma's producer waiting for a free buffer
  kClockParts = 7
};
#ifdef MR_CLOCKS
__device__ unsigned long long mr_clocks[kClockParts];
#endif

// ---------------------------------------------------------------- general

// Entry is a tag type named after the extern "C" entry point
// (entry::mr_polyphase_<name>), so a profiler trace names each kernel by
// its entry; it takes no part in the code.
template <typename Entry, typename X, typename W, typename Out,
          bool kBankInSmem>
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
      smem_raw + (kBankInSmem ? round16((size_t)T * L * sizeof(WStage)) : 0));
  if (kBankInSmem) {
    // published by the __syncthreads below, before any use
    for (int i = threadIdx.x; i < T * L; i += blockDim.x)
      s_bank[i] = widen<WStage>(bank[i]);
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
        s_x[i] = widen<XStage>(e < H ? hc[e] : xc[e - H]);
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
          for (int t = 0; t < T; ++t)
            acc = mac(acc, w[t], widen<WStage>(b[t * L]));
        }
        store(yc + n0 + j, acc);
      }
    }
  }
}

template <typename Entry, typename X, typename W, typename Out>
int launch_general(const void* x, const void* hist, const void* bank, void* y,
                   int64_t C, int64_t xlen, int T, int L, int M, int phi0,
                   int64_t d0, int64_t n_out, int tile, int64_t grid_x,
                   cudaStream_t stream) {
  using XStage = typename Mode<X, W>::XStage;
  using WStage = typename Mode<X, W>::WStage;
  bool bank_smem = false;
  if (tile < 1) return kErrBadPlan;
  const int64_t smem = general_smem(T, L, M, tile, sizeof(XStage),
                                    sizeof(WStage), &bank_smem);
  if (smem < 0) return kErrTooLarge;
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  auto kern = bank_smem ? polyphase_kernel<Entry, X, W, Out, true>
                        : polyphase_kernel<Entry, X, W, Out, false>;
  const dim3 grid((unsigned)grid_x, (unsigned)(C < kMaxGridY ? C : kMaxGridY));
  return launch_kernel(kern, grid, kThreads, smem, false, stream,
                       (const X*)x, (const X*)hist, (const W*)bank, (Out*)y,
                       C, xlen, T, L, M, phi0, d0, n_out, tile, n_tiles);
}

// -------------------------------------------------------------------- reg

template <typename Entry, typename X, typename W, typename Out, int T>
__global__ void __launch_bounds__(kRegThreads, Shape<X, W>::kRegMinBlocks)
polyphase_reg(const X* __restrict__ x, const X* __restrict__ hist,
              const W* __restrict__ bank, Out* __restrict__ y, int64_t C,
              int64_t xlen, int L, int M, int phi0, int64_t d0,
              int64_t n_out, RegGeom g, int64_t n_tiles) {
  using XS = typename Mode<X, W>::XStage;
  using WS = typename Mode<X, W>::WStage;
  using Acc = typename Mode<X, W>::Acc;
  constexpr int R = Shape<X, W>::kR;
  constexpr int U = T + Shape<X, W>::kE;
  constexpr bool kInt8 = sizeof(XS) == 1;
  constexpr int U4 = (U + 3) / 4;  // int8: packed words of a tap vector
  MR_CLOCK_BEGIN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  X* const raw0 = reinterpret_cast<X*>(smem_raw);
  X* const raw1 = reinterpret_cast<X*>(smem_raw + raw_bytes(g.span, sizeof(X)));
  const int H = T - 1;
  const int r0 = phi0 - 1;  // every tile starts at a period: same phase
  const int tid = threadIdx.x;
  const bool active = tid < g.G * g.KT;
  const int gi = active ? tid % g.G : 0;
  const int kl = tid / g.G;
  const int j0 = gi * R;  // first output of the group in a period
  const int nvalid = g.Qp - j0 < R ? g.Qp - j0 : R;
  const int base = (int)(((int64_t)r0 + (int64_t)j0 * M) / L);

  // Output j0 + r reads window words base + d_r + t; its taps go to
  // registers shifted by d_r, so all R dots read words base + s, s < U.
  WS B[kInt8 ? 1 : R][kInt8 ? 1 : U];
  int32_t Bp[kInt8 ? R : 1][kInt8 ? U4 : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t tr = r0 + (int64_t)(j0 + r) * M;
    const int ph = (int)(tr % L);
    const int d = (int)(tr / L) - base;
    const bool ok = active && r < nvalid;
    if constexpr (kInt8) {
#pragma unroll
      for (int q = 0; q < U4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int t = 4 * q + b - d;
          const int8_t v = ok && t >= 0 && t < T ? bank[t * L + ph] : 0;
          word |= (uint32_t)(uint8_t)v << (8 * b);
        }
        Bp[r][q] = (int32_t)word;
      }
    } else {
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const int t = s - d;
        B[r][s] = ok && t >= 0 && t < T ? widen<WS>(bank[t * L + ph])
                                        : mr::zero<WS>();
      }
    }
  }

  // work item w: channel w / n_tiles, tile w % n_tiles; tile i + 1's span
  // is copied while tile i computes
  auto prefetch = [&](int64_t w, X* buf) {
    const int64_t c = w / n_tiles;
    const int64_t n0 = (w - c * n_tiles) * g.K * g.Qp;
    return stage_raw(buf, hist + c * H, x + c * xlen, H, xlen,
                     d0 - 1 + (r0 + n0 * M) / L, g.span);
  };
  const int64_t total = C * n_tiles;
  int64_t w = blockIdx.x;
  MR_CLOCK(kClkTaps);
  int lead = w < total ? prefetch(w, raw0) : 0;
  cp_async_commit();
  for (int cur = 0; w < total; w += gridDim.x, cur ^= 1) {
    const int lead_next =
        w + gridDim.x < total ? prefetch(w + gridDim.x, cur ? raw0 : raw1)
                              : 0;
    cp_async_commit();
    MR_CLOCK(kClkStage);
    cp_async_wait_one();  // tile w has landed
    __syncthreads();
    MR_CLOCK(kClkWait);
    const int64_t c = w / n_tiles;
    const int64_t n0 = (w - c * n_tiles) * g.K * g.Qp;
    const X* buf = cur ? raw1 : raw0;  // 16-byte aligned
    const X* s_x = buf + lead;
    Out* const yc = y + c * n_out + n0;
    const int nt = (int)(n_out - n0 < (int64_t)g.K * g.Qp
                             ? n_out - n0 : (int64_t)g.K * g.Qp);
    for (int k = kl; active && k < g.K; k += g.KT) {
      const int jt = k * g.Qp + j0;  // tile-relative output
      if (jt >= nt) break;
      const int a = k * g.Pp + base;
      Acc acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = mr::zero<Acc>();
      if constexpr (kInt8) {
        // whole words of the aligned buffer, shifted into place
        const int ab = lead + a;
        const int32_t* w32 = reinterpret_cast<const int32_t*>(buf) + (ab >> 2);
        const int sh = 8 * (ab & 3);
        int32_t lo = w32[0];
#pragma unroll
        for (int q = 0; q < U4; ++q) {
          const int32_t hi = w32[q + 1];
          const int32_t v = (int32_t)__funnelshift_r((uint32_t)lo,
                                                     (uint32_t)hi, sh);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = __dp4a(v, Bp[r][q], acc[r]);
          lo = hi;
        }
      } else {
        const X* wx = s_x + a;
#pragma unroll
        for (int s = 0; s < U; ++s) {
          const XS v = widen<XS>(wx[s]);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = mac(acc[r], v, B[r][s]);
        }
      }
      MR_CLOCK(kClkDot);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nvalid && jt + r < nt) store(yc + jt + r, acc[r]);
      MR_CLOCK(kClkStore);
    }
    __syncthreads();  // buf is read before the next prefetch refills it
    MR_CLOCK(kClkRelease);
    lead = lead_next;
  }
  MR_CLOCK_END;
}

template <typename Entry, typename X, typename W, typename Out, int T>
int launch_reg_t(const void* x, const void* hist, const void* bank, void* y,
                 int64_t C, int64_t xlen, int L, int M, int phi0, int64_t d0,
                 int64_t n_out, int K, int64_t grid_x, cudaStream_t stream) {
  RegGeom g;
  if (reg_geom(T, L, M, K, Shape<X, W>::kR, Shape<X, W>::kE, sizeof(X),
               &g) != 0)
    return kErrBadPlan;
  const int64_t n_tiles = (n_out + (int64_t)K * g.Qp - 1) / ((int64_t)K * g.Qp);
  if (C * n_tiles < grid_x) return kErrBadPlan;
  return launch_kernel(polyphase_reg<Entry, X, W, Out, T>, (unsigned)grid_x,
                       g.block, g.smem, true, stream, (const X*)x,
                       (const X*)hist, (const W*)bank, (Out*)y, C, xlen, L,
                       M, phi0, d0, n_out, g, n_tiles);
}

// ---------------------------------------------------------------- reg.tma

// The modes the producer-fed variant serves: float32 samples against
// float32 taps (any store type).
template <typename X, typename W> struct TmaMode {
  static constexpr bool kOn =
      std::is_same<X, float>::value && std::is_same<W, float>::value;
  static constexpr int kV = kTmaV;  // samples a 16-byte word
};

// "reg"'s outputs, taps and periods, fed by a ring of ``stages`` buffers of
// ``nb`` samples. The last warp is the producer: for each work item (as in
// "reg": channel w / n_tiles, tile w % n_tiles, the block's items in turn)
// it waits for a free buffer, stores by hand what no copy can bring (words
// before x, from the history or zeros; the last partial word of x and zeros
// past x's end) and starts one bulk copy of the rest, 16-byte aligned at
// both ends. Buffer word 0 is xext sample d0 - 1 + tile * K * Pp - lead,
// lead = (d0 - 1 - H) mod V: with Pp a multiple of V and every channel's x
// 16-byte aligned, each thread's window starts (lead + base) mod V words
// into a 16-byte word in every period of every tile, so its taps are
// stored shifted by that too (UA registers an output, zeros outside) and
// it reads UA / V aligned 16-byte words a period. The sums run in reg's
// order, zero terms aside: each output equals reg's bit for bit.
template <typename Entry, typename X, typename W, typename Out, int T>
__global__ void __launch_bounds__(kRegTarget + 32, 2)
polyphase_reg_tma(const X* __restrict__ x, const X* __restrict__ hist,
                  const W* __restrict__ bank, Out* __restrict__ y, int64_t C,
                  int64_t xlen, int L, int M, int phi0, int64_t d0,
                  int64_t n_out, RegGeom g, int stages, int nb,
                  int64_t n_tiles) {
  using XS = typename Mode<X, W>::XStage;
  using WS = typename Mode<X, W>::WStage;
  using Acc = typename Mode<X, W>::Acc;
  constexpr int R = Shape<X, W>::kR;
  constexpr int V = TmaMode<X, W>::kV;
  constexpr int UA = tma_words(T, Shape<X, W>::kE, V);
  MR_CLOCK_BEGIN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* const empty = full + kTmaMaxStages;
  X* const ring = reinterpret_cast<X*>(smem_raw + kTmaBarBytes);
  const int H = T - 1;
  const int r0 = phi0 - 1;  // every tile starts at a period: same phase
  const int tid = threadIdx.x;
  const int consumers = g.block;  // whole warps; the producer warp after
  const int lead = (int)(((d0 - 1 - H) % V + V) % V);
  const int64_t total = C * n_tiles;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, consumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= consumers) {  // the producer warp
    const int lane = tid - consumers;
    const int64_t step = (int64_t)g.K * g.Pp;  // samples a tile moves on
    int stage = 0;
    uint32_t phase = 0;
    MR_CLOCK(kClkTaps);
    for (int64_t w = blockIdx.x; w < total; w += gridDim.x) {
      mbar_wait(empty + stage, phase ^ 1);
      MR_CLOCK(kClkFree);
      const int64_t c = w / n_tiles;
      const int64_t start = d0 - 1 + (w - c * n_tiles) * step - lead;
      const X* hc = hist + c * H;
      const X* xc = x + c * xlen;
      X* const buf = ring + (size_t)stage * nb;
      // buffer word j is xext sample start + j: [0, jx0) lies before x,
      // [jx0, jx1) in x, of which [jx0, jc) is copied
      const int64_t a0 = H - start, a1 = H + xlen - start;
      const int jx0 = (int)(a0 < 0 ? 0 : (a0 > nb ? nb : a0));
      const int jx1 = (int)(a1 < jx0 ? jx0 : (a1 > nb ? nb : a1));
      const int jc = jx0 + ((jx1 - jx0) & ~(V - 1));
      for (int j = lane; j < jx0; j += 32) {
        const int64_t e = start + j;
        buf[j] = e >= 0 ? hc[e] : X{};
      }
      for (int j = jc + lane; j < nb; j += 32)
        buf[j] = j < jx1 ? xc[start + j - H] : X{};
      __syncwarp();
      if (lane == 0) {
        const uint32_t bytes = (uint32_t)(jc - jx0) * sizeof(X);
        mbar_arrive_tx(full + stage, bytes);
        if (bytes) bulk_copy(buf + jx0, xc + (start + jx0 - H), bytes,
                             full + stage);
      } else {
        mbar_arrive(full + stage);
      }
      MR_CLOCK(kClkStage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    MR_CLOCK_END;
    return;
  }

  const bool active = tid < g.G * g.KT;
  const int gi = active ? tid % g.G : 0;
  const int kl = tid / g.G;
  const int j0 = gi * R;  // first output of the group in a period
  const int nvalid = g.Qp - j0 < R ? g.Qp - j0 : R;
  const int base = (int)(((int64_t)r0 + (int64_t)j0 * M) / L);
  const int sh = (lead + base) % V;          // the same in every period
  const int q0 = (lead + base - sh) / V;     // period 0's first word
  const int pq = g.Pp / V;                   // 16-byte words a period

  // Output j0 + r reads window words base + d_r + t, which are words
  // sh + d_r + t of this thread's read: its taps go there, zeros elsewhere.
  WS B[R][UA];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t tr = r0 + (int64_t)(j0 + r) * M;
    const int ph = (int)(tr % L);
    const int d = (int)(tr / L) - base + sh;
    const bool ok = active && r < nvalid;
#pragma unroll
    for (int s = 0; s < UA; ++s) {
      const int t = s - d;
      B[r][s] = ok && t >= 0 && t < T ? widen<WS>(bank[t * L + ph])
                                      : mr::zero<WS>();
    }
  }
  MR_CLOCK(kClkTaps);

  int stage = 0;
  uint32_t phase = 0;
  for (int64_t w = blockIdx.x; w < total; w += gridDim.x) {
    mbar_wait(full + stage, phase);
    MR_CLOCK(kClkWait);
    const int64_t c = w / n_tiles;
    const int64_t n0 = (w - c * n_tiles) * g.K * g.Qp;
    const float4* buf =
        reinterpret_cast<const float4*>(ring + (size_t)stage * nb) + q0;
    Out* const yc = y + c * n_out + n0;
    const int nt = (int)(n_out - n0 < (int64_t)g.K * g.Qp
                             ? n_out - n0 : (int64_t)g.K * g.Qp);
    for (int k = kl; active && k < g.K; k += g.KT) {
      const int jt = k * g.Qp + j0;  // tile-relative output
      if (jt >= nt) break;
      const float4* wq = buf + k * pq;
      Acc acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = mr::zero<Acc>();
#pragma unroll
      for (int q = 0; q < UA / V; ++q) {
        const float4 v4 = wq[q];
        const XS v[V] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int r = 0; r < R; ++r)
            acc[r] = mac(acc[r], v[i], B[r][q * V + i]);
      }
      MR_CLOCK(kClkDot);
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nvalid && jt + r < nt) store(yc + jt + r, acc[r]);
      MR_CLOCK(kClkStore);
    }
    __syncwarp();  // the warp's reads of the buffer are done
    if ((tid & 31) == 0) mbar_arrive(empty + stage);
    MR_CLOCK(kClkRelease);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  MR_CLOCK_END;
}

template <typename Entry, typename X, typename W, typename Out, int T>
int launch_tma_t(const void* x, const void* hist, const void* bank, void* y,
                 int64_t C, int64_t xlen, int L, int M, int phi0, int64_t d0,
                 int64_t n_out, int K, int stages, int64_t grid_x,
                 cudaStream_t stream) {
  if constexpr (!TmaMode<X, W>::kOn) {
    return kErrBadPlan;
  } else {
    constexpr int V = TmaMode<X, W>::kV;
    constexpr int R = Shape<X, W>::kR;
    RegGeom g;
    if (reg_geom(T, L, M, K, R, Shape<X, W>::kE, sizeof(X), &g) != 0 ||
        g.block > kRegTarget || stages < 2 || stages > kTmaMaxStages ||
        g.Pp % V != 0 || ((uintptr_t)x & 15) != 0 || (C > 1 && xlen % V))
      return kErrBadPlan;
    const int nb = (int)tma_buffer(K, g.Pp, reg_base_max(L, M, g.G, R),
                                   tma_words(T, Shape<X, W>::kE, V), V);
    const size_t smem = kTmaBarBytes + (size_t)stages * nb * sizeof(X);
    if (smem > kSmemLimit) return kErrTooLarge;
    const int64_t n_tiles =
        (n_out + (int64_t)K * g.Qp - 1) / ((int64_t)K * g.Qp);
    if (C * n_tiles < grid_x) return kErrBadPlan;
    return launch_kernel(polyphase_reg_tma<Entry, X, W, Out, T>,
                         (unsigned)grid_x, g.block + 32, smem, true, stream,
                         (const X*)x, (const X*)hist, (const W*)bank,
                         (Out*)y, C, xlen, L, M, phi0, d0, n_out, g, stages,
                         nb, n_tiles);
  }
}

// ------------------------------------------------------------------ slide

template <typename Entry, typename X, typename W, typename Out, int T>
__global__ void __launch_bounds__(kSlideThreads)
polyphase_slide(const X* __restrict__ x, const X* __restrict__ hist,
                const W* __restrict__ bank, Out* __restrict__ y, int64_t C,
                int64_t xlen, int L, int M, int phi0, int64_t d0,
                int64_t n_out, SlideGeom g, int64_t n_tiles) {
  using XS = typename Mode<X, W>::XStage;
  using WS = typename Mode<X, W>::WStage;
  using Acc = typename Mode<X, W>::Acc;
  constexpr int R = Shape<X, W>::kSlideR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  X* const raw0 = reinterpret_cast<X*>(smem_raw);
  X* const raw1 = reinterpret_cast<X*>(smem_raw + raw_bytes(g.span, sizeof(X)));
  Out* const s_y = reinterpret_cast<Out*>(smem_raw + g.out_offset);
  const int H = T - 1;
  const int r0 = phi0 - 1;  // every tile starts at a period: same phase
  const int tid = threadIdx.x;
  const bool active = tid < g.Q * g.KG;
  const int c = active ? tid % g.Q : 0;  // phase class
  const int kg = tid / g.Q;
  const int64_t tc = r0 + (int64_t)c * M;
  const int ph = (int)(tc % L);
  const int base = (int)(tc / L);  // 0 or 1
  WS b[T];
#pragma unroll
  for (int t = 0; t < T; ++t) b[t] = widen<WS>(bank[t * L + ph]);

  auto prefetch = [&](int64_t w, X* buf) {
    const int64_t ch = w / n_tiles;
    const int64_t n0 = (w - ch * n_tiles) * g.K * g.Q;
    return stage_raw(buf, hist + ch * H, x + ch * xlen, H, xlen,
                     d0 - 1 + (r0 + n0 * M) / L, g.span);
  };
  const int64_t total = C * n_tiles;
  int64_t w = blockIdx.x;
  int lead = w < total ? prefetch(w, raw0) : 0;
  cp_async_commit();
  for (int cur = 0; w < total; w += gridDim.x, cur ^= 1) {
    const int lead_next =
        w + gridDim.x < total ? prefetch(w + gridDim.x, cur ? raw0 : raw1)
                              : 0;
    cp_async_commit();
    cp_async_wait_one();  // tile w has landed
    __syncthreads();
    const int64_t ch = w / n_tiles;
    const int64_t n0 = (w - ch * n_tiles) * g.K * g.Q;
    const X* s_x = (cur ? raw1 : raw0) + lead + base;
    const int nt = (int)(n_out - n0 < (int64_t)g.K * g.Q
                             ? n_out - n0 : (int64_t)g.K * g.Q);
    // periods kb .. kb + R - 1 of class c: output (kb + r) * Q + c reads
    // window words kb + r + t
    for (int kb = kg * R; active && kb * g.Q < nt; kb += g.KG * R) {
      Acc acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = mr::zero<Acc>();
#pragma unroll
      for (int j = 0; j < T + R - 1; ++j) {
        const XS v = widen<XS>(s_x[kb + j]);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (j - r >= 0 && j - r < T) acc[r] = mac(acc[r], v, b[j - r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int jt = (kb + r) * g.Q + c;
        if (jt < nt) store(s_y + jt, acc[r]);
      }
    }
    __syncthreads();  // the raw buffer is read, s_y written
    Out* yc = y + ch * n_out + n0;
    for (int i = tid; i < nt; i += blockDim.x) yc[i] = s_y[i];
    lead = lead_next;
  }
}

template <typename Entry, typename X, typename W, typename Out, int T>
int launch_slide_t(const void* x, const void* hist, const void* bank, void* y,
                   int64_t C, int64_t xlen, int L, int M, int phi0,
                   int64_t d0, int64_t n_out, int K, int64_t grid_x,
                   cudaStream_t stream) {
  SlideGeom g;
  if (slide_geom(T, L, M, K, Shape<X, W>::kSlideR, sizeof(X), sizeof(Out),
                 &g) != 0)
    return kErrBadPlan;
  const int64_t n_tiles = (n_out + (int64_t)K * g.Q - 1) / ((int64_t)K * g.Q);
  if (C * n_tiles < grid_x) return kErrBadPlan;
  return launch_kernel(polyphase_slide<Entry, X, W, Out, T>,
                       (unsigned)grid_x, g.block, g.smem, true, stream,
                       (const X*)x, (const X*)hist, (const W*)bank, (Out*)y,
                       C, xlen, L, M, phi0, d0, n_out, g, n_tiles);
}

// ------------------------------------------------------------------ bcast

template <typename Entry, typename X, typename W, typename Out>
__global__ void __launch_bounds__(kBcastThreads)
polyphase_bcast(const X* __restrict__ x, const X* __restrict__ hist,
                const W* __restrict__ bank, Out* __restrict__ y, int64_t C,
                int64_t xlen, int T, int M, int64_t d0, int64_t n_out,
                int tile, BcastGeom g, int64_t n_tiles) {
  using XS = typename Mode<X, W>::XStage;
  using WS = typename Mode<X, W>::WStage;
  using Acc = typename Mode<X, W>::Acc;
  constexpr int R = Shape<X, W>::kBcastR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WS* s_b = reinterpret_cast<WS*>(smem_raw);
  X* const raw0 = reinterpret_cast<X*>(smem_raw + g.bank_bytes);
  X* const raw1 = reinterpret_cast<X*>(smem_raw + g.bank_bytes + g.raw);
  XS* s_x = reinterpret_cast<XS*>(smem_raw + g.x_offset);
  Out* s_y = reinterpret_cast<Out*>(smem_raw + g.out_offset);
  const int H = T - 1;
  const int tid = threadIdx.x;
  // bank[t] at row t % M, column t / M, zeros after; published by the
  // first sync below
  for (int i = tid; i < g.rows * g.TQ; i += blockDim.x) {
    const int t = (i % g.TQ) * M + i / g.TQ;
    s_b[i] = t < T ? widen<WS>(bank[t]) : mr::zero<WS>();
  }

  // work item w: channel w / n_tiles, tile w % n_tiles; tile i + 1's span
  // is copied while tile i computes
  auto prefetch = [&](int64_t w, X* buf) {
    const int64_t c = w / n_tiles;
    const int64_t n0 = (w - c * n_tiles) * tile;
    return stage_raw(buf, hist + c * H, x + c * xlen, H, xlen,
                     d0 - 1 + n0 * M, g.span);  // L = 1: every phase is 1
  };
  const int64_t total = C * n_tiles;
  int64_t w = blockIdx.x;
  int lead = w < total ? prefetch(w, raw0) : 0;
  cp_async_commit();
  for (int cur = 0; w < total; w += gridDim.x, cur ^= 1) {
    const int lead_next =
        w + gridDim.x < total ? prefetch(w + gridDim.x, cur ? raw0 : raw1)
                              : 0;
    cp_async_commit();
    cp_async_wait_one();  // tile w has landed
    __syncthreads();      // ... for every thread; s_x is free
    // split by phase; every column is written (zeros past the span), so
    // the zero taps of a padded row only ever meet finite samples
    const X* s_raw = (cur ? raw1 : raw0) + lead;
    for (int idx = tid; idx < g.rows * g.SP; idx += blockDim.x) {
      const int p = idx / g.SP;
      const int i = (idx - p * g.SP) * M + p;
      s_x[idx] = i < g.span ? widen<XS>(s_raw[i]) : mr::zero<XS>();
    }
    __syncthreads();

    const int64_t c = w / n_tiles;
    const int64_t n0 = (w - c * n_tiles) * tile;
    const int nt = (int)(n_out - n0 < tile ? n_out - n0 : tile);
    for (int j0 = tid * R; j0 < nt; j0 += blockDim.x * R) {
      Acc acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = mr::zero<Acc>();
      // output j0 + r, tap t = q*M + p reads row p, column j0 + r + q
      for (int p = 0; p < g.rows; ++p) {
        const int Tp = (T - p + M - 1) / M;  // this row's taps, then zeros
        const XS* wp = s_x + p * g.SP + j0;
        const WS* b = s_b + p * g.TQ;
        XS win[R];  // win[(q + i) % R] holds wp[q + i]
#pragma unroll
        for (int i = 0; i < R - 1; ++i) win[i] = wp[i];
        for (int q0 = 0; q0 < Tp; q0 += R) {
#pragma unroll
          for (int u = 0; u < R; ++u) {
            win[(u + R - 1) % R] = wp[q0 + u + R - 1];
            const WS tap = b[q0 + u];
#pragma unroll
            for (int r = 0; r < R; ++r)
              acc[r] = mac(acc[r], win[(u + r) % R], tap);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + r < nt) store(s_y + j0 + r, acc[r]);
    }
    __syncthreads();  // s_y written
    Out* yc = y + c * n_out + n0;
    for (int i = tid; i < nt; i += blockDim.x) yc[i] = s_y[i];
    lead = lead_next;
  }
}

template <typename Entry, typename X, typename W, typename Out>
int launch_bcast(const void* x, const void* hist, const void* bank, void* y,
                 int64_t C, int64_t xlen, int T, int L, int M, int phi0,
                 int64_t d0, int64_t n_out, int tile, int64_t grid_x,
                 cudaStream_t stream) {
  using XS = typename Mode<X, W>::XStage;
  using WS = typename Mode<X, W>::WStage;
  BcastGeom g;
  if (L != 1 || phi0 != 1 ||
      bcast_geom(T, M, tile, Shape<X, W>::kBcastR, sizeof(X), sizeof(XS),
                 sizeof(WS), sizeof(Out), &g) != 0)
    return kErrBadPlan;
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  if (C * n_tiles < grid_x) return kErrBadPlan;
  return launch_kernel(polyphase_bcast<Entry, X, W, Out>, (unsigned)grid_x,
                       kBcastThreads, g.smem, false, stream, (const X*)x,
                       (const X*)hist, (const W*)bank, (Out*)y, C, xlen, T, M,
                       d0, n_out, tile, g, n_tiles);
}

// ------------------------------------------------------------------ entry

template <typename Entry, typename X, typename W, typename Out>
int launch(const void* x, const void* hist, const void* bank, void* y,
           int64_t C, int64_t xlen, int T, int L, int M, int phi0,
           int64_t d0, int64_t n_out, int variant, int tile, int64_t grid_x,
           int depth, void* stream) {
  if (C <= 0 || n_out <= 0) return cudaSuccess;
  if (grid_x < 1 || grid_x > kMaxGridX) return kErrBadPlan;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case kGeneral:
      return launch_general<Entry, X, W, Out>(x, hist, bank, y, C, xlen, T, L,
                                              M, phi0, d0, n_out, tile,
                                              grid_x, s);
    case kReg:
      if (T == 24)
        return launch_reg_t<Entry, X, W, Out, 24>(
            x, hist, bank, y, C, xlen, L, M, phi0, d0, n_out, tile, grid_x, s);
      if (T == 37)
        return launch_reg_t<Entry, X, W, Out, 37>(
            x, hist, bank, y, C, xlen, L, M, phi0, d0, n_out, tile, grid_x, s);
      return kErrBadPlan;
    case kRegTma:
      if (T == 24)
        return launch_tma_t<Entry, X, W, Out, 24>(x, hist, bank, y, C, xlen,
                                                  L, M, phi0, d0, n_out, tile,
                                                  depth, grid_x, s);
      return kErrBadPlan;
    case kSlide:
      if (T == 24)
        return launch_slide_t<Entry, X, W, Out, 24>(
            x, hist, bank, y, C, xlen, L, M, phi0, d0, n_out, tile, grid_x, s);
      if (T == 37)
        return launch_slide_t<Entry, X, W, Out, 37>(
            x, hist, bank, y, C, xlen, L, M, phi0, d0, n_out, tile, grid_x, s);
      return kErrBadPlan;
    case kBcast:
      return launch_bcast<Entry, X, W, Out>(x, hist, bank, y, C, xlen, T, L,
                                            M, phi0, d0, n_out, tile, grid_x,
                                            s);
    default:
      return kErrBadPlan;
  }
}

}  // namespace

extern "C" {

// y (C, n_out) = polyphase(x (C, xlen), hist (C, T-1), bank (T, L)); x and
// hist of the signal type, bank of the tap type, all contiguous, on the
// current device, complex ones 8- or 16-byte aligned. The caller guarantees
// that every window lies inside [history ++ x]: d0 >= 1, 1 <= phi0 <= L and
// d0 + ((phi0-1) + (n_out-1)*M) / L <= xlen. ``variant`` (0 general, 1 reg,
// 2 bcast, 3 slide, 4 reg.tma), ``tile`` (general and bcast: outputs; reg,
// reg.tma and slide: periods), ``grid_x`` and ``depth`` (reg.tma's ring
// buffers; ignored by the others) come from the host's plan
// (mr_plan.cpp, through ops/cuda/polyphase.py plan()).
// Returns a cudaError_t code, kErrTooLarge when one tile's span cannot fit
// in shared memory, or kErrBadPlan when the variant does not take the
// geometry. One entry per (signal, tap, output) triple the modes use:
// mr_polyphase_<name>.
#define MR_POLYPHASE(name, X, W, Out)                                        \
  namespace entry {                                                          \
  struct mr_polyphase_##name;                                                \
  }                                                                          \
  int mr_polyphase_##name(const void* x, const void* hist, const void* bank, \
                          void* y, int64_t C, int64_t xlen, int T, int L,    \
                          int M, int phi0, int64_t d0, int64_t n_out,        \
                          int variant, int tile, int64_t grid_x, int depth,  \
                          void* stream) {                                    \
    return launch<entry::mr_polyphase_##name, X, W, Out>(                   \
        x, hist, bank, y, C, xlen, T, L, M, phi0, d0, n_out, variant, tile,  \
        grid_x, depth, stream);                                              \
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
// narrow reads against float32 taps: float32 outputs, and float16 ones
// (the output type of float16 taps with a narrow signal)
MR_POLYPHASE(s16, int16_t, float, float)
MR_POLYPHASE(u8, uint8_t, float, float)
MR_POLYPHASE(f16, __half, float, float)
MR_POLYPHASE(s8f, int8_t, float, float)
MR_POLYPHASE(bf16f, __nv_bfloat16, float, float)
MR_POLYPHASE(s16_f16out, int16_t, float, __half)
MR_POLYPHASE(u8_f16out, uint8_t, float, __half)
MR_POLYPHASE(f16_f16out, __half, float, __half)
MR_POLYPHASE(s8f_f16out, int8_t, float, __half)
MR_POLYPHASE(bf16f_f16out, __nv_bfloat16, float, __half)
// real samples against complex taps, read as stored
MR_POLYPHASE(f32c, float, float2, float2)
MR_POLYPHASE(f64c, double, double2, double2)
MR_POLYPHASE(s16c, int16_t, float2, float2)
MR_POLYPHASE(u8c, uint8_t, float2, float2)
MR_POLYPHASE(f16c, __half, float2, float2)
MR_POLYPHASE(s8c, int8_t, float2, float2)
MR_POLYPHASE(bf16c, __nv_bfloat16, float2, float2)
// integer words, wrapping: int32 (any integer output of 32 bits or fewer)
// and int64
MR_POLYPHASE(i32, int32_t, int32_t, int32_t)
MR_POLYPHASE(i64, int64_t, int64_t, int64_t)

#undef MR_POLYPHASE

#ifdef MR_CLOCKS
// The clock split's sums by ClockPart (kClockParts of them) into ``out``,
// then zeroed; returns a cudaError_t code.
int mr_polyphase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, mr_clocks, sizeof(mr_clocks));
  if (err != cudaSuccess) return err;
  const unsigned long long zeros[kClockParts] = {};
  return cudaMemcpyToSymbol(mr_clocks, zeros, sizeof(mr_clocks));
}
#endif

const char* mr_error_string(int code) {
  if (code == kErrTooLarge) return "tile span exceeds shared memory";
  if (code == kErrBadPlan) return "the variant does not take this plan";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
