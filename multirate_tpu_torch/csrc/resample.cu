// Arbitrary-rate and Farrow resampler for Hopper (sm_90a): float32 (channel-
// and time-major), channel-major float64, complex64 and complex128 signals
// against real or complex tables, real signals against complex tables
// (channel-major), and narrow reads (bfloat16, float16, int16, int8 and
// uint8 samples against float32 tables, channel- and time-major, with
// float32 or float16 stores, and against complex64 tables, channel-major).
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
// A narrow read (stored type XR: __nv_bfloat16, __half, int16_t, int8_t,
// uint8_t) stages each span as stored, so device memory moves 2 or 1 bytes
// a sample, into the same double buffer, and once it has landed widens it
// to float into one more shared buffer (mac.cuh widen, exact), from which
// the unchanged inner loop reads: each output equals the float32 entry's on
// the widened values bit for bit. cp.async copies 4, 8 or 16 bytes, so the
// samples that do not go by 16-byte chunks (the history, rows that are not
// 16-byte aligned) are loaded and stored one by one. A real sample (float,
// double, or a narrow read widened to float) against a complex table
// (float2, double2) sums in the table's type, 2 FMAs a tap (mac.cuh): the
// span moves half a complex span's bytes, and each output is the
// complex-sample entry's bits on the samples cast to complex, up to the
// sign of a zero. Out is the accumulator's type, or __half for the float16
// output of float16 taps (round to nearest even).
//
// Exactness:
// - a tile's base (u0 + n0*delta) / D is formed in 128 bits (__umul64hi):
//   n*delta passes 2^63 near n = 2^19.3 at nphi 1024, rate 0.3. The host
//   keeps u0 + n_out*delta below 2^96, so its top 64 bits divide by nphi;
// - inside a tile, the walk below gives each output's (offset from the
//   tile's first window, phase, 32-bit fraction) of r0 + j*delta exactly,
//   by digit additions with carries; the offsets stay below the span;
// - alpha is the 32-bit remainder converted once and scaled by 2^-32
//   exactly: in float (__uint2float_rn, round to nearest) for float32
//   tables, and exactly in double for float64 and complex128 ones, where
//   the 32-bit remainder is a double with no rounding at all. Either way
//   each output depends only on (r_n, its window), never on its tile:
//   chunked == whole bit for bit in every type.
//
// Design. What held the first design back, on the H100 (PERF.md): loops
// to run-time bounds over T and P+1, a 32-bit division by nphi for every
// output and a 64-bit one for every thread's tile base, tiles of 1,024
// outputs (31 blocks for a 65,536-sample block at 1/2.123456789), a span
// loaded synchronously between two barriers, and taps evaluated again for
// every channel. So:
// - Variants, chosen by the host (mr_plan.cpp, through ops/cuda/
//   resample.py plan()), never after a failure: one compiled for each
//   (T, P+1) pair in use (10 and 2 or 5 for bench.py's bank, 73 and 2 for
//   models.Resampler's design),
//   with both loops unrolled, and "general", the same code with run-time
//   loops. The launcher takes the plan as given and refuses one it cannot
//   run (kErrBadPlan). Every variant does the same arithmetic in the same
//   order, so the plan never changes an output bit.
// - A division-free index walk. One thread forms each tile's base in 128
//   bits (a shift where nphi is a power of two) and shares it. Each thread
//   splits its first output's step (its first output's index times delta),
//   the step to its next output (delta) and the step to its next round of
//   outputs into digits once a launch (quotient by D, phase, 32-bit
//   fraction) and walks its outputs by adding digits with carries: exactly
//   the (offset, phase, fraction) of the division.
// - Taps evaluated once for each output and applied to every channel of
//   the block: channel-major blocks take groups of 8 channels when there
//   are 8 or more (8 accumulators a thread, one tap evaluation); time-major
//   blocks (a lane per channel, 32 channels) evaluate a tile's taps once
//   into shared memory, then each warp reads them as broadcasts.
// - Runs (one-channel blocks). Shared memory, not device memory, bounds
//   the dot: T*(P+1) table words and T window words an output. Lanes on
//   neighbouring outputs (about 2.1 samples apart at 1/2.123456789) load
//   window words 32 apart, which share a bank: 2.8-way conflicts. So each
//   thread runs ``run`` neighbouring outputs and a warp's lanes sit ``run``
//   outputs apart: at run 8 their windows 17 samples apart hit 32 banks,
//   and their phases (3.96 apart an output, -0.3 at 8) cluster, so 8- and
//   16-byte table words need fewer wavefronts. The host picks the least
//   run whose lanes' windows lie within 1/32 sample of an odd number of
//   samples apart, else 1 (plan(); tools/resample_runs.py times every
//   run on the card, PERF.md); a warp gathers its outputs in shared
//   memory and stores them coalesced.
// - Grouped (one channel, float32 table, compiled T = 10, at a rate with a
//   phase-preserving stride; resample_grouped_kernel). Runs still read
//   T*(P+1) = 50 table words an output at P+1 = 5: 5/6 of the dot's
//   shared-memory wavefronts re-read one small table. Outputs a stride of
//   K apart whose step K*delta lies within 2^20 of a multiple of D share
//   their phase (K = 243 at 1/2.123456789: 516.0000087 samples), so a
//   thread runs one progression of them, holds its phase's table words in
//   registers and reads only T window words an output. The host picks the
//   path (plan()): where no stride up to 256 keeps the phase, or the call
//   gives a thread fewer than 8 outputs a tile, the runs above serve it.
//   Its threads also stage the next span (cp.async) and copy the outputs
//   out, across three block barriers a tile: at capture's 2^26-sample call
//   a clock64 split gave the dot 53-56% of the clocks, the staging and its
//   barrier 25-27%, the copy-out 15-16%, and the call 0.194-0.196 ms
//   against its 117.6-us bytes bound (tools/resample_runs.py, PERF.md).
//   Narrow reads and calls of 2-7 channels keep it.
// - Grouped.tma (the grouped path's one-channel float32 calls;
//   resample_grouped_tma_kernel): the same outputs, by the same threads'
//   progressions, digit walk, table registers, Horner and mac order, with
//   the data movement taken off those threads. Each persistent block takes
//   an even share of the call's outputs; one producer warp fills a ring of
//   stages with one bulk copy a tile (cp.async.bulk, completing on the
//   stage's mbarrier; the history and the ends that are not whole 16-byte
//   words stored by its lanes), the consumer warps wait on "full" and
//   release "empty", write a tile's outputs unpadded to an output stage
//   (lanes 7 outputs apart put them, and their windows' first words, on
//   nearly 32 banks) and, after one named barrier among themselves, one
//   idle consumer lane stores the tile with one bulk store, waited on only
//   before that stage is written again. No block barrier is left in the
//   tile loop. Tiles of 8, 12 or 16 outputs a thread, whichever splits a
//   block's share of the call most cheaply (a tile costs about one more
//   output a thread than its work, and a short last tile nearly a whole
//   one: 16 at capture's call, 12 at the 8 M rows), in a ring of 2, two
//   blocks of 288 threads an SM (92 registers): capture's call takes
//   0.1516-0.1522 ms (-22%), ~77% of its bytes bound, and the Farrow 8 M
//   row 0.0278-0.0283 ms (-17%). What bounds it now is no one unit: the
//   arbitrary table's calls (P+1 = 2, 60% fewer multiply-adds) take as long
//   at capture's size, so the dot is mostly hidden and the rest is the
//   memory pipeline (~2.6 TB/s moved of 3.35). The sweep
//   (tools/resample_runs.py --tma) found slower: rings of 3-6 or tiles of
//   20-24 outputs a thread (one block an SM: +20-35%), two outputs of a
//   phase interleaved in one thread (+6%), Horner level by level across the
//   taps (+3%), blocks taking whole tiles rather than even shares (+3% at
//   16 outputs a thread), and a lane multiplier of 8 (+0-9%).
// - Tiles sized by the host so the grid fills the card (2 x 132 work items
//   where there are outputs enough) and a block's shared memory stays near
//   64 KB; blocks persist, at most as many as the card holds at once, and
//   walk work items (channel group, tile). Each item's span (about
//   tile*delta/D + T samples a channel) is staged with cp.async into a
//   double buffer, so item i + 1 loads while item i computes: 16-byte
//   chunks where the span lies in x and the rows are 16-byte aligned,
//   single samples from the history (by index: [history ++ x] is never
//   built in device memory). The table is copied the same way once a block
//   and sits in shared memory when it fits in 96 KB (the compiled variants
//   require it); else the general variant reads it through L1.
// Tried on the H100 and slower (PERF.md): a grid of one block a tile,
// tiles of 256 and 128 outputs, 256 threads a block, the table read
// through L1, nphi fixed at compile time, a channel a lane for
// channel-major groups of 32, and 4 outputs a warp sharing window rows.
//
// Bound: device memory moves sizeof(X) bytes per input and per output; per
// output and channel the kernel reads T window words from shared memory
// and issues T multiply-adds in X, and per output (not per channel) T*(P+1)
// table words (none on the grouped path) and Horner steps. Measured times
// live in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "geometry.cuh"
#include "mac.cuh"
#include "pipeline.cuh"

namespace {

using mr::mac;
using namespace mr::resample;
using namespace mr::pipe;
using mr::gcd;
using mr::kMaxGridX;
using mr::launch_kernel;
using mr::round16;

// The type a stored sample is staged and summed in: itself, or float for a
// narrow read.
template <typename T> struct Staged { using type = T; };
template <> struct Staged<__nv_bfloat16> { using type = float; };
template <> struct Staged<__half> { using type = float; };
template <> struct Staged<int16_t> { using type = float; };
template <> struct Staged<int8_t> { using type = float; };
template <> struct Staged<uint8_t> { using type = float; };

// The accumulator of a staged sample type X against a table of type W: X,
// or the table's complex type for a real sample against complex taps.
template <typename X, typename W> struct Sum { using type = X; };
template <> struct Sum<float, float2> { using type = float2; };
template <> struct Sum<double, double2> { using type = double2; };

constexpr int kErrTooLarge = -1;
constexpr int kErrBadPlan = -2;
constexpr float kTwoPowMinus32 = 2.3283064365386963e-10f;  // exactly 2^-32

// The clock split of the grouped and grouped.tma kernels (pipeline.cuh's
// macros, built with -DMR_CLOCKS by tools/resample_runs.py;
// mr_resample_clocks).
enum ClockPart {
  kClkTable = 0,    // the prologue: the table by phase, barriers set up
  kClkStage = 1,    // staging (grouped: cp.async issued; tma: the producer)
  kClkWait = 2,     // waiting for a tile's samples (grouped: and a barrier)
  kClkDot = 3,      // the outputs: walk, taps, multiply-adds, shared stores
  kClkBarrier = 4,  // the tile's outputs all written (the block's barrier)
  kClkStore = 5,    // the outputs stored (grouped: copied out by threads)
  kClkFree = 6,     // grouped.tma's producer waiting for a free stage
  kClockParts = 7
};
#ifdef MR_CLOCKS
__device__ unsigned long long mr_clocks[kClockParts];
#endif

// (q, r) = divmod(u0 + n0*delta, nphi << 32), exact for a sum below 2^96.
__device__ __forceinline__ void tile_base(uint64_t n0, uint64_t delta,
                                          uint64_t u0, uint32_t nphi,
                                          uint64_t* q, uint64_t* r) {
  const uint64_t lo = n0 * delta;
  uint64_t hi = __umul64hi(n0, delta);
  const uint64_t sum = lo + u0;
  hi += sum < lo;                                // carry
  const uint64_t top = (hi << 32) | (sum >> 32); // the sum >> 32
  const int shift = __ffs(nphi) - 1;  // a shift where nphi is a power of 2
  *q = (nphi & (nphi - 1)) == 0 ? top >> shift : top / nphi;
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

// A step v < 2^52 in digits: v = q*D + phi*2^32 + fr, D = nphi << 32.
struct Digits {
  uint32_t q, phi, fr;
};

// One output's window offset (from its tile's first window), phase and
// 32-bit fraction.
struct Pos {
  uint32_t off, phi, fr;
};

// shift = log2(nphi) when nphi is a power of two, else -1.
__device__ __forceinline__ Digits split(uint64_t v, uint32_t nphi,
                                        int shift) {
  const uint32_t hi = (uint32_t)(v >> 32);  // < 2^20
  Digits d;
  d.q = shift >= 0 ? hi >> shift : hi / nphi;
  d.phi = hi - d.q * nphi;
  d.fr = (uint32_t)v;
  return d;
}

// a + d with carries: the fraction carries into the phase, the phase
// into the offset. Exact while the offset fits 32 bits (it stays inside a
// tile's span).
__device__ __forceinline__ Pos add(Pos a, Digits d, uint32_t nphi) {
  Pos p;
  p.fr = a.fr + d.fr;
  const uint32_t phi = a.phi + d.phi + (p.fr < a.fr);
  const bool wrap = phi >= nphi;
  p.phi = wrap ? phi - nphi : phi;
  p.off = a.off + d.q + wrap;
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

// sum_p c[p * stride] * alpha^p, by Horner from the top coefficient; P1 is
// kP1 when the variant is compiled for it.
template <int kP1, typename W, typename A>
__device__ __forceinline__ W eval_tap(const W* c, int P1, int stride,
                                      A alpha) {
  if constexpr (kP1 > 0) {
    W v = c[(kP1 - 1) * stride];
#pragma unroll
    for (int p = kP1 - 2; p >= 0; --p) v = horner(v, alpha, c[p * stride]);
    return v;
  } else {
    W v = c[(P1 - 1) * stride];
    for (int p = P1 - 2; p >= 0; --p) v = horner(v, alpha, c[p * stride]);
    return v;
  }
}

// N bytes copied asynchronously, the first ``bytes`` of them from gmem and
// the rest zeros (N = 16 bypasses L1).
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(N), "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);  // all but the newest group
}

// One sample, or a zero where !ok: copied asynchronously where cp.async
// takes its size (4, 8 or 16 bytes), else loaded and stored (a narrow
// read's 2- and 1-byte samples), which the barriers before its use publish.
template <typename X>
__device__ __forceinline__ void copy_one(X* dst, const X* src, bool ok) {
  if constexpr (sizeof(X) >= 4) {
    cp_async<sizeof(X)>(dst, src, ok ? (int)sizeof(X) : 0);
  } else {
    *dst = ok ? *src : X{};
  }
}

// Stage xext[e0, e0 + span) of channels g*kCB ... into buf. Channel-major:
// kCB rows of rs samples; channel k's span starts at lead[k] in its row.
// Time-major: span rows of kLanes samples (lead 0). Where the samples lie
// in x and its rows are 16-byte aligned, 16-byte chunks are copied from the
// boundary at or below the first sample (bytes past x's end as zeros);
// elsewhere (the history, unaligned rows) one sample a copy. Channels past
// C and samples past xext's end are zeros.
template <typename X, bool kTM, int kCB>
__device__ __forceinline__ void stage(X* buf, int rs, int* lead, const X* x,
                                      const X* hist, int64_t C, int64_t xlen,
                                      int H, int64_t g, int64_t e0,
                                      int span) {
  constexpr int sz = sizeof(X), V = 16 / sizeof(X);
  const int64_t end = H + xlen;
  if constexpr (kTM) {
    lead[0] = 0;
    if (V > 1 && C % V == 0 && ((uintptr_t)x & 15) == 0) {
      constexpr int kChunks = kLanes / (V > 1 ? V : 1);  // chunks a row
      for (int i = threadIdx.x; i < span * kChunks; i += blockDim.x) {
        const int k = i / kChunks, q = i % kChunks;
        const int64_t cc = g * kLanes + q * V, e = e0 + k;
        X* dst = buf + k * kLanes + q * V;
        if (e < H) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            copy_one(dst + v, cc + v < C ? hist + (cc + v) * H + e : x,
                     cc + v < C);
        } else {
          const bool ok = cc < C && e < end;
          cp_async<16>(dst, ok ? x + (e - H) * C + cc : x, ok ? 16 : 0);
        }
      }
    } else {
      for (int i = threadIdx.x; i < span * kLanes; i += blockDim.x) {
        const int k = i / kLanes, slot = i % kLanes;
        const int64_t cc = g * kLanes + slot, e = e0 + k;
        const bool ok = cc < C && e < end;
        const X* src = !ok ? x : (e < H ? hist + cc * H + e
                                        : x + (e - H) * C + cc);
        copy_one(buf + i, src, ok);
      }
    }
  } else {
#pragma unroll
    for (int slot = 0; slot < kCB; ++slot) {
      const int64_t cc = g * kCB + slot;
      X* row = buf + slot * rs;
      const X* xc = x + cc * xlen;
      if (cc < C && e0 >= H && ((uintptr_t)xc & 15) == 0) {
        const char* base = reinterpret_cast<const char*>(xc);
        const int64_t b0 = (e0 - H) * sz, a0 = b0 & ~(int64_t)15;
        const int64_t bytes_end = xlen * sz;
        const int chunks = (int)((b0 - a0 + (int64_t)span * sz + 15) / 16);
        for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
          const int64_t a = a0 + 16 * (int64_t)c, left = bytes_end - a;
          const int n = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
          cp_async<16>(row + c * V, n ? base + a : base, n);
        }
        lead[slot] = (int)((b0 - a0) / sz);
      } else {
        for (int k = threadIdx.x; k < span; k += blockDim.x) {
          const int64_t e = e0 + k;
          const bool ok = cc < C && e < end;
          const X* src = !ok ? x : (e < H ? hist + cc * H + e
                                          : xc + (e - H));
          copy_one(row + k, src, ok);
        }
        lead[slot] = 0;
      }
    }
  }
}

template <typename XR, typename W, typename Out, bool kTM, int kT, int kP1,
          int kCB, bool kTableInSmem>
__global__ void __launch_bounds__(kTM ? kThreadsTM : kThreadsCM)
resample_kernel(const XR* __restrict__ x, const XR* __restrict__ hist,
                const W* __restrict__ table, Out* __restrict__ y, int64_t C,
                int64_t xlen, int T_, int nphi_, int P1_, uint64_t delta,
                uint64_t u0, int64_t d0, int64_t n_out, int tile, int run,
                int span, int64_t n_tiles, int64_t groups) {
  using A = typename mr::Real<W>::type;
  using X = typename Staged<XR>::type;  // what the dot reads
  using Acc = typename Sum<X, W>::type;   // what it sums in
  constexpr bool kNarrow = !std::is_same<X, XR>::value;
  using mr::narrow;
  const int T = kT > 0 ? kT : T_;
  const int P1 = kP1 > 0 ? kP1 : P1_;
  const uint32_t nphi = (uint32_t)nphi_;
  const int TN = T * nphi_;  // stride between the table's coefficients
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t s_base[2][2];  // (q0, r0) of this item and the next
  size_t at = kTableInSmem ? round16((size_t)P1 * TN * sizeof(W)) : 0;
  // samples between staged rows (channel-major), samples of a buffer, and
  // bytes of one buffer as stored
  const int rs = kTM ? kLanes : row_samples(span, sizeof(XR));
  const int buf_n = rs * (kTM ? span : kCB);
  const size_t buf_bytes = round16((size_t)buf_n * sizeof(XR));
  // span buffer b, addressed from smem_raw so that loads stay shared loads
  auto buf = [&, at](int b) {
    return reinterpret_cast<XR*>(smem_raw + at + b * buf_bytes);
  };
  at += 2 * buf_bytes;
  X* const s_wide = reinterpret_cast<X*>(smem_raw + at);  // narrow reads
  if (kNarrow) at += round16((size_t)buf_n * sizeof(X));
  W* const s_tap = reinterpret_cast<W*>(smem_raw + at);  // time-major
  int* const s_off = reinterpret_cast<int*>(
      smem_raw + at + round16((size_t)tile * T * sizeof(W)));
  Acc* const s_y = reinterpret_cast<Acc*>(smem_raw + at);  // runs
  const int64_t total = n_tiles * groups;
  int64_t w = blockIdx.x;
  if (w >= total) return;
  const W* tb = table;
  if (kTableInSmem) {
    // copied asynchronously, a group of its own before the first span's
    W* s_table = reinterpret_cast<W*>(smem_raw);
    for (int i = threadIdx.x; i < P1 * TN; i += blockDim.x)
      cp_async<sizeof(W)>(s_table + i, table + i, sizeof(W));
    tb = s_table;
  }
  cp_async_commit();
  const int H = T - 1;
  const int tid = (int)threadIdx.x, nth = (int)blockDim.x;
  const int shift = (nphi & (nphi - 1)) == 0 ? __ffs(nphi_) - 1 : -1;
  // a thread's first output (tid*run), the next one, and the first of its
  // next round (a time-major block's taps: run = 1)
  const int lane = tid % 32, warp = tid / 32, log_run = __ffs(run) - 1;
  const Digits d_first = split((uint64_t)tid * run * delta, nphi, shift);
  const Digits d_one = split(delta, nphi, shift);
  const Digits d_round = split((uint64_t)(nth - 1) * run * delta, nphi,
                               shift);

  // work item w: channel group w / n_tiles, tile w % n_tiles
  auto base_of = [&](int64_t item, int slot) {
    uint64_t q, r;
    tile_base((uint64_t)(item % n_tiles) * tile, delta, u0, nphi, &q, &r);
    s_base[slot][0] = q;
    s_base[slot][1] = r;
  };
  if (tid == 0) base_of(w, 0);
  __syncthreads();
  uint64_t q_cur = s_base[0][0], r_cur = s_base[0][1];
  int lead_cur[kTM ? 1 : kCB], lead_next[kTM ? 1 : kCB];
  stage<XR, kTM, kCB>(buf(0), rs, lead_cur, x, hist, C, xlen, H,
                      w / n_tiles, d0 - 1 + (int64_t)q_cur, span);
  cp_async_commit();
  if (kTM && kTableInSmem) {  // the taps are evaluated before a span wait
    cp_async_wait_one();       // the table has landed
    __syncthreads();
  }
  for (int cur = 0; w < total; w += gridDim.x, cur ^= 1) {
    const int64_t wn = w + gridDim.x;
    if (tid == 0 && wn < total) base_of(wn, cur ^ 1);
    // the next base is written; no thread still reads buf(cur ^ 1) or the
    // taps (the previous item is done)
    __syncthreads();
    uint64_t q_next = 0, r_next = 0;
    if (wn < total) {
      q_next = s_base[cur ^ 1][0];
      r_next = s_base[cur ^ 1][1];
      stage<XR, kTM, kCB>(buf(cur ^ 1), rs, lead_next, x, hist, C, xlen, H,
                          wn / n_tiles, d0 - 1 + (int64_t)q_next, span);
    }
    cp_async_commit();

    const int64_t g = w / n_tiles;
    const int64_t n0 = (w - g * n_tiles) * tile;
    const int nt = (int)(n_out - n0 < tile ? n_out - n0 : tile);
    const Pos first = add(Pos{0, (uint32_t)(r_cur >> 32), (uint32_t)r_cur},
                          d_first, nphi);
    if constexpr (kTM) {
      // the tile's taps, once for the block's 32 channels
      Pos p = first;
      for (int j = tid; j < nt; j += nth) {
        A alpha;
        to_alpha(p.fr, &alpha);
        const W* coef = tb + p.phi;
        s_off[j] = (int)p.off;
#pragma unroll
        for (int t = 0; t < T; ++t)
          s_tap[t * tile + j] = eval_tap<kP1>(coef + t * nphi_, P1, TN,
                                              alpha);
        p = add(add(p, d_one, nphi), d_round, nphi);
      }
    }
    cp_async_wait_one();  // this item's span has landed
    __syncthreads();
    const X* s_x;
    if constexpr (kNarrow) {  // widened once, read T times an output
      const XR* raw = buf(cur);
      for (int i = tid; i < buf_n; i += nth) s_wide[i] = mr::widen<X>(raw[i]);
      __syncthreads();
      s_x = s_wide;
    } else {
      s_x = buf(cur);
    }
    if constexpr (kTM) {
      const int nw = nth / kLanes;
      const int64_t c = g * kLanes + lane;
      for (int j = warp; j < nt; j += nw) {
        const X* wx = s_x + s_off[j] * kLanes + lane;
        Acc acc = mr::zero<Acc>();
#pragma unroll
        for (int t = 0; t < T; ++t)
          acc = mac(acc, wx[t * kLanes], s_tap[t * tile + j]);
        if (c < C) y[(n0 + j) * C + c] = narrow<Out>(acc);
      }
    } else {
      // thread tid runs outputs tid*run + s, s < run, in each round of
      // nth*run outputs; the rounds are the same in a whole warp
      Acc* const wy = s_y + warp * 32 * (run + 1);
      Pos p = first;
      for (int base = warp * 32 * run; base < nt; base += nth * run) {
        for (int s = 0, j = base + lane * run; s < run; ++s, ++j) {
          if (j < nt) {
            A alpha;
            to_alpha(p.fr, &alpha);
            const W* coef = tb + p.phi;
            const X* wx = s_x + p.off;  // channel k's: wx + k*rs + lead
            Acc acc[kCB];
#pragma unroll
            for (int k = 0; k < kCB; ++k) acc[k] = mr::zero<Acc>();
#pragma unroll
            for (int t = 0; t < T; ++t) {
              const W tap = eval_tap<kP1>(coef + t * nphi_, P1, TN, alpha);
#pragma unroll
              for (int k = 0; k < kCB; ++k)
                acc[k] = mac(acc[k], wx[k * rs + lead_cur[k] + t], tap);
            }
            if (run > 1) {
              wy[lane * (run + 1) + s] = acc[0];  // kCB == 1
            } else {
#pragma unroll
              for (int k = 0; k < kCB; ++k)
                if (g * kCB + k < C)
                  y[(g * kCB + k) * n_out + n0 + j] = narrow<Out>(acc[k]);
            }
          }
          p = add(p, d_one, nphi);
        }
        p = add(p, d_round, nphi);
        if (run > 1) {  // the warp's 32*run outputs, stored coalesced
          __syncwarp();
          for (int i = lane; i < 32 * run && base + i < nt; i += 32)
            y[g * n_out + n0 + base + i] =
                narrow<Out>(wy[(i >> log_run) * (run + 1) + (i & (run - 1))]);
          __syncwarp();
        }
      }
    }
    q_cur = q_next;
    r_cur = r_next;
#pragma unroll
    for (int k = 0; k < (kTM ? 1 : kCB); ++k) lead_cur[k] = lead_next[k];
  }
}

// One grouped output: its taps by eval_tap's Horner over alpha (of the
// 32-bit fraction fr) from its phase's table words tab (row p*kT + t), then
// mac over t = 0..kT-1 of the window wx into one float.
template <int kT, int kP1, int kRow>
__device__ __forceinline__ float grouped_dot(const float (&tab)[kRow],
                                             uint32_t fr, const float* wx) {
  float alpha;
  to_alpha(fr, &alpha);
  float acc = mr::zero<float>();
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    float tap = tab[(kP1 - 1) * kT + t];
#pragma unroll
    for (int q = kP1 - 2; q >= 0; --q)
      tap = horner(tap, alpha, tab[q * kT + t]);
    acc = mac(acc, wx[t], tap);
  }
  return acc;
}

// A phase's row of the table by phase (kRow words, 16-byte aligned) into
// registers.
template <int kRow>
__device__ __forceinline__ void load_row(float (&tab)[kRow],
                                         const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int i = 0; i < kRow / 4; ++i) {
    const float4 v = r4[i];
    tab[4 * i] = v.x;
    tab[4 * i + 1] = v.y;
    tab[4 * i + 2] = v.z;
    tab[4 * i + 3] = v.w;
  }
}

// The grouped one-channel path (variants t10p2.grouped, t10p5.grouped):
// float32 tables and float32 or narrow-read samples, channel-major blocks
// of one channel, at a rate with a phase-preserving stride: K outputs whose
// step K*delta lies within a sliver (2^20) of a multiple of D, a whole
// number of samples, so that outputs K apart share their phase (the host
// takes the least such k and K = k * (256 / k) threads: at 1/2.123456789,
// k = 81 outputs step 172.0000029 samples, K = 243). A tile of K*R outputs
// is K progressions j = s + K*r (s < K, r < R); thread i takes the one that
// starts at s = i*m mod K, so that the lanes of a warp sit m outputs apart
// (m*delta/D within 1/32 of an odd number of samples: their window words
// fall on 32 banks). A thread holds its
// phase's T*(P+1) table words in registers and reloads them only where its
// phase changes: once in a block's life, and where the sliver carries a
// fraction past a phase. A block walks a contiguous run of tiles, so each
// tile's progressions continue the last's. Per tile the dot reads T window
// words an output from shared memory (and no table word); the outputs go
// to shared memory (padded a word every 32) and out coalesced, while the
// next tile's span loads into the other buffer.
// Every output is the run path's bits: the same (offset, phase, fraction),
// by the same digit walk, eval_tap's Horner over alpha from the same table
// words, then mac over t = 0..T-1 into one float.
template <typename XR, typename Out, int kT, int kP1>
__global__ void __launch_bounds__(kThreadsG, 2)
resample_grouped_kernel(const XR* __restrict__ x,
                        const XR* __restrict__ hist,
                        const float* __restrict__ table, Out* __restrict__ y,
                        int64_t C, int64_t xlen, int nphi_, uint64_t delta,
                        uint64_t u0, int64_t d0, int64_t n_out, int tile,
                        int span, int64_t n_tiles, int stride, int mult) {
  using X = typename Staged<XR>::type;  // float
  constexpr bool kNarrow = !std::is_same<X, XR>::value;
  constexpr int kRow = table_row(kT, kP1);
  const uint32_t nphi = (uint32_t)nphi_;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ uint64_t s_base[2][2];  // (q0, r0) of this item and the next
  const int rs = row_samples(span, sizeof(XR));
  size_t at = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem_raw + at;
    at += round16(bytes);
    return p;
  };
  float* const s_tab =
      reinterpret_cast<float*>(carve((size_t)nphi * kRow * sizeof(float)));
  XR* const buf0 = reinterpret_cast<XR*>(carve(rs * sizeof(XR)));
  const size_t buf_stride = round16(rs * sizeof(XR)) / sizeof(XR);
  carve(rs * sizeof(XR));
  X* const s_wide =
      kNarrow ? reinterpret_cast<X*>(carve(rs * sizeof(X))) : nullptr;
  float* const s_y = reinterpret_cast<float*>(carve(0));
  // this block's items: a contiguous run
  const int64_t total = n_tiles * C;
  const int64_t per = total / gridDim.x, extra = total % gridDim.x;
  int64_t w = blockIdx.x * per + min((int64_t)blockIdx.x, extra);
  const int64_t w_end = w + per + (blockIdx.x < extra);
  if (w >= w_end) return;
  MR_CLOCK_BEGIN;
  const int tid = (int)threadIdx.x;
  // the table by phase: row phi holds table[p, t, phi] at p*kT + t
  for (int i = tid; i < kP1 * kT * nphi_; i += blockDim.x) {
    const int pt = i / nphi_;
    s_tab[(i - pt * nphi_) * kRow + pt] = table[i];
  }
  const int H = kT - 1;
  const int shift = (nphi & (nphi - 1)) == 0 ? __ffs(nphi_) - 1 : -1;
  const bool runs = tid < stride;  // threads past the stride only stage
  const int j0 = (int)((int64_t)tid * mult % stride);  // its first output
  const int rows = tile / stride;
  const Digits d_first = split((uint64_t)j0 * delta, nphi, shift);
  const Digits d_step = split((uint64_t)stride * delta, nphi, shift);

  auto base_of = [&](int64_t item, int slot) {
    uint64_t q, r;
    tile_base((uint64_t)(item % n_tiles) * tile, delta, u0, nphi, &q, &r);
    s_base[slot][0] = q;
    s_base[slot][1] = r;
  };
  if (tid == 0) base_of(w, 0);
  __syncthreads();
  int lead_cur, lead_next;
  stage<XR, false, 1>(buf0, rs, &lead_cur, x, hist, C, xlen, H, w / n_tiles,
                      d0 - 1 + (int64_t)s_base[0][0], span);
  cp_async_commit();
  uint32_t cur_phi = 0xffffffffu;
  float tab[kRow];
  MR_CLOCK(kClkTable);
  for (int cur = 0; w < w_end; ++w, cur ^= 1) {
    if (tid == 0 && w + 1 < w_end) base_of(w + 1, cur ^ 1);
    // the other buffer's and the outputs' last readers are done; the next
    // base is written (and, once, the table)
    __syncthreads();
    if (w + 1 < w_end)
      stage<XR, false, 1>(buf0 + (cur ^ 1) * buf_stride, rs, &lead_next, x,
                          hist, C, xlen, H, (w + 1) / n_tiles,
                          d0 - 1 + (int64_t)s_base[cur ^ 1][0], span);
    cp_async_commit();
    const int64_t g = w / n_tiles;
    const int64_t n0 = (w - g * n_tiles) * tile;
    const int nt = (int)(n_out - n0 < tile ? n_out - n0 : tile);
    const uint64_t r0 = s_base[cur][1];
    MR_CLOCK(kClkStage);
    cp_async_wait_one();  // this item's span has landed (the next may not)
    __syncthreads();
    const X* xw;
    if constexpr (kNarrow) {  // widened once, read T times an output
      for (int i = tid; i < rs; i += blockDim.x)
        s_wide[i] = mr::widen<X>(buf0[cur * buf_stride + i]);
      __syncthreads();
      xw = s_wide + lead_cur;
    } else {
      xw = buf0 + cur * buf_stride + lead_cur;
    }
    MR_CLOCK(kClkWait);
    if (runs) {
      Pos p = add(Pos{0, (uint32_t)(r0 >> 32), (uint32_t)r0}, d_first, nphi);
      for (int r = 0, j = j0; r < rows && j < nt; ++r, j += stride) {
        if (p.phi != cur_phi) {  // once a block, and where the sliver carries
          cur_phi = p.phi;
          load_row(tab, s_tab + cur_phi * kRow);
        }
        s_y[j + (j >> 5)] = grouped_dot<kT, kP1>(tab, p.fr, xw + p.off);
        p = add(p, d_step, nphi);
      }
    }
    MR_CLOCK(kClkDot);
    __syncthreads();  // every output of the tile is written
    MR_CLOCK(kClkBarrier);
    Out* const yt = y + g * n_out + n0;
#pragma unroll 4
    for (int i = tid; i < nt; i += blockDim.x)
      yt[i] = mr::narrow<Out>(s_y[i + (i >> 5)]);
    lead_cur = lead_next;
    MR_CLOCK(kClkStore);
  }
  MR_CLOCK_END;
}

// The grouped path fed by a producer warp (variants t10p2.grouped.tma,
// t10p5.grouped.tma): the grouped path's float32 calls of one channel.
// Each block persists and takes an even share of the call's outputs (whole
// 16-byte words), in tiles from its first output. Its last warp is the
// producer: for each tile it waits for a free ring stage, forms the tile's
// base, stores by hand what no bulk copy can bring (history samples, the
// words before the first 16-byte boundary of x, the last partial word and
// zeros past x's end) and starts one bulk copy of the rest, completing on
// the stage's full barrier. Stage word 0 is xext sample start = e0 - lead,
// where e0 is the tile's first window and lead (0-3) puts x[start - H] at
// a 16-byte boundary. The consumer warps wait on the full barrier, run the
// grouped path's per-output work unchanged (the same progressions, digit
// walk, table words in registers, Horner and mac order) into an output
// stage, and release the ring stage on its empty barrier (an arrival a
// warp). Once a named barrier among the consumers has seen a tile's outputs
// written, one thread (the last consumer, idle where the stride leaves
// lanes over) stores them with one bulk store (a bulk group), which it
// waits on only before that output stage is written again, two tiles
// later. No block barrier remains in the tile loop.
template <int kT, int kP1>
__global__ void __launch_bounds__(kThreadsGT, 2)
resample_grouped_tma_kernel(const float* __restrict__ x,
                            const float* __restrict__ hist,
                            const float* __restrict__ table,
                            float* __restrict__ y, int64_t xlen, int nphi_,
                            uint64_t delta, uint64_t u0, int64_t d0,
                            int64_t n_out, int tile, int stride, int mult,
                            int depth) {
  constexpr int kRow = table_row(kT, kP1);
  constexpr int H = kT - 1;
  struct StageInfo {  // 16 bytes (kStageHeaderGT)
    uint64_t r0;        // the tile's first remainder
    int lead;           // stage word of its first window
  };
  const uint32_t nphi = (uint32_t)nphi_;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const GroupedTmaGeom geo =
      grouped_tma_geom(tile, kT, kP1, nphi, delta, depth);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* const empty = full + kMaxStagesGT;
  StageInfo* const info = reinterpret_cast<StageInfo*>(empty + kMaxStagesGT);
  float* const s_tab = reinterpret_cast<float*>(smem_raw + geo.table_at);
  float* const ring = reinterpret_cast<float*>(smem_raw + geo.ring_at);
  float* const s_out = reinterpret_cast<float*>(smem_raw + geo.out_at);
  const int nb = geo.nb;
  // this block's outputs: an even share of the call's 16-byte words, a
  // contiguous run, in tiles from its first (the last one short)
  const int64_t words = (n_out + 3) / 4;
  const int64_t b0 = 4 * (words * blockIdx.x / gridDim.x);
  const int64_t b1 = min(n_out, 4 * (words * (blockIdx.x + 1) / gridDim.x));
  if (b0 >= b1) return;
  const int64_t n_tiles = (b1 - b0 + tile - 1) / tile;
  MR_CLOCK_BEGIN;
  const int tid = (int)threadIdx.x;
  const int consumers = (int)blockDim.x - 32;  // whole warps
  for (int i = tid; i < kP1 * kT * nphi_; i += blockDim.x) {
    const int pt = i / nphi_;
    s_tab[(i - pt * nphi_) * kRow + pt] = table[i];
  }
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, consumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  MR_CLOCK(kClkTable);

  if (tid >= consumers) {  // the producer warp
    const int lane = tid - consumers;
    // x[k] lies at a 16-byte boundary where (xm + k) % 4 == 0
    const int xm = (int)(((uintptr_t)x >> 2) & 3);
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t k = 0; k < n_tiles; ++k) {
      mbar_wait(empty + stage, phase ^ 1);
      MR_CLOCK(kClkFree);
      uint64_t q = 0, r = 0;
      if (lane == 0)
        tile_base((uint64_t)(b0 + k * tile), delta, u0, nphi, &q, &r);
      q = __shfl_sync(0xffffffffu, (unsigned long long)q, 0);
      const int64_t e0 = d0 - 1 + (int64_t)q;
      const int lead = (int)(((xm + e0 - H) % 4 + 4) % 4);
      const int64_t start = e0 - lead;
      float* const buf = ring + (size_t)stage * nb;
      // stage word j is xext sample start + j: [jx0, jx1) lies in x, of
      // which [jb0, jb1) goes by the bulk copy, in whole 16-byte words
      const int64_t a0 = H - start, a1 = H + xlen - start;
      const int jx0 = (int)(a0 < 0 ? 0 : (a0 > nb ? nb : a0));
      const int jx1 = (int)(a1 < jx0 ? jx0 : (a1 > nb ? nb : a1));
      const int jb1 = jx1 & ~3;
      const int jb0 = min((jx0 + 3) & ~3, jb1);
      auto sample = [&](int j) {
        const int64_t e = start + j;
        return e < 0 ? 0.0f : (e < H ? hist[e] : (e - H < xlen ? x[e - H]
                                                               : 0.0f));
      };
      for (int j = lane; j < jb0; j += 32) buf[j] = sample(j);
      for (int j = jb1 + lane; j < nb; j += 32) buf[j] = sample(j);
      if (lane == 0) info[stage] = StageInfo{r, lead};
      __syncwarp();
      if (lane == 0) {
        const uint32_t bytes = (uint32_t)(jb1 - jb0) * sizeof(float);
        mbar_arrive_tx(full + stage, bytes);
        if (bytes)
          bulk_copy(buf + jb0, x + (start + jb0 - H), bytes, full + stage);
      } else {
        mbar_arrive(full + stage);
      }
      MR_CLOCK(kClkStage);
      if (++stage == depth) {
        stage = 0;
        phase ^= 1;
      }
    }
    MR_CLOCK_END;
    return;
  }

  const int lane = tid & 31;
  const int shift = (nphi & (nphi - 1)) == 0 ? __ffs(nphi_) - 1 : -1;
  const bool runs = tid < stride;  // lanes past the stride only arrive
  const int j0 = (int)((int64_t)tid * mult % stride);  // its first output
  const int rows = tile / stride;
  // the bulk stores' thread: the last consumer, idle where the stride
  // leaves lanes over
  const int storer = consumers - 1;
  const Digits d_first = split((uint64_t)j0 * delta, nphi, shift);
  const Digits d_step = split((uint64_t)stride * delta, nphi, shift);
  uint32_t cur_phi = 0xffffffffu;
  float tab[kRow];
  int stage = 0, ob = 0;
  uint32_t phase = 0;
  for (int64_t k = 0; k < n_tiles; ++k, ob ^= 1) {
    mbar_wait(full + stage, phase);
    MR_CLOCK(kClkWait);
    const uint64_t r0 = info[stage].r0;
    const float* const xw = ring + (size_t)stage * nb + info[stage].lead;
    const int64_t n0 = b0 + k * tile;
    const int nt = (int)(b1 - n0 < tile ? b1 - n0 : tile);
    float* const so = s_out + (size_t)ob * tile;
    if (runs) {
      Pos p = add(Pos{0, (uint32_t)(r0 >> 32), (uint32_t)r0}, d_first, nphi);
      for (int r = 0, j = j0; r < rows && j < nt; ++r, j += stride) {
        if (p.phi != cur_phi) {  // once a block, and where the sliver carries
          cur_phi = p.phi;
          load_row(tab, s_tab + cur_phi * kRow);
        }
        so[j] = grouped_dot<kT, kP1>(tab, p.fr, xw + p.off);
        p = add(p, d_step, nphi);
      }
    }
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(empty + stage);
    MR_CLOCK(kClkDot);
    fence_async_shared();  // this thread's outputs, for the bulk store
    if (tid == storer) bulk_wait_read();  // the last tile's store has read
    named_sync(1, consumers);  // its stage; every output is written
    MR_CLOCK(kClkBarrier);
    if (tid == storer) {
      const int whole = nt & ~3;  // in 16-byte words; the rest by hand
      if (whole) bulk_store(y + n0, so, (uint32_t)whole * sizeof(float));
      bulk_commit();
      for (int i = whole; i < nt; ++i) y[n0 + i] = so[i];
    }
    MR_CLOCK(kClkStore);
    if (++stage == depth) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (tid == storer) bulk_wait();  // the stores have completed
  MR_CLOCK_END;
}

// One variant's launch on the plan (tile, cb, run, grid); kT = kP1 = 0 is the
// general variant.
template <typename XR, typename W, typename Out, bool kTM, int kT, int kP1>
int launch_variant(const void* x, const void* hist, const void* table,
                   void* y, int64_t C, int64_t xlen, int T, int nphi, int P1,
                   uint64_t delta, uint64_t u0, int64_t d0, int64_t n_out,
                   int tile, int cb, int run, int64_t grid,
                   cudaStream_t stream) {
  const bool table_smem =
      (size_t)P1 * T * nphi * sizeof(W) <= kTableSmemLimit;
  if (kT > 0 && (T != kT || P1 != kP1 || !table_smem)) return kErrBadPlan;
  if (tile < 1 || tile > (kTM ? kMaxTileTM : kMaxTileCM)) return kErrBadPlan;
  if (kTM ? cb != kLanes : (cb != 1 && cb != kGroupCM)) return kErrBadPlan;
  // runs: a power of two up to 16, in one-channel blocks only
  if (run < 1 || run > 16 || (run & (run - 1)) || (run > 1 && cb != 1))
    return kErrBadPlan;
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  const int64_t groups = (C + cb - 1) / cb;
  if (grid < 1 || grid > kMaxGridX || grid > n_tiles * groups)
    return kErrBadPlan;
  using X = typename Staged<XR>::type;
  const size_t smem = smem_bytes(tile, cb, run, T, P1, (uint32_t)nphi,
                                 delta, sizeof(XR), sizeof(X),
                                 sizeof(typename Sum<X, W>::type), sizeof(W),
                                 table_smem, kTM);
  if (smem > kSmemLimit) return kErrTooLarge;
  const int span = (int)span_of(tile, T, (uint32_t)nphi, delta);
  const int threads = block_threads(tile, run, kTM);
#define MR_RUN(CB, SMEM)                                                     \
  launch_kernel(resample_kernel<XR, W, Out, kTM, kT, kP1, CB, SMEM>,         \
                (unsigned)grid, threads, smem, true, stream, (const XR*)x,   \
                (const XR*)hist, (const W*)table, (Out*)y, C, xlen, T, nphi, \
                P1, delta, u0, d0, n_out, tile, run, span, n_tiles, groups)
  if constexpr (kTM) {
    if (table_smem) return MR_RUN(kLanes, true);
    if constexpr (kT == 0) return MR_RUN(kLanes, false);
  } else if (cb == 1) {
    if (table_smem) return MR_RUN(1, true);
    if constexpr (kT == 0) return MR_RUN(1, false);
  } else {
    if (table_smem) return MR_RUN(kGroupCM, true);
    if constexpr (kT == 0) return MR_RUN(kGroupCM, false);
  }
#undef MR_RUN
  return kErrBadPlan;
}

// A grouped launch (t10p2.grouped, t10p5.grouped) on the plan (tile, cb,
// run, grid, stride, mult): one-channel blocks (cb 1, run 1) of the stride's
// threads in whole warps (at most kThreadsG), tiles of whole progressions up
// to kMaxTileG, a multiplier prime to the stride.
template <typename XR, typename Out, int kT, int kP1>
int launch_grouped(const void* x, const void* hist, const void* table,
                   void* y, int64_t C, int64_t xlen, int T, int nphi, int P1,
                   uint64_t delta, uint64_t u0, int64_t d0, int64_t n_out,
                   int tile, int cb, int run, int64_t grid, int stride,
                   int mult, cudaStream_t stream) {
  if (T != kT || P1 != kP1 || cb != 1 || run != 1) return kErrBadPlan;
  if (stride < 1 || stride > kThreadsG || mult < 1 || tile < stride ||
      tile > kMaxTileG || tile % stride)
    return kErrBadPlan;
  if (gcd(stride, mult % stride) != 1) return kErrBadPlan;
  if ((size_t)P1 * T * nphi * sizeof(float) > kTableSmemLimit)
    return kErrBadPlan;
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  if (grid < 1 || grid > kMaxGridX || grid > n_tiles * C) return kErrBadPlan;
  const int64_t span = span_of(tile, T, (uint32_t)nphi, delta);
  const size_t smem = grouped_smem_bytes(tile, T, P1, (uint32_t)nphi, delta,
                                         sizeof(XR), sizeof(float));
  if (smem > kSmemLimit) return kErrTooLarge;
  const int threads = (stride + 31) / 32 * 32;
  return launch_kernel(resample_grouped_kernel<XR, Out, kT, kP1>,
                       (unsigned)grid, threads, smem, true, stream,
                       (const XR*)x, (const XR*)hist, (const float*)table,
                       (Out*)y, C, xlen, nphi, delta, u0, d0, n_out, tile,
                       (int)span, n_tiles, stride, mult);
}

// A grouped.tma launch (t10p2.grouped.tma, t10p5.grouped.tma) on the plan
// (tile, cb, run, grid, stride, mult, depth): the grouped plan's checks,
// one channel, tiles of whole 16-byte words (the bulk store's), a ring of
// 2 to kMaxStagesGT stages, and y at a 16-byte boundary.
template <int kT, int kP1>
int launch_grouped_tma(const float* x, const float* hist, const float* table,
                       float* y, int64_t C, int64_t xlen, int T, int nphi,
                       int P1, uint64_t delta, uint64_t u0, int64_t d0,
                       int64_t n_out, int tile, int cb, int run, int64_t grid,
                       int stride, int mult, int depth, cudaStream_t stream) {
  if (T != kT || P1 != kP1 || cb != 1 || run != 1 || C != 1) return kErrBadPlan;
  if (stride < 1 || stride > kThreadsG || mult < 1 || tile < stride ||
      tile > kMaxTileG || tile % stride || tile % 4)
    return kErrBadPlan;
  if (gcd(stride, mult % stride) != 1 || depth < 2 || depth > kMaxStagesGT)
    return kErrBadPlan;
  if ((size_t)P1 * T * nphi * sizeof(float) > kTableSmemLimit ||
      ((uintptr_t)y & 15))
    return kErrBadPlan;
  const int64_t n_tiles = (n_out + tile - 1) / tile;
  if (grid < 1 || grid > kMaxGridX || grid > n_tiles) return kErrBadPlan;
  const size_t smem =
      grouped_tma_geom(tile, T, P1, (uint32_t)nphi, delta, depth).smem;
  if (smem > kSmemLimit) return kErrTooLarge;
  const int threads = (stride + 31) / 32 * 32 + 32;
  return launch_kernel(resample_grouped_tma_kernel<kT, kP1>, (unsigned)grid,
                       threads, smem, true, stream, x, hist, table, y, xlen,
                       nphi, delta, u0, d0, n_out, tile, stride, mult, depth);
}

// Launch on x (C, xlen) -> y (C, n_out), or time-major x (xlen, C) ->
// y (n_out, C), by the plan's variant; see the extern "C" entries.
template <typename XR, typename W, typename Out, bool kTM>
int launch(const void* x, const void* hist, const void* table, void* y,
           int64_t C, int64_t xlen, int T, int nphi, int P1, uint64_t delta,
           uint64_t u0, int64_t d0, int64_t n_out, int variant, int tile,
           int cb, int run, int64_t grid, int stride, int mult, int depth,
           void* stream) {
  if (C <= 0 || n_out <= 0) return cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
#define MR_VARIANT(KT, KP1)                                                  \
  launch_variant<XR, W, Out, kTM, KT, KP1>(x, hist, table, y, C, xlen, T,    \
                                           nphi, P1, delta, u0, d0, n_out,   \
                                           tile, cb, run, grid, s)
  switch (variant) {
    case kGeneral:
      return MR_VARIANT(0, 0);
    case kT10P2:
      return MR_VARIANT(10, 2);
    case kT10P5:
      return MR_VARIANT(10, 5);
    case kT73P2:
      return MR_VARIANT(73, 2);
#undef MR_VARIANT
    case kT10P2G:
    case kT10P5G:
      // float32 tables against float32 or narrow samples, channel-major
      if constexpr (!kTM && std::is_same<W, float>::value &&
                    std::is_same<typename Staged<XR>::type, float>::value) {
        return variant == kT10P2G
                   ? launch_grouped<XR, Out, 10, 2>(
                         x, hist, table, y, C, xlen, T, nphi, P1, delta, u0,
                         d0, n_out, tile, cb, run, grid, stride, mult, s)
                   : launch_grouped<XR, Out, 10, 5>(
                         x, hist, table, y, C, xlen, T, nphi, P1, delta, u0,
                         d0, n_out, tile, cb, run, grid, stride, mult, s);
      }
      return kErrBadPlan;
    case kT10P2GT:
    case kT10P5GT:
      // float32 samples and tables, float32 outputs, channel-major
      if constexpr (!kTM && std::is_same<XR, float>::value &&
                    std::is_same<W, float>::value &&
                    std::is_same<Out, float>::value) {
        auto go = variant == kT10P2GT ? launch_grouped_tma<10, 2>
                                      : launch_grouped_tma<10, 5>;
        return go((const float*)x, (const float*)hist, (const float*)table,
                  (float*)y, C, xlen, T, nphi, P1, delta, u0, d0, n_out, tile,
                  cb, run, grid, stride, mult, depth, s);
      }
      return kErrBadPlan;
    default:
      return kErrBadPlan;
  }
}

}  // namespace

extern "C" {

// Channel-major (time_major = 0): x (C, xlen) -> y (C, n_out).
// Time-major (time_major = 1):    x (xlen, C) -> y (n_out, C).
// hist (C, T-1) and table (P1, T, nphi) in both; all float32, contiguous,
// on the current device. The caller guarantees 0 < nphi << 32 < 2^44,
// 0 < delta < 2^44, u0 + n_out*delta < 2^96, d0 >= 1, and that every
// window lies inside [history ++ x]: d0 + (u0 + (n_out-1)*delta) / D <=
// xlen. (variant, tile, cb, run, grid, stride, mult, depth) is the
// launch's plan (mr_plan.cpp, through ops/cuda/resample.py plan()): the
// variant (0 general, 1 T = 10 with P+1 = 2, 2 T = 10 with P+1 = 5, 3 T =
// 73 with P+1 = 2, 4 and 5 the grouped paths of 1 and 2, 6 and 7 their
// grouped.tma forms), outputs a tile, channels a block (1 or 8
// channel-major, 32 time-major), neighbouring outputs a thread runs (1, 2,
// 4, 8 or 16; 1 unless cb == 1), blocks, at most, for a grouped path its
// phase-preserving stride and lane multiplier, and for grouped.tma its ring
// stages (else ignored). Returns
// a cudaError_t code, kErrTooLarge when the plan's shared
// memory exceeds the limit, or kErrBadPlan when the variant does not take
// the plan. The narrow reads (MR_RESAMPLE_NARROW) take the same arguments,
// with x and hist of their stored type and y of their output type.
#define MR_RESAMPLE_LAYOUT(name, XR, Out)                                    \
  int mr_resample_##name(const void* x, const void* hist, const void* table, \
                         void* y, int64_t C, int64_t xlen, int T, int nphi,  \
                         int P1, uint64_t delta, uint64_t u0, int64_t d0,    \
                         int64_t n_out, int time_major, int variant,         \
                         int tile, int cb, int run, int64_t grid,            \
                         int stride, int mult, int depth, void* stream) {    \
    auto go = time_major ? launch<XR, float, Out, true>                      \
                         : launch<XR, float, Out, false>;                    \
    return go(x, hist, table, y, C, xlen, T, nphi, P1, delta, u0, d0, n_out, \
              variant, tile, cb, run, grid, stride, mult, depth, stream);    \
  }

// Channel-major only, as mr_resample_f32 with time_major = 0: x and hist
// of the signal type X (its stored type for a narrow read), the table of
// type W, y of type Out, complex ones 8- or 16-byte aligned. One entry per
// (signal, table) pair: mr_resample_<name>.
#define MR_RESAMPLE(name, X, W, Out)                                         \
  int mr_resample_##name(const void* x, const void* hist, const void* table, \
                         void* y, int64_t C, int64_t xlen, int T, int nphi,  \
                         int P1, uint64_t delta, uint64_t u0, int64_t d0,    \
                         int64_t n_out, int variant, int tile, int cb,      \
                         int run, int64_t grid, int stride, int mult,       \
                         int depth, void* stream) {                          \
    return launch<X, W, Out, false>(x, hist, table, y, C, xlen, T, nphi, P1,\
                                  delta, u0, d0, n_out, variant, tile, cb,  \
                                  run, grid, stride, mult, depth, stream);   \
  }

MR_RESAMPLE_LAYOUT(f32, float, float)
MR_RESAMPLE(f64, double, double, double)
MR_RESAMPLE(c64, float2, float, float2)
MR_RESAMPLE(c64c, float2, float2, float2)
MR_RESAMPLE(c128, double2, double, double2)
MR_RESAMPLE(c128c, double2, double2, double2)

#ifdef MR_CLOCKS
// The clock split's sums by ClockPart (kClockParts of them) into ``out``,
// then zeroed; returns a cudaError_t code.
int mr_resample_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, mr_clocks, sizeof(mr_clocks));
  if (err != cudaSuccess) return err;
  const unsigned long long zeros[kClockParts] = {};
  return cudaMemcpyToSymbol(mr_clocks, zeros, sizeof(mr_clocks));
}
#endif

const char* mr_error_string(int code) {
  if (code == kErrTooLarge) return "the plan's shared memory exceeds the limit";
  if (code == kErrBadPlan) return "the variant does not take this plan";
  return cudaGetErrorString((cudaError_t)code);
}

// narrow reads: float32 outputs, and float16 ones (the output type of
// float16 taps with a narrow signal; bfloat16 with them gives float32)
MR_RESAMPLE_LAYOUT(bf16, __nv_bfloat16, float)
MR_RESAMPLE_LAYOUT(f16, __half, float)
MR_RESAMPLE_LAYOUT(s16, int16_t, float)
MR_RESAMPLE_LAYOUT(s8, int8_t, float)
MR_RESAMPLE_LAYOUT(u8, uint8_t, float)
MR_RESAMPLE_LAYOUT(f16_f16out, __half, __half)
MR_RESAMPLE_LAYOUT(s16_f16out, int16_t, __half)
MR_RESAMPLE_LAYOUT(s8_f16out, int8_t, __half)
MR_RESAMPLE_LAYOUT(u8_f16out, uint8_t, __half)
// real samples against complex tables, read as stored (channel-major)
MR_RESAMPLE(f32c, float, float2, float2)
MR_RESAMPLE(f64c, double, double2, double2)
MR_RESAMPLE(bf16c, __nv_bfloat16, float2, float2)
MR_RESAMPLE(f16c, __half, float2, float2)
MR_RESAMPLE(s16c, int16_t, float2, float2)
MR_RESAMPLE(s8c, int8_t, float2, float2)
MR_RESAMPLE(u8c, uint8_t, float2, float2)

#undef MR_RESAMPLE
#undef MR_RESAMPLE_LAYOUT

}  // extern "C"
