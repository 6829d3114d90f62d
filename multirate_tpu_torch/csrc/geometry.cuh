// The launch geometry of the port's two kernels: each variant's limits,
// shared-memory layout and the checks its launcher makes on a plan. One
// copy serves the device code and launchers of polyphase.cu and resample.cu
// (nvcc) and the host's planner, mr_plan.cpp (g++), which chooses every
// launch from these functions; nothing here needs the CUDA runtime but
// launch_kernel.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MR_HD __host__ __device__ __forceinline__
#else
#define MR_HD inline
#endif

namespace mr {

constexpr int64_t kMaxGridX = 65535;  // grid.x, at most (blocks loop)

// Bytes rounded up to whole 16-byte words: what follows a staged bank,
// table or buffer starts 16-byte aligned (a complex128 word is one load).
MR_HD size_t round16(size_t bytes) { return (bytes + 15) & ~(size_t)15; }

MR_HD int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <int N>
constexpr bool member(const int (&set)[N], int v) {
  for (int i = 0; i < N; ++i)
    if (set[i] == v) return true;
  return false;
}

#ifdef __CUDACC__
// Launch ``kern`` with ``smem`` dynamic shared bytes a block; where
// ``persistent``, on at most as many blocks of grid.x as the card holds at
// once (the plan's grid is an upper bound, and a persistent block loads
// its taps or table once). Returns a cudaError_t code.
template <typename... P, typename... A>
int launch_kernel(void (*kern)(P...), dim3 grid, int block, size_t smem,
                  bool persistent, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if (persistent && cudaGetDevice(&dev) == cudaSuccess &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block,
                                                    smem) == cudaSuccess &&
      per_sm > 0 && grid.x > (unsigned)(per_sm * sms))
    grid.x = per_sm * sms;
  kern<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}
#endif

// ---------------------------------------------------------------- polyphase
namespace polyphase {

constexpr int kThreads = 256;       // general
constexpr int kRegThreads = 256;    // reg: at most this many per block
constexpr int kRegTarget = 128;     // reg: groups x KT up to this many
constexpr int kBcastThreads = 128;  // bcast
constexpr int kSlideThreads = 128;  // slide
constexpr int64_t kMaxGridY = 65535;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kBankSmemLimit = 96 * 1024;
constexpr int kTmaMaxStages = 8;  // reg.tma: ring buffers, at most
constexpr int kTmaBarBytes = 2 * kTmaMaxStages * 8;  // its mbarriers
constexpr int kTmaV = 4;  // reg.tma: samples a 16-byte word (float32)

// Variants by the number the entry points take (ops/cuda/polyphase.py
// VARIANTS), and the taps per phase that reg and slide, and reg.tma, are
// compiled for (its REG_TAPS and TMA_TAPS).
enum Variant { kGeneral = 0, kReg = 1, kBcast = 2, kSlide = 3, kRegTma = 4 };
constexpr int kRegTaps[] = {24, 37};
constexpr int kTmaTaps[] = {24};

// The register variant's outputs per thread R and tap padding E (U = T+E
// registers a tap vector), and the broadcast and sliding variants'
// outputs per thread: by the size of a staged tap and sample.
MR_HD constexpr int reg_r(size_t ws) {
  return ws <= 4 ? 4 : (ws <= 8 ? 2 : 1);
}
MR_HD constexpr int reg_e(size_t ws) { return reg_r(ws) == 1 ? 0 : reg_r(ws); }
MR_HD constexpr int bcast_r(size_t xs) {
  return xs <= 4 ? 9 : (xs <= 8 ? 5 : 3);
}

// Bytes of a raw buffer for n samples of size sz: the copy starts up to 15
// bytes early (at a 16-byte boundary), and int8 reads whole words past the
// end.
MR_HD size_t raw_bytes(int64_t n, size_t sz) {
  return round16((size_t)n * sz + 16) + 16;
}

// Shared bytes of the general variant's tile of ``tile`` outputs (-1 when
// it cannot fit); sets *bank_smem.
inline int64_t general_smem(int T, int L, int M, int tile, size_t xs,
                            size_t ws, bool* bank_smem) {
  const size_t b_bytes = round16((size_t)T * L * ws);
  *bank_smem = b_bytes <= kBankSmemLimit;
  const size_t span = (size_t)((L - 1 + (int64_t)(tile - 1) * M) / L + T);
  const size_t smem = (*bank_smem ? b_bytes : 0) + span * xs;
  return smem <= kSmemLimit ? (int64_t)smem : -1;
}

// The register variant's geometry for one launch (host and device).
struct RegGeom {
  int Qp;      // outputs of one period (a multiple of Q, at least R)
  int Pp;      // inputs of one period
  int G;       // thread groups of R outputs in a period
  int KT;      // threads per group: periods k = kl, kl + KT, ... of a tile
  int K;       // periods per tile
  int span;    // staged samples of a tile
  int block;   // threads per block
  size_t smem;  // shared bytes: a double buffer of raw samples
};

// The window offset of a period's last group of R outputs from its first
// output's (G groups).
MR_HD int64_t reg_base_max(int L, int M, int G, int R) {
  return ((int64_t)L - 1 + (int64_t)(G - 1) * R * M) / L;
}

// -1 if the geometry does not fit the variant (D > E, Q too large). xs is
// the size of a raw sample (the double buffer holds raw samples).
inline int reg_geom(int T, int L, int M, int K, int R, int E, size_t xs,
                    RegGeom* g) {
  const int gg = gcd(L, M);
  const int Q = L / gg, P = M / gg;
  const int m = Q >= R ? 1 : (R + Q - 1) / Q;
  g->Qp = m * Q;
  g->Pp = m * P;
  g->G = (g->Qp + R - 1) / R;
  if (L < 2 || K < 1 || g->G > kRegThreads) return -1;
  if (((int64_t)(R - 1) * M + L - 1) / L > E) return -1;  // d_r <= E
  const int kt = kRegTarget / g->G > 1 ? kRegTarget / g->G : 1;
  g->KT = kt < K ? kt : K;
  g->K = K;
  g->block = (g->G * g->KT + 31) / 32 * 32;
  const int64_t span =
      (int64_t)(K - 1) * g->Pp + reg_base_max(L, M, g->G, R) + T + E;
  g->span = (int)span;
  g->smem = 2 * raw_bytes(span, xs);
  return g->smem <= kSmemLimit ? 0 : -1;
}

// Window words a reg.tma thread reads a period: U = T + E, after up to
// V - 1 words of alignment, rounded up to whole 16-byte words.
MR_HD constexpr int tma_words(int T, int E, int V) {
  return (T + E + 2 * (V - 1)) / V * V;
}

// Samples a reg.tma ring buffer holds: a tile's reads (K periods of Pp,
// the last group's offset, the alignment, the padded window), in whole
// 16-byte words.
inline int64_t tma_buffer(int K, int Pp, int64_t base_max, int words,
                          int V) {
  return ((int64_t)(K - 1) * Pp + base_max + V - 1 + words + V - 1) / V * V;
}

// The sliding variant's geometry: interpolators (M / gcd(L, M) == 1, so
// the outputs of one phase class read windows one input apart).
struct SlideGeom {
  int Q;      // outputs a period (phase classes)
  int KG;     // threads a class: groups of R periods
  int K;      // periods per tile (a multiple of R)
  int span;   // staged samples of a tile
  int block;  // threads per block
  size_t out_offset, smem;
};

inline int slide_geom(int T, int L, int M, int K, int R, size_t xs,
                      size_t os, SlideGeom* g) {
  const int gg = gcd(L, M);
  g->Q = L / gg;
  if (M / gg != 1 || L < 2 || g->Q > kSlideThreads || K < 1 || K % R)
    return -1;
  const int kg = kSlideThreads / g->Q;
  g->KG = kg < K / R ? kg : K / R;
  g->K = K;
  g->block = (g->Q * g->KG + 31) / 32 * 32;
  g->span = K + T + R;  // windows start at most one sample into a period
  g->out_offset = 2 * raw_bytes(g->span, xs);
  g->smem = g->out_offset + round16((size_t)K * g->Q * os);
  return g->smem <= kSmemLimit ? 0 : -1;
}

// The broadcast variant's layout: the bank and the span split by input
// phase mod M into rows p < min(M, T) (TQ taps a row, zero-padded to a
// multiple of R; SP samples a row), after a double buffer of raw samples
// that the next tile's copy fills.
struct BcastGeom {
  int rows, SP, TQ, span;
  size_t bank_bytes, raw, x_offset, out_offset, smem;
};

inline int bcast_geom(int T, int M, int tile, int R, size_t xsz, size_t xs,
                      size_t ws, size_t os, BcastGeom* g) {
  if (tile < 1 || tile % (kBcastThreads * R)) return -1;
  g->rows = M < T ? M : T;
  g->TQ = ((T + M - 1) / M + R - 1) / R * R;  // taps a row, zero-padded
  const int64_t span = (int64_t)(tile - 1) * M + T;
  g->span = (int)span;
  const int row = tile + g->TQ + R;
  const int skew = M > 1 && M <= 32 ? 32 / M : 1;  // staging stores: banks
  g->SP = (row + 31) / 32 * 32 + skew;
  g->bank_bytes = round16((size_t)g->rows * g->TQ * ws);
  g->raw = raw_bytes(span, xsz);
  g->x_offset = g->bank_bytes + 2 * g->raw;
  g->out_offset = g->x_offset + round16((size_t)g->rows * g->SP * xs);
  g->smem = g->out_offset + round16((size_t)tile * os);
  return g->smem <= kSmemLimit ? 0 : -1;
}

}  // namespace polyphase

// ----------------------------------------------------------------- resample
namespace resample {

constexpr int kThreadsCM = 128;   // channel-major: threads a block, at most
constexpr int kThreadsTM = 256;   // time-major
constexpr int kLanes = 32;        // time-major: channels a block
constexpr int kGroupCM = 8;       // channel-major: channels a block, C >= 8
constexpr int kMaxTileCM = 1024;  // outputs a tile, at most
constexpr int kMaxTileTM = 256;
constexpr int kThreadsG = 256;    // grouped: threads a block, at most
constexpr int kMaxTileG = 8192;   // grouped: outputs a tile, at most
constexpr size_t kSmemLimit = 226 * 1024;  // dynamic, beside the static
constexpr size_t kTableSmemLimit = 96 * 1024;

constexpr int kMaxStagesGT = 8;   // grouped.tma: ring stages, at most
constexpr int kThreadsGT = kThreadsG + 32;  // grouped.tma: and a producer

// Variants by the number the entry points take (ops/cuda/resample.py
// VARIANTS), and the (T, P+1) each compiled one is built for with its
// grouped one-channel paths (-1: none): its COMPILED, GROUPED and
// GROUPED_TMA.
enum Variant {
  kGeneral = 0, kT10P2 = 1, kT10P5 = 2, kT73P2 = 3, kT10P2G = 4, kT10P5G = 5,
  kT10P2GT = 6, kT10P5GT = 7
};
struct Compiled {
  int T, P1, variant, grouped, grouped_tma;
};
constexpr Compiled kCompiled[] = {{10, 2, kT10P2, kT10P2G, kT10P2GT},
                                  {10, 5, kT10P5, kT10P5G, kT10P5GT},
                                  {73, 2, kT73P2, -1, -1}};

// Input samples a tile of ``tile`` outputs reads, at most (any first
// remainder below D): the last window's offset from the first, plus T.
MR_HD int64_t span_of(int tile, int T, uint32_t nphi, uint64_t delta) {
  const uint64_t D = (uint64_t)nphi << 32;
  return (int64_t)((D - 1 + (uint64_t)(tile - 1) * delta) / D) + T;
}

// Samples a staged channel-major row holds: the span, and room for its
// first sample to sit up to 15 bytes past a 16-byte boundary, rounded to
// whole 16-byte chunks.
MR_HD int row_samples(int span, size_t xsz) {
  const int v = 16 / (int)xsz;
  return (span + v - 1 + v - 1) / v * v;
}

// Threads of a block: time-major kThreadsTM; channel-major enough for a
// tile in runs of ``run`` outputs, in whole warps, at most kThreadsCM.
MR_HD int block_threads(int tile, int run, bool time_major) {
  if (time_major) return kThreadsTM;
  const int need = (tile + run - 1) / run;
  return need < kThreadsCM ? (need + 31) / 32 * 32 : kThreadsCM;
}

// Shared bytes of one block: the table (when staged), a double buffer of
// the spans of cb channels as stored (time-major: span rows of kLanes
// samples; xsz bytes a sample), for a narrow read one buffer of the span
// widened (csz bytes a sample), time-major a tile's taps and offsets, and
// channel-major runs (run > 1) a warp's 32 runs of outputs (asz bytes an
// accumulator), gathered for coalesced stores.
inline size_t smem_bytes(int tile, int cb, int run, int T, int P1,
                         uint32_t nphi, uint64_t delta, size_t xsz,
                         size_t csz, size_t asz, size_t wsz, bool table_smem,
                         bool time_major) {
  size_t b = table_smem ? round16((size_t)P1 * T * nphi * wsz) : 0;
  const int span = (int)span_of(tile, T, nphi, delta);
  const size_t row =
      (size_t)(time_major ? span : row_samples(span, xsz)) * cb;
  b += 2 * round16(row * xsz);
  if (csz != xsz) b += round16(row * csz);
  if (time_major) b += round16((size_t)tile * T * wsz) + round16(tile * 4);
  if (run > 1)
    b += round16((size_t)block_threads(tile, run, time_major) * (run + 1) *
                 asz);
  return b;
}

// Words of one phase's row of a grouped block's table: T*(P+1), rounded up
// to whole 16-byte loads.
MR_HD constexpr int table_row(int T, int P1) { return (T * P1 + 3) / 4 * 4; }

// Shared bytes of one grouped block: the table by phase, a double buffer of
// spans as stored (xsz bytes a sample) and, for a narrow read, one widened
// (csz), and the tile's outputs (float, a word of padding every 32).
inline size_t grouped_smem_bytes(int tile, int T, int P1, uint32_t nphi,
                                 uint64_t delta, size_t xsz, size_t csz) {
  const size_t rows =
      (size_t)row_samples((int)span_of(tile, T, nphi, delta), xsz);
  size_t b = round16((size_t)nphi * table_row(T, P1) * sizeof(float));
  b += 2 * round16(rows * xsz);
  if (csz != xsz) b += round16(rows * csz);
  b += round16(((size_t)tile + tile / 32) * sizeof(float));
  return b;
}

// A grouped.tma block's shared memory, in order: each ring stage's full
// and empty mbarriers and its tile's (r0, lead) (kMaxStagesGT of each), the
// table by phase, ``depth`` stages of ``nb`` float32 samples (a tile's
// span, after up to 3 samples of alignment, in whole 16-byte words), and
// two output stages of ``tile`` floats (unpadded: the bulk store copies
// one whole). Offsets in bytes, each 16-byte aligned.
struct GroupedTmaGeom {
  int nb;
  size_t table_at, ring_at, out_at, smem;
};
constexpr size_t kStageHeaderGT = kMaxStagesGT * (8 + 8 + 16);

MR_HD GroupedTmaGeom grouped_tma_geom(int tile, int T, int P1, uint32_t nphi,
                                      uint64_t delta, int depth) {
  GroupedTmaGeom g;
  g.nb = row_samples((int)span_of(tile, T, nphi, delta), sizeof(float));
  g.table_at = kStageHeaderGT;
  g.ring_at = g.table_at + round16((size_t)nphi * table_row(T, P1) * 4);
  g.out_at = g.ring_at + (size_t)depth * g.nb * sizeof(float);
  g.smem = g.out_at + 2 * round16((size_t)tile * sizeof(float));
  return g;
}

}  // namespace resample
}  // namespace mr
