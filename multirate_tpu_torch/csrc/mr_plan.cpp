// The launch planner of the port's two kernels: each call's variant, tile
// and grid (and the resample kernel's channels a block, run, threads,
// stride and multiplier), from its shape alone, by the launchers' own
// geometry (geometry.cuh), which polyphase.cu and resample.cu check every
// plan against again. Built with g++ (ops/cuda/build.py), so it plans on any
// host; ops/cuda/polyphase.py and resample.py plan() call it through ctypes
// and cache each plan. Tiles are sized so that the grid fills the card
// (2 x 132 work items where there are outputs enough) and a block's shared
// memory stays near a target, so that several blocks share an SM: the
// fastest of sweeps on the H100 (PERF.md).

#include <stdint.h>

#include <algorithm>
#include <cstdlib>

#include "geometry.cuh"

namespace {

namespace pp = mr::polyphase;
namespace rs = mr::resample;
using std::max;
using std::min;

constexpr int64_t kFill = 2 * 132;  // work items that fill the SMs twice

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The most k from ``k`` by ``step``, below ``k_max``, whose smem(k) stays
// within ``target``.
template <typename F>
int grow(int k, int step, int k_max, size_t target, F smem) {
  while (k < k_max && smem(k + step) <= target) k += step;
  return k;
}

// ---------------------------------------------------------------- polyphase

constexpr size_t kSmemTarget = 48 * 1024;  // a block's shared bytes
constexpr int kSlideRepeats = 8;  // slide: periods a thread a tile, at most
// reg: periods a thread computes in a tile, and periods a tile, at least
constexpr int kRegPeriods = 3, kRegMinTile = 6;
// reg.tma: periods a thread computes in a tile, and buffers in its ring
constexpr int kTmaPeriods = 12, kTmaDepth = 2;
constexpr int64_t kMaxGeneralGrid = 1024;

// One call: taps per phase, the ratio, outputs and channels, and the sizes
// of a raw (stored) sample, a staged sample and tap, and an output (the
// accumulator's: a narrower store needs less).
struct Call {
  int T, L, M;
  int64_t n_out, channels;
  size_t xsz, xs, ws, osz;
};

// Writes the plan (variant, tile, grid, shared bytes, outputs a tile, ring
// buffers) to ``out``.
bool put(int64_t* out, int variant, int64_t tile, int64_t grid, size_t smem,
         int64_t tile_outputs, int depth = 0) {
  const int64_t p[] = {variant,       tile, min(grid, mr::kMaxGridX),
                       (int64_t)smem, tile_outputs, depth};
  std::copy(p, p + 6, out);
  return true;
}

// reg's geometry for tiles of K periods (false where reg cannot take it).
bool reg_geom(const Call& c, int K, pp::RegGeom* g) {
  return mr::member(pp::kRegTaps, c.T) &&
         pp::reg_geom(c.T, c.L, c.M, K, pp::reg_r(c.ws), pp::reg_e(c.ws),
                      c.xsz, g) == 0;
}

bool reg_plan(const Call& c, int64_t* out) {
  pp::RegGeom g, k{};
  if (!reg_geom(c, 1, &g)) return false;
  auto smem = [&](int K) {
    reg_geom(c, K, &k);
    return k.smem;
  };
  const int kt = max(1, pp::kRegTarget / g.G);
  const int k_fit = grow(1, 1, max(kt * kRegPeriods, kRegMinTile),
                         kSmemTarget, smem);
  const int64_t periods = ceil_div(c.n_out, g.Qp);
  const int K = (int)max<int64_t>(
      1, min<int64_t>(k_fit, periods * c.channels / kFill));
  return put(out, pp::kReg, K, ceil_div(periods, K) * c.channels, smem(K),
             (int64_t)K * g.Qp);
}

// reg.tma where reg takes the geometry with at most a block's consumers in
// a period and a period moves whole 16-byte words (the caller checks the
// mode and the alignment), with ``depth`` ring buffers and ``periods``
// periods a thread a tile; not below ``min_tiles`` tiles.
bool tma_plan(const Call& c, int depth, int periods, int64_t min_tiles,
              int64_t* out) {
  pp::RegGeom g;
  if (!mr::member(pp::kTmaTaps, c.T) || !reg_geom(c, 1, &g) ||
      g.G > pp::kRegTarget || g.Pp % pp::kTmaV)
    return false;
  const int K = max(1, pp::kRegTarget / g.G) * periods;
  const int64_t nb = pp::tma_buffer(
      K, g.Pp, pp::reg_base_max(c.L, c.M, g.G, pp::reg_r(c.ws)),
      pp::tma_words(c.T, pp::reg_e(c.ws), pp::kTmaV), pp::kTmaV);
  const size_t smem = pp::kTmaBarBytes + (size_t)depth * nb * c.xsz;
  const int64_t tiles = ceil_div(ceil_div(c.n_out, g.Qp), K) * c.channels;
  return tiles >= min_tiles && smem <= pp::kSmemLimit &&
         put(out, pp::kRegTma, K, tiles, smem, (int64_t)K * g.Qp, depth);
}

bool bcast_plan(const Call& c, int64_t* out) {
  const int R = pp::bcast_r(c.xs), per = pp::kBcastThreads * R;
  pp::BcastGeom g{};
  auto smem = [&](int kb) {
    pp::bcast_geom(c.T, c.M, kb * per, R, c.xsz, c.xs, c.ws, c.osz, &g);
    return g.smem;
  };
  if (c.L != 1 || smem(1) > pp::kSmemLimit) return false;
  const int kb_fit = grow(1, 1, INT32_MAX, kSmemTarget, smem);
  const int kb = (int)max<int64_t>(
      1, min<int64_t>(kb_fit, c.n_out * c.channels / (kFill * per)));
  return put(out, pp::kBcast, kb * per,
             ceil_div(c.n_out, kb * per) * c.channels, smem(kb), kb * per);
}

bool slide_plan(const Call& c, int64_t* out) {
  const int R = pp::bcast_r(c.xs), Q = c.L / mr::gcd(c.L, c.M);
  if (!mr::member(pp::kRegTaps, c.T) || c.M / mr::gcd(c.L, c.M) != 1 ||
      c.L < 2 || Q > pp::kSlideThreads)
    return false;
  pp::SlideGeom g{};
  auto smem = [&](int K) {
    pp::slide_geom(c.T, c.L, c.M, K, R, c.xsz, c.osz, &g);
    return g.smem;
  };
  const int k_fit = grow(R, R, pp::kSlideThreads / Q * R * kSlideRepeats,
                         kSmemTarget, smem);
  const int64_t periods = ceil_div(c.n_out, Q);
  const int K = (int)max<int64_t>(
      R, min<int64_t>(k_fit, periods * c.channels / kFill / R * R));
  return put(out, pp::kSlide, K, ceil_div(periods, K) * c.channels, smem(K),
             (int64_t)K * Q);
}

bool general_plan(const Call& c, int64_t* out) {
  bool bank_smem;
  auto smem = [&](int tile) {
    return pp::general_smem(c.T, c.L, c.M, tile, c.xs, c.ws, &bank_smem);
  };
  int tile = 1024;
  while (tile > 32 && ceil_div(c.n_out, tile) * c.channels < kFill)
    tile /= 2;
  while (tile > 1 && smem(tile) < 0) tile /= 2;
  return smem(tile) >= 0 &&
         put(out, pp::kGeneral, tile,
             min(ceil_div(c.n_out, tile), kMaxGeneralGrid), smem(tile), tile);
}

// ----------------------------------------------------------------- resample

constexpr size_t kSmemTargetR = 64 * 1024;  // a block's shared bytes
constexpr int kMinTile = 32;
constexpr int kRuns[] = {2, 4, 8, 16};  // neighbouring outputs, past 1
// the grouped path: shared bytes a block (two blocks an SM), the largest
// sliver of a stride (|stride*delta mod D|: a phase change in a thread's
// outputs at most once every 4,096), and outputs a thread a tile at least
constexpr size_t kSmemTargetG = 110 * 1024;
constexpr int64_t kSliverG = 1 << 20;
constexpr int kMinRowsG = 8;
// grouped.tma: outputs a thread a tile, at most (tiles of whole 16-byte
// words: a multiple of 4), and ring stages. The fastest of a sweep on the
// H100 (PERF.md). It takes every call the grouped path would take, within
// the same shared bytes a block: no tile threshold (the sweep's launch
// sizes found it no slower at any)
constexpr int kRowsGT = 16, kDepthGT = 2;
// what a tile costs a block beyond its outputs (its wait, barrier and
// store), in outputs a thread: a fit of the sweep's tiles of 8, 12 and 16
constexpr int kStepRowsGT = 1;

// Whether outputs m apart have windows within 1/32 sample of an odd whole
// number of samples apart: then 32 lanes m outputs apart load window words
// on 32 banks, and their phases cluster.
bool odd_step(int64_t m, int64_t D, int64_t delta) {
  const int64_t k = (2 * m * delta + D) / (2 * D);  // nearest samples
  return k % 2 && 32 * std::abs(m * delta - k * D) < D;
}

// Neighbouring outputs a thread runs, so a warp's lanes sit ``run`` outputs
// apart: the least run with an odd step, in one-channel blocks of at least
// two warps of full runs; else 1.
int run_of(int tile, int cb, int64_t D, int64_t delta) {
  for (int run : kRuns)
    if (cb == 1 && tile >= 64 * run && odd_step(run, D, delta)) return run;
  return 1;
}

// The grouped path's stride: k * (256 / k) for the least k whose multiple
// keeps a thread's phase (|stride*delta mod D| at most kSliverG), or 0 at a
// rate that has none.
int stride_of(int64_t D, int64_t delta) {
  for (int k = 1; k <= rs::kThreadsG; ++k) {
    const int stride = k * (rs::kThreadsG / k);
    const int64_t d = stride * delta % D;
    if (min(d, D - d) <= kSliverG) return stride;
  }
  return 0;
}

// Outputs between neighbouring lanes' progressions: the least m prime to
// the stride with an odd step, else 1.
int mult_of(int stride, int64_t D, int64_t delta) {
  for (int m = 1; m < stride; ++m)
    if (mr::gcd(m, stride) == 1 && odd_step(m, D, delta)) return m;
  return 1;
}

// Outputs between neighbouring lanes' progressions where a tile's outputs
// sit unpadded in shared memory (grouped.tma): the least m prime to the
// stride whose warps' lanes put their outputs (j mod 32) and their windows'
// first words (j*delta/D mod 32) fewest to a bank, summed over the warps.
int tma_mult_of(int stride, int64_t D, int64_t delta) {
  int best = 1, best_cost = INT32_MAX;
  for (int m = 1; m < stride; ++m) {
    if (mr::gcd(m, stride) != 1) continue;
    int cost = 0;
    for (int w = 0; w * 32 < stride; ++w) {
      int outs[32] = {}, wins[32] = {}, most_o = 0, most_w = 0;
      for (int i = w * 32; i < min(stride, w * 32 + 32); ++i) {
        const int64_t j = (int64_t)i * m % stride;
        most_o = max(most_o, ++outs[j % 32]);
        most_w = max(most_w, ++wins[j * delta / D % 32]);
      }
      cost += most_o + most_w;
    }
    if (cost < best_cost) {
      best_cost = cost;
      best = m;
    }
  }
  return best;
}

// The grouped path's plan: its stride, multiplier and the largest tile of
// whole progressions that gives the card kFill work items within two
// blocks' shared memory an SM; false where the rate has no stride or a
// thread would run fewer than kMinRowsG outputs a tile (unless ``forced``:
// then any stride, one output a thread at least). ``rows_set`` > 0 sets the
// outputs a thread a tile: false past the kernel's limits.
bool grouped_plan(int variant, int64_t n_out, int64_t groups, int T, int P1,
                  int nphi, int64_t delta, size_t xsz, size_t csz,
                  bool forced, int rows_set, int64_t* out) {
  const int64_t D = (int64_t)nphi << 32;
  int stride = stride_of(D, delta);
  if (!stride && !forced) return false;
  if (!stride) stride = rs::kThreadsG;
  const int64_t need = ceil_div(kFill, groups);
  int rows = rs::kMaxTileG / stride;
  if (need > 1)
    rows = (int)max<int64_t>(
        min<int64_t>(rows, (n_out - 1) / (need - 1) / stride), 1);
  if (rows_set > 0) rows = rows_set;
  auto smem = [&] {
    return rs::grouped_smem_bytes(stride * rows, T, P1, nphi, delta, xsz,
                                  csz);
  };
  while (rows_set <= 0 && rows > 1 && smem() > kSmemTargetG) --rows;
  const int tile = stride * rows;
  if (smem() > (forced ? rs::kSmemLimit : kSmemTargetG) ||
      !(forced || rows >= kMinRowsG) || tile > rs::kMaxTileG)
    return false;
  const int64_t p[] = {variant, tile, 1, 1,
                       min(ceil_div(n_out, tile) * groups, mr::kMaxGridX),
                       (stride + 31) / 32 * 32, (int64_t)smem(), stride,
                       mult_of(stride, D, delta), 0};
  std::copy(p, p + 10, out);
  return true;
}

// The grouped.tma plan of a one-channel call: the grouped path's stride
// (256 where none keeps the phase, if ``forced``), and the outputs a thread
// a tile, a multiple of 4 up to kRowsGT, that cuts each of kFill blocks'
// even share of the call in the tiles that cost it least (each its rows
// and kStepRowsGT; a short last tile costs a block nearly a whole one; the
// larger on a tie), in a ring of kDepthGT stages; false where the rate has no
// stride, the grouped path would not take the call (kMinRowsG outputs a
// thread in kFill tiles) or the block's shared memory passes kSmemTargetG
// (unless ``forced``: then from 4 outputs a thread, up to the limits).
// ``rows_set`` and
// ``depth_set`` > 0 set the outputs a thread a tile and the stages
// (tools/resample_runs.py's sweeps).
bool grouped_tma_plan(int variant, int64_t n_out, int T, int P1, int nphi,
                      int64_t delta, bool forced, int rows_set, int depth_set,
                      int64_t* out) {
  const int64_t D = (int64_t)nphi << 32;
  int stride = stride_of(D, delta);
  if (!stride && !forced) return false;
  if (!stride) stride = rs::kThreadsG;
  const int depth = depth_set > 0 ? depth_set : kDepthGT;
  // the grouped path's own condition: kMinRowsG outputs a thread in each
  // of kFill tiles
  const bool fills = (n_out - 1) / (kFill - 1) / stride >= kMinRowsG;
  if (!fills && !forced) return false;
  int rows = rows_set;
  if (rows <= 0) {
    const int64_t share = ceil_div(ceil_div(n_out, 4), kFill) * 4;
    int64_t least = INT64_MAX;
    for (int r = fills ? kMinRowsG : 4; r <= kRowsGT; r += 4) {
      const int64_t cost =
          ceil_div(share, (int64_t)stride * r) * (r + kStepRowsGT);
      if (cost <= least) {
        least = cost;
        rows = r;
      }
    }
  }
  const int tile = stride * rows;
  const size_t smem =
      rs::grouped_tma_geom(tile, T, P1, nphi, delta, depth).smem;
  if (tile % 4 || tile > rs::kMaxTileG || depth < 2 ||
      depth > rs::kMaxStagesGT ||
      smem > (forced ? rs::kSmemLimit : kSmemTargetG))
    return false;
  const int64_t p[] = {variant, tile, 1, 1,
                       min(ceil_div(n_out, tile), mr::kMaxGridX),
                       (stride + 31) / 32 * 32 + 32, (int64_t)smem, stride,
                       tma_mult_of(stride, D, delta), depth};
  std::copy(p, p + 10, out);
  return true;
}
}  // namespace

extern "C" {

// The plan of one polyphase call (the arguments of ops/cuda/polyphase.py
// plan() as numbers): the sizes of a stored sample, tap and accumulator;
// whether the samples are staged widened to float (a narrow read, or
// bfloat16); whether reg.tma may take the call (a float32 mode, every row
// of x 16-byte aligned); ``variant`` by number, or -1 for the first of
// bcast, slide, reg.tma (with ``min_tiles`` tiles at least), reg and
// general that takes it. ``depth`` and ``periods``, when positive, set
// reg.tma's ring buffers and periods a thread a tile (the sweeps of
// tools/polyphase_runs.py). Writes (variant, tile, grid, smem,
// tile_outputs, depth) to ``out`` and returns 0, or -1 where no variant
// asked for can take the call.
int mr_polyphase_plan(int T, int L, int M, int64_t n_out, int64_t channels,
                      int xsz, int wsz, int osz, int widened, int tma,
                      int variant, int64_t min_tiles, int depth, int periods,
                      int64_t* out) {
  // bfloat16 taps are staged as float too
  const Call c{T, L, M, max<int64_t>(n_out, 1), channels, (size_t)xsz,
               (size_t)(widened ? 4 : xsz), (size_t)(wsz == 2 ? 4 : wsz),
               (size_t)osz};
  for (int v : {pp::kBcast, pp::kSlide, pp::kRegTma, pp::kReg, pp::kGeneral})
    if ((variant < 0 || v == variant) &&
        ((v == pp::kBcast && bcast_plan(c, out)) ||
         (v == pp::kSlide && slide_plan(c, out)) ||
         (v == pp::kRegTma && tma &&
          tma_plan(c, depth > 0 ? depth : kTmaDepth,
                   periods > 0 ? periods : kTmaPeriods,
                   variant >= 0 ? 0 : min_tiles, out)) ||
         (v == pp::kReg && reg_plan(c, out)) ||
         (v == pp::kGeneral && general_plan(c, out))))
      return 0;
  return -1;
}

// The plan of one resample call (the arguments of ops/cuda/resample.py
// plan() as numbers): the sizes of a stored sample, table word and
// accumulator; whether the samples are a narrow read (staged widened to
// float32); whether the call may take a grouped path (a float32 table,
// float32 or narrow samples; grouped.tma: float32 samples, one channel);
// ``variant`` by number or -1. ``run_set``, ``rows_set`` and ``depth_set``,
// when positive, set the run path's outputs a thread, a grouped path's
// outputs a thread a tile and grouped.tma's ring stages (the sweeps of
// tools/resample_runs.py). Writes (variant, tile, channels, run, grid,
// threads, smem, stride, mult, depth) to ``out`` and returns 0; -1 where
// the named variant cannot take the call, -2 where no grouped tile fits a
// span, -3 where one output's window exceeds shared memory.
int mr_resample_plan(int T, int P1, int nphi, int64_t delta, int64_t n_out,
                     int64_t C, int xsz, int wsz, int asz, int narrow,
                     int grouped_ok, int time_major, int variant, int run_set,
                     int rows_set, int depth_set, int64_t* out) {
  const size_t csz = narrow ? 4 : xsz;  // staged widened to float32
  const bool table_smem = (size_t)P1 * T * nphi * wsz <= rs::kTableSmemLimit;
  const int cb = time_major ? rs::kLanes : (C >= rs::kGroupCM ? rs::kGroupCM
                                                                : 1);
  int auto_v = -1, grouped = -1, tma = -1;  // the compiled pair's, if any
  for (const rs::Compiled& k : rs::kCompiled)
    if (table_smem && k.T == T && k.P1 == P1) {
      auto_v = k.variant;
      grouped = cb == 1 && grouped_ok ? k.grouped : -1;
      tma = grouped >= 0 && C == 1 && xsz == 4 && !narrow ? k.grouped_tma
                                                          : -1;
    }
  const int64_t groups = ceil_div(C, cb);
  n_out = max<int64_t>(n_out, 1);
  if (variant >= 0 && variant != rs::kGeneral && variant != auto_v &&
      variant != grouped && variant != tma)
    return -1;
  if (tma >= 0 && (variant < 0 || variant == tma)) {
    if (grouped_tma_plan(tma, n_out, T, P1, nphi, delta, variant >= 0,
                         rows_set, depth_set, out))
      return 0;
    if (variant >= 0) return -2;
  }
  if (grouped >= 0 && (variant < 0 || variant == grouped)) {
    if (grouped_plan(grouped, n_out, groups, T, P1, nphi, delta, xsz, csz,
                     variant >= 0, rows_set, out))
      return 0;
    if (variant >= 0) return -2;
  }
  const int64_t D = (int64_t)nphi << 32;
  auto smem = [&](int tile, int run) {
    return rs::smem_bytes(tile, cb, run > 0 ? run : run_of(tile, cb, D, delta),
                          T, P1, nphi, delta, xsz, csz, asz, wsz, table_smem,
                          time_major);
  };
  int tile = time_major ? rs::kMaxTileTM : rs::kMaxTileCM;
  while (tile > kMinTile && ceil_div(n_out, tile) * groups < kFill) tile /= 2;
  while (tile > kMinTile && smem(tile, 0) > kSmemTargetR) tile /= 2;
  while (tile > 1 && smem(tile, 0) > rs::kSmemLimit) tile /= 2;
  if (smem(tile, 0) > rs::kSmemLimit) return -3;
  const int run = run_set > 0 ? run_set : run_of(tile, cb, D, delta);
  const int64_t p[] = {
      variant >= 0 ? variant : (auto_v >= 0 ? auto_v : rs::kGeneral), tile,
      cb, run, min(ceil_div(n_out, tile) * groups, mr::kMaxGridX),
      rs::block_threads(tile, run, time_major), (int64_t)smem(tile, run), 0,
      0, 0};
  std::copy(p, p + 10, out);
  return 0;
}

}  // extern "C"
