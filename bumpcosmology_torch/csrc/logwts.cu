// Kernel B: the detector-frame log-weight of every PE sample and injection,
// forward and hand-derived backward, batched over chains, with two epilogues.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas_logwts.py:
//   forward  _fwd_call -> _fwd_kernel / _block_logwts (pallas_logwts.py:184, :146, :82-139)
//   backward _logwts_core_bwd -> _bwd_kernel           (pallas_logwts.py:217, :154)
// The Pallas backward recomputes the block under a JAX vjp; here the chain rule is
// written out by hand (the same formulas as the plain twin in ops/cuda_logwts.py).
//
// Per query (a = m1_det, q, log dL, log pdraw) and chain c:
//   pos_z = (log dL - v0)/dv;  z, log_jac = lerp of the detector table at pos_z
//   m1 = a/(1+z), m2 = q m1;  for m in {m1, m2}:
//     log_bump = lerp of the bump table at (m - mbh_lo)/dmbh, -inf outside (mbh_lo, mbh_hi)
//     log_tail = -c log(m/mbhmax) + log_pl_norm + log 2 - softplus(-(m - mbhmax)/(0.05 mbhmax))
//     ld(m)    = (m < 5 ? -inf : logaddexp(log_bump, log_tail)) + log_norm
//   out = ld(m1) + ld(m2) + beta log((m1+m2)/60) + log m1 + log dN/dV(z) - 2 log1p z
//         + log_jac - log pdraw
// Lerp brackets follow the fused path's _interp_unit_gather: lo = clip(floor(pos), 0, K-2),
// t = clip(pos - lo, 0, 1); the slope term of a gradient is taken where pos - lo lies in [0, 1].
//
// Epilogues.  `rows`: the TPU kernel's own function, (C, N) log-weights out, and the table
// and scalar cotangents back from a (C, N) cotangent.  `lse`: what the joint likelihood does
// with the rows straight after, fused in: the forward returns the log-sum-exp of each event's
// nsamp contiguous rows, (C, nobs), and of the selection rows after them, (C,); the backward
// takes the cotangents of those and the saved log-sum-exps, recomputes each row and forms its
// cotangent in registers as g_seg exp(out - lse_seg).  No (C, N) array is written or read.  A
// row whose weight is -inf (m < 5) has cotangent exactly 0; a segment whose rows are all -inf
// returns -inf and contributes nothing.  The cut branch of a mass term has weight exactly 0,
// never 0 * inf.
//
// What bounds it on an H100.  At the flagship size (C = 16 chains, N = 38,912 rows, K = 1024,
// G = 256) the work is 6.2e5 chain-rows and 0.6 MB of input that stays in L2: the byte bound
// and the operation bound (one operation per exp/log) are 1-2 microseconds, the same order as
// an empty launch (1.0 us; 1.8 us in this kernel's cluster geometry).  Measured (H100 80GB
// HBM3, 700 W; device time of 20 launches in one replayed CUDA graph, as chip_smoke.py phase 3
// and bumpcosmology_torch/tools/kernel_times.py take it): the forward takes 18 us, and took
// the same to within 1 us whatever the split of the rows over warps and lanes, so it is bound by
// the depth of one row's chain of some 15 transcendentals and 8 dependent shared-memory reads,
// not by instruction rate; the backward took 63 us with shared-memory float atomics for its
// table cotangents, 33 us of it in those atomics (17 us the bump bins, 11 us the detector bins:
// measured with builds that left them out and so gave wrong cotangents; those builds are not
// kept).  The atomics are now integer ones in fixed point (see "Table cotangents" below), so that
// two launches on the same inputs give the same bits.
//
// Geometry: one thread-block cluster per chain (the choice; see below for the alternative).
//   * Grid (8, C) with cluster dimension (8, 1, 1): 8 blocks share a chain, 128 blocks fill
//     the 132 SMs at C = 16, and more chains queue as further clusters.
//   * The rows are cut into pieces of 32 lanes x R rows that never straddle a segment (an
//     event, or the selection rows).  A block takes a contiguous eighth of the pieces and its
//     warps take them in turn.  The launch picks the number of warps that divides a block's
//     pieces into the fewest equal rounds.  Forward: R = 4 rows a lane, at most 32 warps (19
//     warps x 2 rounds at the flagship size).  Backward: R = 1 and at most 32 warps (31 x 5),
//     compiled to 64 registers: more warps beat more rows per lane there.
//     Times of the alternatives when the constants were chosen (us; rows fwd / lse fwd / rows
//     bwd / lse bwd; bracket positions were then taken with the hoisted reciprocals, which the
//     true divisions of today make 1.5 us slower forward; the kernel this one replaced, 304
//     blocks x 256 threads x 8 rows in sequence, took 21.4 fwd and 64.3 bwd with its three
//     memsets):
//       fwd R=1, 32 warps: 16.9 / 28.6      bwd R=4, 16 warps, libm: 105 / 113
//       fwd R=2, 32 warps: 16.1 / 26.4      bwd R=1, 16 warps:       86.3 / 91.7
//       fwd R=4, 16 warps: 17.0 / 21.2      bwd R=2, 16 warps:       84.9 / 87.5
//       fwd R=4, 32 warps: 16.1 / 20.6  <-  bwd R=1, 24 warps:       70.9 / 76.0
//       fwd R=8, 16 warps: 18.5 / 21.1      bwd R=1, 32 warps:       63.1 / 69.3  <-
//   * Each block copies its chain's tables (K float2 + G floats, 9 KB) and scalars into
//     shared memory, with the per-chain constants hoisted once: 1/dv, 1/dmbh, 1/mbhmax,
//     1/(0.05 mbhmax), log1p(zp), softplus and sigmoid of -kappa log1p(zp), 1/(1+zp).  The
//     query table stores log dL, which is per row and not per chain.
//   * `lse` forward: a warp reduces its piece to one (max, sum) pair in shared memory; warp 0
//     merges the block's selection pairs; after cluster.sync() a warp per segment merges over
//     the cluster through distributed shared memory (an event's few pairs where they lie, the
//     selection's one pair per block) and stores one number.
//   * Backward: a thread accumulates the 13 live scalar cotangents in registers over all its
//     rows; table cotangents go to the block's shared-memory bins in fixed point (below); the
//     scalars are reduced once per block through shared memory in a fixed order; after
//     cluster.sync() each block sums an eighth of the (2K + G + 15) values over the 8 blocks'
//     shared memory in rank order and stores them.  Every output element is written exactly once:
//     nothing is zeroed by the caller and no global atomic is used.
//   * Arithmetic.  The weights of the two mass branches and the sigmoids come from the
//     exponentials the forward already took (w = 1/(1+e) and e/(1+e)), so the backward adds
//     divisions, no exp.  __expf, __logf(1+e) and __fdividef stand where the result enters a
//     sum of order one or only a gradient (with libm there: forward 24 us, backward 69 us); the
//     logarithms multiplied by the population's exponents stay logf/log1pf.  What feeds a
//     table bracket (both positions, z, m1) is computed with the JAX reference's own operations,
//     true divisions and no fused multiply-add, so that kernel, plain twin and reference pick
//     the same bracket and fraction on any table; the hoisted reciprocals serve the gradients
//     and the smooth terms.  -use_fast_math is not taken.  Branches of a row are selects.
//   * Hot detector bins, tried and taken out: summing a warp's contributions to one bin
//     (__match_any_sync on the bin index) before the shared-memory atomics.  On the flagship
//     catalog 32 consecutive rows fall into 27 distinct bins on average (events) and 31
//     (injections; chip_smoke.py phase 3 prints both), so there is little to combine and the
//     backward was 6 us slower with it.  red.shared.add.f32 written in PTX changed nothing.
//
// Table cotangents: a sum in a fixed order, whatever order the rows arrive in.  Float atomicAdd
// into shared memory rounds each partial sum, so the result depended on the order in which the
// warps reached a bin, and two launches on the same inputs differed in the last bits (a seeded
// fit on the card parted from itself after the first mass-matrix window).  Each table bin now
// holds an exact integer: a contribution v is rounded once, to the nearest multiple of 2^-40, and
// that integer x = rint(v 2^40) is added as two words, hi = floor(x / 2^32) (signed) and
// lo = x - hi 2^32 in [0, 2^32), each with a 64-bit integer atomicAdd.  Integer addition is
// associative, so the bin's sum is the same in any order; the cluster's combine adds the eight
// blocks' words in rank order and converts hi 2^-8 + lo 2^-40 to float once.  Range: a row adds
// to a bin at most twice (both masses in one bump bin), so with |v| < 2^52 / N the hi words sum
// to less than 2N (2^60 / N + 1) < 2^62 in magnitude, inside int64, and the lo words to less than
// 2N 2^32 < 2^62 for N < 2^29 (the backward refuses a larger N).  A contribution at or beyond the
// limit (1.2e11 at the LOO fleet's 38,656 rows a chain, 4.4e10 at the mock catalog's 102,912), or
// one not finite, sets bit 63 of its bin's lo word, which no sum reaches; the combine writes such
// a bin as NaN rather than as a wrapped sum.  (The float atomics gave inf or a finite sum there.)
// The paths' contributions are far inside the limit: in the lse route |g| <= |g_seg| (each row's
// share of its segment's cotangent), and a bin adds g or g dout/dz times a bracket weight, of
// order the likelihood's cotangents (1 to nobs) times |dout/dz| (below 10^3 on the flagship).
// Resolution: each contribution is off by at most 2^-41 = 4.5e-13 and a bin by 2N of those
// (3.5e-8 at N = 38,912), below the float32 rounding of a cotangent of order one and far inside
// the limits against the twin (rtol 5e-4, atol 5e-4 x max|ref|) unless every cotangent of the
// table is below 7e-5.
// Shared memory, and the backward's two routes.  A bin takes 16 bytes where the float atomics
// took 4, so with the detector's bins in shared memory a detector row (two bins and its float2)
// takes 40 bytes where it took 16: at G = 256 and 32 warps that route (ROUTE_SHARED) fits K up to
// 4,347 on an H100 (227 KB a block), where the float atomics fitted 11,062; the forward fits about
// 28,900.  A larger table takes the second route (ROUTE_GLOBAL), chosen from the shape before the
// launch (bwd_route: the arithmetic of bwd_smem and fwd_smem against the device's limit), never by
// trying a launch.  There the detector's 2K bins are the same fixed-point words in a (C, 2, 2K)
// scratch in device memory, which the launch zeroes (cudaMemsetAsync on the stream) and the rows
// reach with 64-bit integer atomics in L2; the detector table is read through L1 instead of being
// copied; the bump's G bins, the scalar partials and the combine of the eight blocks stay in shared
// memory.  After its rows each block fences its atomics, the cluster synchronises, and each block
// converts its eighth of the chain's detector bins, read from L2 (__ldcg), to float as the shared
// route does.  Integer addition is order-free, so this route gives the same bits on every launch
// too.  Its shared memory does not grow with K (4 KB of bump bins, 52 KB of scalar partials at 992
// threads), so the backward takes every K the forward takes; beyond the forward's limit both are
// refused and the wrapper names the most K that fits (logwts_max_k).  Below the shared route's limit
// nothing changes: the same source path and arithmetic, the same bits.
// Why this design: the Pallas backward writes one partial table per grid step and sums them
// afterwards (pallas_logwts.py:217-250), which keeps its order fixed because the grid runs in
// sequence.  Per-block partials here would still need a fixed order inside the block, that is the
// fixed-point bins, which at these K no longer fit in shared memory; and a second launch and a
// (8 C, 2K) float tensor buy nothing that the cluster barrier does not give: the eight blocks that
// add to a chain's bins are the cluster that converts them.  Designs set aside for the shared
// route: per-warp partial bins combined in warp order
// fit the bump table (G = 256 floats x 32 warps = 32 KB) but not the detector's 2K = 2,048 floats
// x 32 warps, and the lanes of one warp would still need an order; rows sorted by detector bin
// when the query table is built would still leave the bump bins, which move with theta.
// Per-block partials in a scratch tensor, combined by the last block to finish, would need a
// zeroed ticket per launch (a memset, or a reset by the last block that a failed launch would
// leave dirty) and a round trip through L2 where the cluster reads its neighbours' shared memory
// directly.

// Query tables.  One table of N rows can serve every chain (the flagship fit: the chains share the
// catalog), or each chain can read its own N rows (a fleet of fits, one catalog per chain, as the
// calibration suite fits them): the table is then (C, N, 4) and chain c's rows start at c * N.
// Nothing else changes: a block reads its chain's rows through that offset, the segments are the
// same (nobs, nsamp) in every chain, and a chain's cotangents land in its own cluster's
// shared-memory bins whichever rows it read.  The layout is a template parameter (PER_CHAIN), so the
// shared table's kernels compile to the code they had before the per-chain layout existed: with the
// offset read at run time from the launch arguments the shared table's lse forward took 0.028 ms
// against 0.022 before (H100 80GB HBM3, 700 W; tools/kernel_times.py --kernel b, both in one job).
//
// C interface (bound with ctypes), float32, contiguous unless strides are given:
//   det (C,K,2) [z, log_jac]; bump (C,G); scal (C,15); qry (N,4) or (C,N,4) [a, q, log dL, log pdraw]
//   with qry_cs the rows between two chains' tables (0 or N);
//   out, gout (C,N); lse_ev (C,nobs); lse_sel (C,); g_ev (C,nobs) with element strides
//   (g_ev_s0, g_ev_s1); g_sel (C,) with element stride g_sel_s0;
//   d_det (C,K,2), d_bump (C,G), d_scal (C,15) are written in full;
//   det_bins: the backward's (C, 2, 2K) 64-bit scratch on ROUTE_GLOBAL (logwts_bwd_route says which
//   route a shape takes), unused and may be null on ROUTE_SHARED.
//   Each function returns the CUDA error of its launch (0 on success), or ERR_SMEM (-1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;     // blocks per chain: the portable maximum cluster size
constexpr int R_FWD = 4;       // rows a lane holds in flight, forward
constexpr int R_BWD = 1;       // and backward
constexpr int WARPS_FWD = 32;  // most warps of a block, forward
constexpr int WARPS_BWD = 32;  // and backward
constexpr int NS = 15;
constexpr int NACC = 13;           // scalar slots that can carry a cotangent (v0 .. zp)
constexpr int NS_PAD = 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2 = 0.69314718055994531f;
constexpr float MBH_MIN = 5.0f;
constexpr float MREF = 30.0f;
constexpr float QREF = 1.0f;
// fixed-point table cotangents: units of 2^-40, split into words of 2^32 units
constexpr double FX_ONE = 1099511627776.0;             // 2^40
constexpr double FX_WORD = 4294967296.0;               // 2^32
constexpr double FX_INV_WORD = 2.3283064365386963e-10;  // 2^-32
constexpr double FX_HI_UNIT = 0.00390625;              // 2^-8: a hi word in units of one
constexpr double FX_LO_UNIT = 9.094947017729282e-13;   // 2^-40
constexpr float FX_RANGE = 4503599627370496.0f;        // 2^52: the bound on |v| N
constexpr unsigned long long FX_MARK = 1ull << 63;     // a lo word's out-of-range mark
constexpr int FX_MAX_N = 1 << 29;                      // the backward's rows a chain, below

// scalar slots, as the Pallas layout (pallas_logwts.py:57-61); slots 13-14 (table
// lengths) are kept for layout only: the kernel takes K and G as int arguments.
// From INV_DV on: per-chain constants derived once per block in shared memory.
enum Slot {
  V0 = 0, DV, MBH_LO, DMBH, MBH_HI, C_TAIL, MBHMAX, LPN, LNORM, BETA, LAM, KAPPA, ZP,
  INV_DV = NS, INV_DMBH, INV_MBHMAX, INV_W, LZP, SP_ZP, SG_ZP, INV_OPZP, NSX
};
constexpr int NSX_PAD = 24;

// How the N rows of a chain are cut into pieces that never straddle a segment.
struct Work {
  int N, nobs, nsamp;
  int piece;      // rows of one warp work item: 32 lanes x the rows a lane holds
  int n_ev;       // nobs * nsamp
  int spe;        // pieces per event
  int p_ev;       // nobs * spe
  int p_total;
  int per_block;  // pieces of one block of the cluster
};

Work make_work(int N, int nobs, int nsamp, int rows_per_lane) {
  Work w;
  w.N = N; w.nobs = nobs; w.nsamp = nsamp;
  w.piece = 32 * rows_per_lane;
  w.n_ev = nobs * nsamp;
  w.spe = nobs > 0 ? (nsamp + w.piece - 1) / w.piece : 1;
  w.p_ev = nobs * w.spe;
  w.p_total = w.p_ev + (N - w.n_ev + w.piece - 1) / w.piece;
  w.per_block = (w.p_total + CLUSTER - 1) / CLUSTER;
  return w;
}

// the fewest equal rounds of at most max_warps warps over a block's pieces
int pick_threads(const Work& w, int max_warps) {
  const int pieces = w.per_block > 0 ? w.per_block : 1;
  const int rounds = (pieces + max_warps - 1) / max_warps;
  return 32 * ((pieces + rounds - 1) / rounds);
}

__device__ __forceinline__ void piece_rows(const Work& w, int p, int& row0, int& row1, int& seg) {
  if (p < w.p_ev) {
    seg = p / w.spe;
    row0 = seg * w.nsamp + (p - seg * w.spe) * w.piece;
    row1 = min(row0 + w.piece, (seg + 1) * w.nsamp);
  } else {
    seg = w.nobs;
    row0 = w.n_ev + (p - w.p_ev) * w.piece;
    row1 = min(row0 + w.piece, w.N);
  }
}

// Cheap forms for the places where the result enters a sum of order one, so that an absolute
// error of 4e-7 is harmless: exp of a non-positive number, log(1 + e) and 1/(1 + e) for e in
// [0, 1].  The logarithms that are multiplied by the population's exponents stay logf/log1pf,
// and z, m1 and the bracket positions stay IEEE.
__device__ __forceinline__ float exp_neg(float x) { return __expf(x); }
__device__ __forceinline__ float log1p_unit(float e) { return __logf(1.0f + e); }
__device__ __forceinline__ float recip_1p(float e) { return __fdividef(1.0f, 1.0f + e); }

// a quotient that only a gradient sees
__device__ __forceinline__ float grad_div(float a, float b) { return __fdividef(a, b); }

struct Bracket {
  int lo;
  float t;
  bool slope;  // d t / d pos == 1
};

__device__ __forceinline__ Bracket bracket(float pos, int n) {
  const float lo = fminf(fmaxf(floorf(pos), 0.0f), (float)(n - 2));
  const float traw = pos - lo;
  Bracket b;
  b.lo = (int)lo;
  b.t = fminf(fmaxf(traw, 0.0f), 1.0f);
  b.slope = (traw >= 0.0f) && (traw <= 1.0f);
  return b;
}

struct Mass {
  float ld;    // log dN/dm without log_norm; -inf when dead
  bool dead;   // m < MBH_MIN
  Bracket br;
  float pos, b0, b1, lr;
  float wb, wt;  // weights of the bump and tail branches in logaddexp (0 and 1 on a cut row)
  float sg;      // sigmoid(-(m - mbhmax)/(0.05 mbhmax))
};

__device__ __forceinline__ Mass mass_term(float m, const float* s, const float* bump, int G) {
  Mass r;
  r.pos = (m - s[MBH_LO]) / s[DMBH];  // a true division, as the reference: see evaluate()
  r.br = bracket(r.pos, G);
  r.b0 = bump[r.br.lo];
  r.b1 = bump[r.br.lo + 1];
  const float lb = r.b0 + r.br.t * (r.b1 - r.b0);
  const bool cut = (m <= s[MBH_LO]) || (m >= s[MBH_HI]);
  r.lr = logf(m * s[INV_MBHMAX]);
  const float x = (m - s[MBHMAX]) * s[INV_W];
  const float ex = exp_neg(-fabsf(x));
  const float inv_x = recip_1p(ex);
  r.sg = x >= 0.0f ? ex * inv_x : inv_x;
  const float lt = -s[C_TAIL] * r.lr + s[LPN] + LOG2 - (fmaxf(-x, 0.0f) + log1p_unit(ex));
  // both branches are computed and one is selected: no jump in the row's instruction stream
  const float e = exp_neg(-fabsf(lb - lt));
  const float big = recip_1p(e);
  r.wb = cut ? 0.0f : (lb >= lt ? big : e * big);
  r.wt = cut ? 1.0f : (lb >= lt ? e * big : big);
  r.dead = m < MBH_MIN;
  r.ld = r.dead ? -INFINITY : (cut ? lt : fmaxf(lb, lt) + log1p_unit(e));
  return r;
}

struct Query {
  Bracket bz;
  float posz, z0, z1, j0, j1, z, inv_opz, m1, m2, q, l1pz, lr_zp, sk, lmt;
  Mass w1, w2;
  float out;
};

__device__ __forceinline__ Query evaluate(float4 qv, const float* s, const float2* det, int K,
                                          const float* bump, int G) {
  Query r;
  r.q = qv.y;
  r.posz = (qv.z - s[V0]) / s[DV];
  r.bz = bracket(r.posz, K);
  const float2 e0 = det[r.bz.lo], e1 = det[r.bz.lo + 1];
  r.z0 = e0.x; r.j0 = e0.y; r.z1 = e1.x; r.j1 = e1.y;
  // A bracket position is worth ulp(pos) x the table's local step in the weight, 1e-4 on a rough
  // table, so everything that feeds one (both positions, z, m1) is rounded as the JAX reference
  // and the plain twin round it: true divisions, no fused multiply-add.  The hoisted reciprocals
  // serve the gradients and the smooth terms only.
  r.z = __fadd_rn(r.z0, __fmul_rn(r.bz.t, r.z1 - r.z0));
  const float lj = r.j0 + r.bz.t * (r.j1 - r.j0);
  r.inv_opz = grad_div(1.0f, 1.0f + r.z);  // the backward's
  r.m1 = qv.x / (1.0f + r.z);
  r.m2 = r.q * r.m1;
  r.w1 = mass_term(r.m1, s, bump, G);
  r.w2 = mass_term(r.m2, s, bump, G);
  r.l1pz = log1pf(r.z);
  r.lr_zp = r.l1pz - s[LZP];  // log((1+z)/(1+zp))
  const float y = s[KAPPA] * r.lr_zp;
  const float ey = exp_neg(-fabsf(y));
  const float inv_y = recip_1p(ey);
  r.sk = y >= 0.0f ? inv_y : ey * inv_y;  // sigmoid(kappa log((1+z)/(1+zp)))
  const float log_dndv = s[LAM] * r.l1pz - (fmaxf(y, 0.0f) + log1p_unit(ey)) + s[SP_ZP];
  r.lmt = logf((r.m1 + r.m2) * (1.0f / (MREF * (1.0f + QREF))));
  r.out = (r.w1.ld + s[LNORM]) + (r.w2.ld + s[LNORM]) + s[BETA] * r.lmt + logf(r.m1)
          + log_dndv - 2.0f * r.l1pz + lj - qv.w;
  return r;
}

// Copies the chain's tables and scalars into shared memory and derives the per-chain
// constants; the caller synchronises the block afterwards.
__device__ __forceinline__ void load_tables(const float* det, const float* bump, const float* scal,
                                            int K, int G, int c, float2* s_det, float* s_bump,
                                            float* s_scal) {
  const float2* det_c = reinterpret_cast<const float2*>(det) + (size_t)c * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_det[k] = det_c[k];
  for (int k = threadIdx.x; k < G; k += blockDim.x) s_bump[k] = bump[(size_t)c * G + k];
  if (threadIdx.x < NS) s_scal[threadIdx.x] = scal[(size_t)c * NS + threadIdx.x];
  if (threadIdx.x == 32 % blockDim.x) {
    const float* g = scal + (size_t)c * NS;
    const float lzp = log1pf(g[ZP]);
    const float y = -g[KAPPA] * lzp;
    const float ey = expf(-fabsf(y));
    const float inv_y = 1.0f / (1.0f + ey);
    s_scal[INV_DV] = 1.0f / g[DV];
    s_scal[INV_DMBH] = 1.0f / g[DMBH];
    s_scal[INV_MBHMAX] = 1.0f / g[MBHMAX];
    s_scal[INV_W] = 1.0f / (0.05f * g[MBHMAX]);
    s_scal[LZP] = lzp;
    s_scal[SP_ZP] = fmaxf(y, 0.0f) + log1pf(ey);    // softplus(-kappa log1p(zp))
    s_scal[SG_ZP] = y >= 0.0f ? inv_y : ey * inv_y;  // sigmoid(-kappa log1p(zp))
    s_scal[INV_OPZP] = 1.0f / (1.0f + g[ZP]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// (m, s) <- the pair of log(s exp(m) + s2 exp(m2)); an empty pair is (-inf, 0)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) {
    s = 0.0f;
  } else {
    s = s * exp_neg(m - mm) + s2 * exp_neg(m2 - mm);
  }
  m = mm;
}

// all lanes end with the merge of the warp's 32 pairs
__device__ __forceinline__ void warp_lse_merge(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, off);
    const float s2 = __shfl_xor_sync(FULL, s, off);
    lse_merge(m, s, m2, s2);
  }
}

template <bool LSE, bool PER_CHAIN>
__global__ void __launch_bounds__(32 * WARPS_FWD)
logwts_fwd_kernel(const float* __restrict__ det, const float* __restrict__ bump,
                  const float* __restrict__ scal, const float4* __restrict__ qry,
                  float* __restrict__ out, float* __restrict__ lse_ev, float* __restrict__ lse_sel,
                  int K, int G, Work w) {
  extern __shared__ __align__(16) float smem[];
  float2* s_det = reinterpret_cast<float2*>(smem);
  float* s_bump = smem + 2 * K;
  float* s_scal = s_bump + G;
  float* s_pm = s_scal + NSX_PAD;   // (per_block,) piece maxima   (lse only)
  float* s_ps = s_pm + w.per_block;  // (per_block,) piece sums     (lse only)
  float* s_sel = s_ps + w.per_block;  // the (max, sum) pair of the block's selection pieces
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const float4* __restrict__ qc = PER_CHAIN ? qry + (size_t)c * w.N : qry;  // this chain's rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  load_tables(det, bump, scal, K, G, c, s_det, s_bump, s_scal);
  __syncthreads();

  const int p0 = rank * w.per_block;
  const int p1 = min(p0 + w.per_block, w.p_total);
  for (int p = p0 + warp; p < p1; p += nwarps) {
    int row0, row1, seg;
    piece_rows(w, p, row0, row1, seg);
    float o[R_FWD];
#pragma unroll
    for (int j = 0; j < R_FWD; ++j) {
      const int n = row0 + lane + 32 * j;
      o[j] = -INFINITY;
      if (n < row1) o[j] = evaluate(qc[n], s_scal, s_det, K, s_bump, G).out;
    }
    if (!LSE) {
#pragma unroll
      for (int j = 0; j < R_FWD; ++j) {
        const int n = row0 + lane + 32 * j;
        if (n < row1) out[(size_t)c * w.N + n] = o[j];
      }
    } else {
      float m = o[0];
#pragma unroll
      for (int j = 1; j < R_FWD; ++j) m = fmaxf(m, o[j]);
      m = warp_max(m);
      float sum = 0.0f;
      if (m > -INFINITY) {
#pragma unroll
        for (int j = 0; j < R_FWD; ++j) sum += exp_neg(o[j] - m);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        s_pm[p - p0] = m;
        s_ps[p - p0] = sum;
      }
    }
  }

  if (LSE) {
    // the block's own selection pieces first, from its own shared memory
    __syncthreads();
    if (warp == 0) {
      float m = -INFINITY, sum = 0.0f;
      for (int p = max(p0, w.p_ev) + lane; p < p1; p += 32) lse_merge(m, sum, s_pm[p - p0], s_ps[p - p0]);
      warp_lse_merge(m, sum);
      if (lane == 0) {
        s_sel[0] = m;
        s_sel[1] = sum;
      }
    }
    cluster.sync();
    // one warp per segment merges over the cluster: an event's few pieces where they lie,
    // the selection's one pair per block
    for (int seg = rank * nwarps + warp; seg <= w.nobs; seg += CLUSTER * nwarps) {
      float m = -INFINITY, sum = 0.0f;
      if (seg < w.nobs) {
        for (int p = seg * w.spe + lane; p < (seg + 1) * w.spe; p += 32) {
          const int r = p / w.per_block;
          const int i = p - r * w.per_block;
          lse_merge(m, sum, cluster.map_shared_rank(s_pm, r)[i], cluster.map_shared_rank(s_ps, r)[i]);
        }
      } else if (lane < CLUSTER) {
        const float* remote = cluster.map_shared_rank(s_sel, lane);
        lse_merge(m, sum, remote[0], remote[1]);
      }
      warp_lse_merge(m, sum);
      if (lane == 0) {
        const float v = m == -INFINITY ? -INFINITY : m + logf(sum);
        if (seg < w.nobs) lse_ev[(size_t)c * w.nobs + seg] = v;
        else lse_sel[c] = v;
      }
    }
    cluster.sync();  // no block leaves while its shared memory may still be read
  }
}

struct BinAdd {
  int lo;  // add a at lo and b at lo + 1; nothing when lo < 0
  float a, b;
};

// Cotangents of one mass term: scalars into acc, the bump bins into add; returns d ld / d m.
__device__ __forceinline__ float mass_bwd(const Mass& w, float m, float g, const float* s,
                                          float* acc, BinAdd& add) {
  if (w.dead) return 0.0f;
  const float slope = w.br.slope ? (w.b1 - w.b0) : 0.0f;
  const float gwb = g * w.wb;
  if (gwb != 0.0f) {
    add.lo = w.br.lo;
    add.a = gwb * (1.0f - w.br.t);
    add.b = gwb * w.br.t;
  }
  const float gs = gwb * slope * s[INV_DMBH];
  acc[MBH_LO] -= gs;
  acc[DMBH] -= gs * w.pos;
  const float gwt = g * w.wt;
  acc[C_TAIL] -= gwt * w.lr;
  acc[LPN] += gwt;
  acc[MBHMAX] += gwt * (s[C_TAIL] * s[INV_MBHMAX] - w.sg * m * s[INV_W] * s[INV_MBHMAX]);
  return w.wb * slope * s[INV_DMBH] + w.wt * (w.sg * s[INV_W] - grad_div(s[C_TAIL], m));
}

struct RowAdd {
  int lo;  // detector bin; nothing when lo < 0
  float t, gz, g;
  BinAdd b1, b2;
};

// The chain rule of one row with cotangent g != 0.
__device__ __forceinline__ void row_bwd(const Query& r, float g, const float* s, float* acc,
                                        RowAdd& a) {
  // log_norm enters both mass terms after the cut, so it sees every row
  acc[LNORM] += 2.0f * g;
  const float d1 = mass_bwd(r.w1, r.m1, g, s, acc, a.b1);
  const float d2 = mass_bwd(r.w2, r.m2, g, s, acc, a.b2);
  const float mt = r.m1 + r.m2;
  acc[BETA] += g * r.lmt;
  const float dout_dm1 = d1 + r.q * d2 + grad_div(s[BETA] * (1.0f + r.q), mt) + grad_div(1.0f, r.m1);
  const float dout_dz = (-dout_dm1 * r.m1 + s[LAM] - r.sk * s[KAPPA] - 2.0f) * r.inv_opz;
  acc[LAM] += g * r.l1pz;
  acc[KAPPA] += g * (-r.sk * r.lr_zp - s[SG_ZP] * s[LZP]);
  acc[ZP] += g * (r.sk - s[SG_ZP]) * s[KAPPA] * s[INV_OPZP];
  a.lo = r.bz.lo;
  a.t = r.bz.t;
  a.g = g;
  a.gz = g * dout_dz;
  const float dpos = r.bz.slope ? a.gz * (r.z1 - r.z0) + g * (r.j1 - r.j0) : 0.0f;
  acc[V0] -= dpos * s[INV_DV];
  acc[DV] -= dpos * r.posz * s[INV_DV];
}

// A chain's table-cotangent bins in shared memory, in fixed point (see the header): the hi and
// lo words of each bin (bit 63 of lo marks a contribution out of range), and the limit on |v|.
struct Bins {
  unsigned long long* hi;
  unsigned long long* lo;
  float lim;
};

__device__ __forceinline__ void fx_add(const Bins& b, int bin, float v) {
  if (v == 0.0f) return;
  if (!(fabsf(v) < b.lim)) {  // also NaN and inf
    atomicOr(&b.lo[bin], FX_MARK);
    return;
  }
  const double x = rint((double)v * FX_ONE);
  const double h = floor(x * FX_INV_WORD);
  const double l = x - h * FX_WORD;  // exact: an integer in [0, 2^32)
  atomicAdd(&b.hi[bin], (unsigned long long)(long long)h);
  if (l != 0.0) atomicAdd(&b.lo[bin], (unsigned long long)l);
}

__device__ __forceinline__ void add_bins(const BinAdd& a, const Bins& b, int base) {
  if (a.lo >= 0) {
    fx_add(b, base + a.lo, a.a);
    fx_add(b, base + a.lo + 1, a.b);
  }
}

// Adds one row's table cotangents: the detector's 2K interleaved [d z, d log_jac] to det, the bump
// table's G to bump from bump_base on (on ROUTE_SHARED both are the block's bins, the bump's after
// the detector's; on ROUTE_GLOBAL det is the chain's scratch in device memory).
__device__ __forceinline__ void add_row(const RowAdd& a, const Bins& det, const Bins& bump, int bump_base) {
  if (a.lo >= 0) {
    fx_add(det, 2 * a.lo, a.gz * (1.0f - a.t));
    fx_add(det, 2 * a.lo + 2, a.gz * a.t);
    fx_add(det, 2 * a.lo + 1, a.g * (1.0f - a.t));
    fx_add(det, 2 * a.lo + 3, a.g * a.t);
  }
  add_bins(a.b1, bump, bump_base);
  add_bins(a.b2, bump, bump_base);
}

template <bool LSE, bool PER_CHAIN, bool GLOBAL_BINS>
__global__ void __launch_bounds__(32 * WARPS_BWD)
logwts_bwd_kernel(const float* __restrict__ det, const float* __restrict__ bump,
                  const float* __restrict__ scal, const float4* __restrict__ qry,
                  const float* __restrict__ gout, const float* __restrict__ lse_ev,
                  const float* __restrict__ lse_sel, const float* __restrict__ g_ev, int g_ev_s0,
                  int g_ev_s1, const float* __restrict__ g_sel, int g_sel_s0,
                  float* __restrict__ d_det, float* __restrict__ d_bump,
                  float* __restrict__ d_scal, unsigned long long* __restrict__ det_bins, int K, int G,
                  Work w) {
  extern __shared__ __align__(16) float smem[];
  const int nb = 2 * K + G;                   // table-cotangent bins
  const int k_sh = GLOBAL_BINS ? 0 : K;       // detector rows (table and bins) in shared memory
  const int nb_sh = 2 * k_sh + G;             // bins in shared memory
  const int bump_base = 2 * k_sh;             // the bump's first bin there
  Bins bins;
  bins.hi = reinterpret_cast<unsigned long long*>(smem);          // (nb_sh,)
  bins.lo = bins.hi + nb_sh;                                      // (nb_sh,)
  float2* s_det = reinterpret_cast<float2*>(bins.lo + nb_sh);     // (k_sh,)
  float* s_bump = reinterpret_cast<float*>(s_det + k_sh);         // (G,)
  float* s_scal = s_bump + G;                                     // (NSX_PAD,)
  float* s_dscal = s_scal + NSX_PAD;                              // (NS_PAD,)
  float* s_red = s_dscal + NS_PAD;                                // (NACC, blockDim.x)
  bins.lim = FX_RANGE / (float)max(w.N, 1);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const float4* __restrict__ qc = PER_CHAIN ? qry + (size_t)c * w.N : qry;  // this chain's rows
  const float2* tab = GLOBAL_BINS ? reinterpret_cast<const float2*>(det) + (size_t)c * K : s_det;
  Bins dbins = bins;  // the detector's bins
  if (GLOBAL_BINS) {
    dbins.hi = det_bins + (size_t)c * 4 * K;
    dbins.lo = dbins.hi + 2 * K;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  load_tables(det, bump, scal, k_sh, G, c, s_det, s_bump, s_scal);
  for (int k = threadIdx.x; k < nb_sh; k += blockDim.x) {
    bins.hi[k] = 0ull;
    bins.lo[k] = 0ull;
  }
  if (threadIdx.x < NS_PAD) s_dscal[threadIdx.x] = 0.0f;
  __syncthreads();

  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;

  const int p0 = rank * w.per_block;
  const int p1 = min(p0 + w.per_block, w.p_total);
  for (int p = p0 + warp; p < p1; p += nwarps) {
    int row0, row1, seg;
    piece_rows(w, p, row0, row1, seg);
    float g_seg = 0.0f, l_seg = 0.0f;
    if (LSE) {
      if (seg < w.nobs) {
        g_seg = g_ev[(size_t)c * g_ev_s0 + (size_t)seg * g_ev_s1];
        l_seg = lse_ev[(size_t)c * w.nobs + seg];
      } else {
        g_seg = g_sel[(size_t)c * g_sel_s0];
        l_seg = lse_sel[c];
      }
    }
    RowAdd adds[R_BWD];
#pragma unroll
    for (int j = 0; j < R_BWD; ++j) {
      const int n = row0 + lane + 32 * j;
      adds[j].lo = -1;
      adds[j].b1.lo = -1;
      adds[j].b2.lo = -1;
      if (n < row1) {
        if (LSE) {
          if (g_seg != 0.0f) {
            const Query r = evaluate(qc[n], s_scal, tab, K, s_bump, G);
            // a -inf row has cotangent exactly 0 (and every row of an all-dead segment is one)
            const float g = r.out == -INFINITY ? 0.0f : g_seg * exp_neg(r.out - l_seg);
            if (g != 0.0f) row_bwd(r, g, s_scal, acc, adds[j]);
          }
        } else {
          const float g = gout[(size_t)c * w.N + n];
          if (g != 0.0f) {
            const Query r = evaluate(qc[n], s_scal, tab, K, s_bump, G);
            row_bwd(r, g, s_scal, acc, adds[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R_BWD; ++j) add_row(adds[j], dbins, bins, bump_base);
  }

  // the block's scalar cotangents: once through shared memory, one warp per slot
#pragma unroll
  for (int k = 0; k < NACC; ++k) s_red[k * blockDim.x + threadIdx.x] = acc[k];
  __syncthreads();
  for (int k = warp; k < NACC; k += nwarps) {
    float v = 0.0f;
    for (int i = lane; i < (int)blockDim.x; i += 32) v += s_red[k * blockDim.x + i];
    v = warp_sum(v);
    if (lane == 0) s_dscal[k] = v;
  }

  // the chain's cotangents: each block sums an eighth of the values over the cluster, in rank order
  // (on ROUTE_GLOBAL the detector's bins are already summed, in L2: the fence orders this thread's
  // atomics before the cluster's barrier, after which every block of the chain has added its rows)
  if (GLOBAL_BINS) __threadfence();
  cluster.sync();
  const float nan = __int_as_float(0x7fc00000);
  for (int i = rank * blockDim.x + threadIdx.x; i < nb + NS; i += CLUSTER * blockDim.x) {
    if (i < nb) {
      unsigned long long hi = 0ull, lo = 0ull, bad = 0ull;
      if (GLOBAL_BINS && i < 2 * K) {
        const unsigned long long l = __ldcg(&dbins.lo[i]);
        hi = __ldcg(&dbins.hi[i]);
        lo = l & ~FX_MARK;
        bad = l & FX_MARK;
      } else {
        const int j = i - 2 * K + bump_base;  // i on ROUTE_SHARED
#pragma unroll
        for (int r = 0; r < CLUSTER; ++r) {
          const unsigned long long l = cluster.map_shared_rank(bins.lo, r)[j];
          hi += cluster.map_shared_rank(bins.hi, r)[j];
          lo += l & ~FX_MARK;
          bad |= l & FX_MARK;
        }
      }
      const float v = bad ? nan : (float)((double)(long long)hi * FX_HI_UNIT + (double)lo * FX_LO_UNIT);
      if (i < 2 * K) d_det[(size_t)c * 2 * K + i] = v;
      else d_bump[(size_t)c * G + (i - 2 * K)] = v;
    } else {
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) v += cluster.map_shared_rank(s_dscal, r)[i - nb];
      d_scal[(size_t)c * NS + (i - nb)] = v;
    }
  }
  cluster.sync();  // no block leaves while its shared memory may still be read
}

size_t fwd_smem(int K, int G, const Work& w, bool lse) {
  return (2 * (size_t)K + G + NSX_PAD + (lse ? 2 * (size_t)w.per_block + 2 : 0)) * sizeof(float);
}

// global_bins: ROUTE_GLOBAL, whose shared memory holds no detector row
size_t bwd_smem(int K, int G, int threads, bool global_bins) {
  const size_t k_sh = global_bins ? 0 : (size_t)K;
  const size_t nb = 2 * k_sh + G;
  return nb * 2 * sizeof(unsigned long long)
         + (2 * k_sh + G + NSX_PAD + NS_PAD + (size_t)NACC * threads) * sizeof(float);
}

bool bad_shape(int C, int K, int G, int N, int qry_cs, int nobs, int nsamp) {  // qry_cs: 0 or N
  return C < 0 || C > 65535 || K < 2 || G < 2 || N < 0 || (qry_cs != 0 && qry_cs != N) || nobs < 0
         || (nobs > 0 && nsamp < 1) || (long long)nobs * nsamp > N;
}

constexpr int MAX_DEVICES = 64;
constexpr int ERR_SMEM = -1;  // a launch that needs more shared memory than a block of the device has
enum Route { ROUTE_SHARED = 0, ROUTE_GLOBAL = 1 };  // where the backward keeps its detector bins

// The most dynamic shared memory a block of the current device may use (read once per device).
cudaError_t smem_optin(size_t& most) {
  static int cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int v = dev < MAX_DEVICES ? cached[dev] : 0;
  if (v == 0) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) cached[dev] = v;
  }
  most = (size_t)v;
  return cudaSuccess;
}

// The backward's route at this shape on the current device, from the shape alone: ROUTE_SHARED
// while its bins and tables fit in a block's shared memory, else ROUTE_GLOBAL while the forward at
// the same shape fits; else ERR_SMEM.  Returns 0, a CUDA error or ERR_SMEM.
int bwd_route(bool lse, int K, int G, int N, int nobs, int nsamp, int& route) {
  const Work wb = make_work(N, nobs, nsamp, R_BWD);
  const int threads = pick_threads(wb, WARPS_BWD);
  const size_t shared = bwd_smem(K, G, threads, false);
  route = ROUTE_SHARED;
  if (shared <= 48 * 1024) return 0;
  size_t most = 0;
  const cudaError_t err = smem_optin(most);
  if (err != cudaSuccess) return (int)err;
  if (shared <= most) return 0;
  route = ROUTE_GLOBAL;
  const Work wf = make_work(N, nobs, nsamp, R_FWD);
  return fwd_smem(K, G, wf, lse) <= most && bwd_smem(K, G, threads, true) <= most ? 0 : ERR_SMEM;
}

// The most dynamic shared memory a kernel has been allowed so far on each device, so that the
// attribute is set when a launch first needs more than the default 48 KB, not on every launch.
struct SmemAllowed {
  size_t bytes[MAX_DEVICES] = {};
};

// One cluster of CLUSTER blocks per chain.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, SmemAllowed& allowed, int C, int threads, size_t smem, void* stream,
           Args... args) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || smem > allowed.bytes[dev]) {
      int most = 0;
      err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return (int)err;
      if (smem > (size_t)most) return ERR_SMEM;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) allowed.bytes[dev] = smem;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, C, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward of either epilogue on the route its shape takes; on ROUTE_GLOBAL the scratch
// det_bins is zeroed on the stream first.
template <bool LSE>
int launch_bwd(int C, int K, int G, int qry_cs, int nobs, int nsamp, unsigned long long* det_bins,
               void* stream, const float* det, const float* bump, const float* scal, const float* qry,
               const float* gout, const float* lse_ev, const float* lse_sel, const float* g_ev,
               int g_ev_s0, int g_ev_s1, const float* g_sel, int g_sel_s0, float* d_det,
               float* d_bump, float* d_scal, const Work& w) {
  static SmemAllowed allowed[2][2];  // [route][query layout]
  int route = ROUTE_SHARED;
  const int rc = bwd_route(LSE, K, G, w.N, nobs, nsamp, route);
  if (rc != 0) return rc;
  const bool global = route == ROUTE_GLOBAL;
  if (global) {
    if (det_bins == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(det_bins, 0, (size_t)C * 4 * K * sizeof(unsigned long long),
                                            (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = global ? (qry_cs ? &logwts_bwd_kernel<LSE, true, true> : &logwts_bwd_kernel<LSE, false, true>)
                             : (qry_cs ? &logwts_bwd_kernel<LSE, true, false> : &logwts_bwd_kernel<LSE, false, false>);
  const int threads = pick_threads(w, WARPS_BWD);
  return launch(kernel, allowed[global][qry_cs != 0], C, threads, bwd_smem(K, G, threads, global), stream,
                det, bump, scal, reinterpret_cast<const float4*>(qry), gout, lse_ev, lse_sel, g_ev, g_ev_s0,
                g_ev_s1, g_sel, g_sel_s0, d_det, d_bump, d_scal, det_bins, K, G, w);
}

}  // namespace

extern "C" int logwts_fwd(const float* det, const float* bump, const float* scal, const float* qry,
                          float* out, int C, int K, int G, int N, int qry_cs, void* stream) {
  if (bad_shape(C, K, G, N, qry_cs, 0, 1)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const Work w = make_work(N, 0, 1, R_FWD);
  static SmemAllowed allowed[2];
  return launch(qry_cs ? &logwts_fwd_kernel<false, true> : &logwts_fwd_kernel<false, false>,
                allowed[qry_cs != 0], C, pick_threads(w, WARPS_FWD), fwd_smem(K, G, w, false), stream,
                det, bump, scal, reinterpret_cast<const float4*>(qry), out, (float*)nullptr,
                (float*)nullptr, K, G, w);
}

extern "C" int logwts_bwd(const float* det, const float* bump, const float* scal, const float* qry,
                          const float* gout, float* d_det, float* d_bump, float* d_scal,
                          unsigned long long* det_bins, int C, int K, int G, int N, int qry_cs,
                          void* stream) {
  if (bad_shape(C, K, G, N, qry_cs, 0, 1) || N >= FX_MAX_N) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  return launch_bwd<false>(C, K, G, qry_cs, 0, 1, det_bins, stream, det, bump, scal, qry, gout,
                           (const float*)nullptr, (const float*)nullptr, (const float*)nullptr, 0, 0,
                           (const float*)nullptr, 0, d_det, d_bump, d_scal, make_work(N, 0, 1, R_BWD));
}

extern "C" int logwts_lse_fwd(const float* det, const float* bump, const float* scal,
                              const float* qry, float* lse_ev, float* lse_sel, int C, int K, int G,
                              int N, int qry_cs, int nobs, int nsamp, void* stream) {
  if (bad_shape(C, K, G, N, qry_cs, nobs, nsamp)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const Work w = make_work(N, nobs, nsamp, R_FWD);
  static SmemAllowed allowed[2];
  return launch(qry_cs ? &logwts_fwd_kernel<true, true> : &logwts_fwd_kernel<true, false>,
                allowed[qry_cs != 0], C, pick_threads(w, WARPS_FWD), fwd_smem(K, G, w, true), stream,
                det, bump, scal, reinterpret_cast<const float4*>(qry), (float*)nullptr, lse_ev,
                lse_sel, K, G, w);
}

extern "C" int logwts_lse_bwd(const float* det, const float* bump, const float* scal,
                              const float* qry, const float* lse_ev, const float* lse_sel,
                              const float* g_ev, int g_ev_s0, int g_ev_s1, const float* g_sel,
                              int g_sel_s0, float* d_det, float* d_bump, float* d_scal,
                              unsigned long long* det_bins, int C, int K, int G, int N, int qry_cs,
                              int nobs, int nsamp, void* stream) {
  if (bad_shape(C, K, G, N, qry_cs, nobs, nsamp) || N >= FX_MAX_N) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  return launch_bwd<true>(C, K, G, qry_cs, nobs, nsamp, det_bins, stream, det, bump, scal, qry,
                          (const float*)nullptr, lse_ev, lse_sel, g_ev, g_ev_s0, g_ev_s1, g_sel, g_sel_s0,
                          d_det, d_bump, d_scal, make_work(N, nobs, nsamp, R_BWD));
}

// The route the backward of an epilogue (lse: 1 for lse, 0 for rows, with nobs = 0, nsamp = 1) takes
// at this shape on the current device, into *route (ROUTE_SHARED 0, ROUTE_GLOBAL 1, which needs a
// (C, 2, 2K) int64 det_bins).  Returns 0, a CUDA error, or ERR_SMEM beyond the forward's limit.
extern "C" int logwts_bwd_route(int lse, int K, int G, int N, int nobs, int nsamp, int* route) {
  if (bad_shape(1, K, G, N, 0, nobs, nsamp) || N >= FX_MAX_N) return (int)cudaErrorInvalidValue;
  return bwd_route(lse != 0, K, G, N, nobs, nsamp, *route);
}

// The most detector-table rows K that a launch at (G, N, nobs, nsamp) fits in the shared memory of
// a block of the current device (nobs = 0: the rows epilogue), or a negative CUDA error: the
// forward's limit, and the backward's, which is the forward's wherever ROUTE_GLOBAL fits (its shared
// memory does not grow with K).  The wrappers call it to name the limit when a shape is refused.
extern "C" int logwts_max_k(int backward, int G, int N, int nobs, int nsamp) {
  size_t most = 0;
  const cudaError_t err = smem_optin(most);
  if (err != cudaSuccess) return -(int)err;
  const bool lse = nobs > 0;
  const Work wf = make_work(N, lse ? nobs : 0, lse ? nsamp : 1, R_FWD);
  const Work wb = make_work(N, lse ? nobs : 0, lse ? nsamp : 1, R_BWD);
  const int threads = pick_threads(wb, WARPS_BWD);
  auto largest = [&](auto smem) {
    const size_t at0 = smem(0), per_k = smem(1) - at0;
    return most < at0 ? 0 : (int)((most - at0) / per_k);
  };
  const int fwd = largest([&](int K) { return fwd_smem(K, G, wf, lse); });
  if (!backward) return fwd;
  const int shared = largest([&](int K) { return bwd_smem(K, G, threads, false); });
  return bwd_smem(0, G, threads, true) <= most && fwd > shared ? fwd : shared;
}
