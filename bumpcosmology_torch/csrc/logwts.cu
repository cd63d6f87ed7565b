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
// not by instruction rate; the backward takes 63 us, of which 33 us are its shared-memory float
// atomics (17 us the bump bins, 11 us the detector bins: measured with builds that left them
// out and so gave wrong cotangents; those builds are not kept).
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
//     rows; table cotangents go to the block's shared-memory bins with atomicAdd; the scalars
//     are reduced once per block through shared memory; after cluster.sync() each block sums
//     an eighth of the (2K + G + 15) values over the 8 blocks' shared memory in a fixed order
//     and stores them.  Every output element is written exactly once: nothing is zeroed by the
//     caller and no global atomic is used.
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
//     What would remove the atomics is rows sorted by bin inside each segment when the query
//     table is built, so that neighbouring lanes share a bin and a segmented shuffle adds them
//     first; a combine belongs with that table, not before it.
//   * Alternative not taken: per-block partials in a scratch tensor, combined by the last
//     block to finish (__threadfence and one atomic ticket per chain).  It needs a zeroed
//     ticket per launch (a memset, or a reset by the last block that a failed launch would
//     leave dirty) and a round trip through L2 where the cluster reads its neighbours'
//     shared memory directly; it was not built, so no time is given for it.
//
// C interface (bound with ctypes), float32, contiguous unless strides are given:
//   det (C,K,2) [z, log_jac]; bump (C,G); scal (C,15); qry (N,4) [a, q, log dL, log pdraw];
//   out, gout (C,N); lse_ev (C,nobs); lse_sel (C,); g_ev (C,nobs) with element strides
//   (g_ev_s0, g_ev_s1); g_sel (C,) with element stride g_sel_s0;
//   d_det (C,K,2), d_bump (C,G), d_scal (C,15) are written in full.
//   Each function returns the CUDA error of its launch (0 on success).

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

template <bool LSE>
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
      if (n < row1) o[j] = evaluate(qry[n], s_scal, s_det, K, s_bump, G).out;
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

__device__ __forceinline__ void add_bins(const BinAdd& b, float* s_dbump) {
  if (b.lo >= 0) {
    atomicAdd(&s_dbump[b.lo], b.a);
    atomicAdd(&s_dbump[b.lo + 1], b.b);
  }
}

// Adds one row's table cotangents to the block's shared-memory bins.
__device__ __forceinline__ void add_row(const RowAdd& a, float* s_ddet, float* s_dbump) {
  if (a.lo >= 0) {
    atomicAdd(&s_ddet[2 * a.lo], a.gz * (1.0f - a.t));
    atomicAdd(&s_ddet[2 * a.lo + 2], a.gz * a.t);
    atomicAdd(&s_ddet[2 * a.lo + 1], a.g * (1.0f - a.t));
    atomicAdd(&s_ddet[2 * a.lo + 3], a.g * a.t);
  }
  add_bins(a.b1, s_dbump);
  add_bins(a.b2, s_dbump);
}

template <bool LSE>
__global__ void __launch_bounds__(32 * WARPS_BWD)
logwts_bwd_kernel(const float* __restrict__ det, const float* __restrict__ bump,
                  const float* __restrict__ scal, const float4* __restrict__ qry,
                  const float* __restrict__ gout, const float* __restrict__ lse_ev,
                  const float* __restrict__ lse_sel, const float* __restrict__ g_ev, int g_ev_s0,
                  int g_ev_s1, const float* __restrict__ g_sel, int g_sel_s0,
                  float* __restrict__ d_det, float* __restrict__ d_bump,
                  float* __restrict__ d_scal, int K, int G, Work w) {
  extern __shared__ __align__(16) float smem[];
  float2* s_det = reinterpret_cast<float2*>(smem);
  float* s_bump = smem + 2 * K;
  float* s_scal = s_bump + G;
  float* s_ddet = s_scal + NSX_PAD;  // (2K,) interleaved [d z, d log_jac]
  float* s_dbump = s_ddet + 2 * K;   // (G,)
  float* s_dscal = s_dbump + G;      // (NS_PAD,)
  float* s_red = s_dscal + NS_PAD;   // (NACC, blockDim.x)
  const int n_out = 2 * K + G + NS_PAD;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  load_tables(det, bump, scal, K, G, c, s_det, s_bump, s_scal);
  for (int k = threadIdx.x; k < n_out; k += blockDim.x) s_ddet[k] = 0.0f;
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
            const Query r = evaluate(qry[n], s_scal, s_det, K, s_bump, G);
            // a -inf row has cotangent exactly 0 (and every row of an all-dead segment is one)
            const float g = r.out == -INFINITY ? 0.0f : g_seg * exp_neg(r.out - l_seg);
            if (g != 0.0f) row_bwd(r, g, s_scal, acc, adds[j]);
          }
        } else {
          const float g = gout[(size_t)c * w.N + n];
          if (g != 0.0f) {
            const Query r = evaluate(qry[n], s_scal, s_det, K, s_bump, G);
            row_bwd(r, g, s_scal, acc, adds[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R_BWD; ++j) add_row(adds[j], s_ddet, s_dbump);
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

  // the chain's cotangents: each block sums an eighth of the values over the cluster
  cluster.sync();
  for (int i = rank * blockDim.x + threadIdx.x; i < n_out; i += CLUSTER * blockDim.x) {
    float v = 0.0f;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) v += cluster.map_shared_rank(s_ddet, r)[i];
    if (i < 2 * K) {
      d_det[(size_t)c * 2 * K + i] = v;
    } else if (i < 2 * K + G) {
      d_bump[(size_t)c * G + (i - 2 * K)] = v;
    } else if (i - 2 * K - G < NS) {
      d_scal[(size_t)c * NS + (i - 2 * K - G)] = v;
    }
  }
  cluster.sync();  // no block leaves while its shared memory may still be read
}

size_t fwd_smem(int K, int G, const Work& w, bool lse) {
  return (2 * (size_t)K + G + NSX_PAD + (lse ? 2 * (size_t)w.per_block + 2 : 0)) * sizeof(float);
}

size_t bwd_smem(int K, int G, int threads) {
  return (4 * (size_t)K + 2 * (size_t)G + NSX_PAD + NS_PAD + (size_t)NACC * threads) * sizeof(float);
}

bool bad_shape(int C, int K, int G, int N, int nobs, int nsamp) {
  return C < 0 || C > 65535 || K < 2 || G < 2 || N < 0 || nobs < 0 || (nobs > 0 && nsamp < 1)
         || (long long)nobs * nsamp > N;
}

constexpr int MAX_DEVICES = 64;

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

}  // namespace

extern "C" int logwts_fwd(const float* det, const float* bump, const float* scal, const float* qry,
                          float* out, int C, int K, int G, int N, void* stream) {
  if (bad_shape(C, K, G, N, 0, 1)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const Work w = make_work(N, 0, 1, R_FWD);
  static SmemAllowed allowed;
  return launch(logwts_fwd_kernel<false>, allowed, C, pick_threads(w, WARPS_FWD),
                fwd_smem(K, G, w, false), stream, det, bump, scal,
                reinterpret_cast<const float4*>(qry), out, (float*)nullptr, (float*)nullptr, K, G, w);
}

extern "C" int logwts_bwd(const float* det, const float* bump, const float* scal, const float* qry,
                          const float* gout, float* d_det, float* d_bump, float* d_scal,
                          int C, int K, int G, int N, void* stream) {
  if (bad_shape(C, K, G, N, 0, 1)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const Work w = make_work(N, 0, 1, R_BWD);
  const int threads = pick_threads(w, WARPS_BWD);
  static SmemAllowed allowed;
  return launch(logwts_bwd_kernel<false>, allowed, C, threads, bwd_smem(K, G, threads), stream,
                det, bump, scal, reinterpret_cast<const float4*>(qry), gout, (const float*)nullptr,
                (const float*)nullptr, (const float*)nullptr, 0, 0, (const float*)nullptr, 0,
                d_det, d_bump, d_scal, K, G, w);
}

extern "C" int logwts_lse_fwd(const float* det, const float* bump, const float* scal,
                              const float* qry, float* lse_ev, float* lse_sel, int C, int K, int G,
                              int N, int nobs, int nsamp, void* stream) {
  if (bad_shape(C, K, G, N, nobs, nsamp)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const Work w = make_work(N, nobs, nsamp, R_FWD);
  static SmemAllowed allowed;
  return launch(logwts_fwd_kernel<true>, allowed, C, pick_threads(w, WARPS_FWD),
                fwd_smem(K, G, w, true), stream, det, bump, scal,
                reinterpret_cast<const float4*>(qry), (float*)nullptr, lse_ev, lse_sel, K, G, w);
}

extern "C" int logwts_lse_bwd(const float* det, const float* bump, const float* scal,
                              const float* qry, const float* lse_ev, const float* lse_sel,
                              const float* g_ev, int g_ev_s0, int g_ev_s1, const float* g_sel,
                              int g_sel_s0, float* d_det, float* d_bump, float* d_scal, int C,
                              int K, int G, int N, int nobs, int nsamp, void* stream) {
  if (bad_shape(C, K, G, N, nobs, nsamp)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const Work w = make_work(N, nobs, nsamp, R_BWD);
  const int threads = pick_threads(w, WARPS_BWD);
  static SmemAllowed allowed;
  return launch(logwts_bwd_kernel<true>, allowed, C, threads, bwd_smem(K, G, threads), stream,
                det, bump, scal, reinterpret_cast<const float4*>(qry), (const float*)nullptr,
                lse_ev, lse_sel, g_ev, g_ev_s0, g_ev_s1, g_sel, g_sel_s0, d_det, d_bump, d_scal,
                K, G, w);
}
