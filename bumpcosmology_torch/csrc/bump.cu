// Kernel A: the per-draw PISN-bump table, forward and backward, batched over chains.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas_bump.py:
//   forward  _bump_fwd_impl -> _fwd_kernel (pallas_bump.py:177, :62)
//   backward _bump_vjp_bwd  -> _bwd_kernel (pallas_bump.py:199, :74)
//
// For one draw (a, b, mpisn, mbhmax, sigma) the table is
//   out_i = log(dmco/2) + log sum_j c_j exp(K_ij),   c_j = 1, 2, ..., 2, 1
//   K_ij  = logc(mco_j) - r_ij^2/2 - log(sqrt(2 pi) sigma),  r_ij = (mbh_i - mu(mco_j)) / sigma
// on the theta-dependent grids mbh_i = 3 + i*dmbh over [3, mbhmax + 7 sigma] and
// mco_j = 1 + j*dmco over [1, largest_mco].  The backward is the analytic VJP to the
// five scalars of pallas_bump.py:87-137, grid-motion and trapezoid-measure terms included.
//
// What bounds it on an H100.  The work is tiny: C*G*G cells (1.05 M at C = 16, G = 256) of
// one exp and 9 (forward) or 16 (backward) FP32 operations each, against 20 bytes in and 4 G
// bytes out per chain.  The special-function unit (16 results per clock per SM) and the FP32
// pipes would both be done in a quarter of a microsecond; an empty launch of the forward's
// grid takes 1.25 us and of the backward's clusters 2.0 us.  So the kernel is bound by latency:
// the launch floor first, then the longest chain of dependent steps any thread runs.  Measured
// (H100 80GB HBM3, 700 W; chip_smoke.py phase 2 and bumpcosmology_torch/tools/kernel_times.py):
// forward 3.0 us, backward 5.8 us; the one-block-per-chain kernels before them took 21.6 and
// 21.0 us.  What the design does about the latency:
//
//   * Rows over warps, columns over lanes.  A warp owns one BH-mass row i at a time and its
//     lanes split the CO-mass columns j, 8 columns a lane per pass of 256 (two float4 of each
//     per-column table, float4 number lane and lane + 32, which no two lanes of a quarter-warp
//     read through one bank; 8 adjacent columns a lane cost 1.2 us in bank conflicts).  A chain
//     has BLOCKS = 8 blocks, so 16 chains are 128 blocks on 132 SMs.
//   * Small blocks.  16 warps forward and 8 backward, so a warp runs 2 or 4 rows one after the
//     other at G = 256.  One row a warp (32 warps) was no faster forward and much slower
//     backward: a block of 1024 threads at 64 registers takes a whole SM, only 15 clusters of 8
//     such blocks fit the card at once, and the 16th chain waited for a second wave (12 us).
//   * No dependent chain along j.  A lane computes its 8 exponents (independent FMAs), the warp
//     takes their maximum by shuffles, then each lane sums exp(k - max) over its 8 values and
//     the warp sums by shuffles: torch.logsumexp's arithmetic, with no branch and no rescale.
//     For G > 256 a warp makes further passes of 256 columns and merges them online, one
//     rescale per pass; columns past G carry -inf (and zeros in the derivative tables).
//   * Everything that depends on j alone is computed once per block into shared memory before
//     the warps start: mu_j and logc_j + log c_j - log(sqrt(2 pi) sigma) forward; in the
//     backward also the five derivative columns below.  One IEEE logf a column.
//   * The backward sums moments, not cotangents.  With w = c_j exp(K_ij - L_i) every cotangent
//     of row i is linear in eight sums over j (w, w r, w r^2, w la_j, w lb_j, w X_j, w r P_j,
//     w r B_j; the tables la, lb, X, P, B fold phi_j and the grid-motion factors in), and the
//     row's own factors (g_i, phi_i) multiply the sums, not the cells: 16 operations a cell in
//     place of 32.  Being linear, the sums need no reduction per row either: a lane folds its
//     partial sums of every row it sees into five cotangents and sum_i g_i, and the block
//     reduces those six once (shuffles, then one __syncthreads and one warp).
//   * No row waits for global memory.  Lane u of a warp loads g and log dN of the warp's u-th
//     row on entry, while the tables are built; a row takes its pair by a shuffle.
//   * One (C, 5) row without atomics, memset or a second launch.  The BLOCKS blocks of a chain
//     are one thread-block cluster.  Each block stores its six sums into the shared memory of
//     the cluster's first block (distributed shared memory), the cluster meets at one barrier,
//     and the first block adds the BLOCKS partials in block order: bit-for-bit the same from run
//     to run.  The barrier that says "every block of the cluster is running", which a remote
//     store needs, is arrived at on entry (relaxed: nothing is published; a releasing arrive
//     there cost 0.5 us) and waited on only before that store, so it costs nothing.  The forward
//     needs no cluster and is a plain grid (its launch floor is lower).
//   * Cheap intrinsics where the result feeds a sum: __expf (ex2.approx after one multiply)
//     under the forward's sum and for the backward's weights w (IEEE expf there cost 0.2 us and
//     brought the result no nearer the float32 reference).  The final logf of a row, log(dmco/2)
//     and the per-column logf(mco/20) stay IEEE.  Grid coordinates stay lo + j*d.
//   * No tensor cores: expanding r^2 into a rank-3 product to reach wgmma would cancel
//     catastrophically in TF32, and the cell is bound by its exp, not by its FMAs.
//   * Tried and left out: two rows a warp in flight at once, sharing each table load (no
//     faster: shared-memory traffic is not the limit once the bank conflicts are gone).
//
// C interface (bound with ctypes), float32, contiguous:
//   params (C,5) = [a, b, mpisn, mbhmax, sigma]; out/logdn/g (C,G); dparams (C,5).
//   Any C in [1, 65535] and G in [2, 8192].  Each function returns the CUDA error of its
//   launch (0 on success; cudaErrorInvalidValue for a shape outside those ranges).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCKS = 8;          // blocks per chain; in the backward they form one cluster
constexpr int WARPS_FWD = 16;      // most warps of a block, forward (two such blocks fit an SM)
constexpr int WARPS_BWD = 8;       // and backward (four such blocks fit an SM)
constexpr int COLS = 8;            // adjacent columns a lane holds per pass (two float4)
constexpr int PASS = 32 * COLS;    // columns a warp covers per pass; tables are padded to it
constexpr int MAX_G = 8192;        // 7 padded tables of the backward within 227 KB of shared memory
constexpr int NSUM = 6;            // the backward's block sums: d a, d b, d mpisn, d mbhmax, d sigma, sum g
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG_2PI = 1.8378770664093453f;
constexpr float LOG2 = 0.69314718055994531f;
constexpr float MCO_BREAK = 20.0f;
constexpr float GRID_MBH_LO = 3.0f;
constexpr float GRID_MCO_LO = 1.0f;

struct Packed {
  float a, b, mpisn, mbhmax, sigma;
  float dmbh, dmco, dmcohi_dmpisn, dmcohi_dmbhmax;
  float curv, mco_peak;
};

// _pack_scalars (pallas_bump.py:140-155), per chain.
__device__ __forceinline__ Packed pack(const float* p, int G) {
  Packed s;
  s.a = p[0]; s.b = p[1]; s.mpisn = p[2]; s.mbhmax = p[3]; s.sigma = p[4];
  const float gm1 = (float)(G - 1);
  const float mbh_hi = s.mbhmax + 7.0f * s.sigma;
  const float root = sqrtf(s.mbhmax * (s.mbhmax - s.mpisn));
  const float mco_hi = 2.0f * s.mbhmax - s.mpisn + 2.0f * root;
  s.dmbh = (mbh_hi - GRID_MBH_LO) / gm1;
  s.dmco = (mco_hi - GRID_MCO_LO) / gm1;
  s.dmcohi_dmpisn = -1.0f - s.mbhmax / root;
  s.dmcohi_dmbhmax = 2.0f + (2.0f * s.mbhmax - s.mpisn) / root;
  s.curv = 1.0f / (4.0f * (s.mpisn - s.mbhmax));
  s.mco_peak = 2.0f * s.mbhmax - s.mpisn;
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The same value in every lane, summed in an order that depends on nothing but the lane ids.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// A lane's COLS entries of one pass (columns j0 .. j0 + PASS - 1) of a padded per-column table:
// float4 number lane, then lane + 32, so that the warp reads 512 adjacent bytes at a time and
// no two lanes of a quarter-warp meet in a bank.
__device__ __forceinline__ void load_cols(const float* table, int j0, int lane, float (&v)[COLS]) {
#pragma unroll
  for (int q = 0; q < COLS / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(table + j0)[lane + 32 * q];
    v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
  }
}

__host__ __device__ __forceinline__ int padded(int G) { return (G + PASS - 1) / PASS * PASS; }

// grid (BLOCKS, C); block 32 * warps threads; dynamic shared memory 2 * padded(G) floats
__global__ void __launch_bounds__(32 * WARPS_FWD, 2)
bump_fwd_kernel(const float* __restrict__ params, float* __restrict__ out, int G) {
  extern __shared__ float4 smem4[];
  const int Gp = padded(G);
  float* s_mu = reinterpret_cast<float*>(smem4);  // (Gp,) mu(mco_j)
  float* s_logc = s_mu + Gp;  // (Gp,) logc(mco_j) + log c_j - log(sqrt(2 pi) sigma); -inf past G
  const int c = blockIdx.y;
  const Packed s = pack(params + 5 * c, G);
  const float log_norm = -0.5f * LOG_2PI - logf(s.sigma);
  for (int j = threadIdx.x; j < Gp; j += blockDim.x) {
    const float mco = GRID_MCO_LO + (float)j * s.dmco;
    const float d = mco - s.mco_peak;
    const float lj = logf(mco / MCO_BREAK);
    const float logc = (mco >= MCO_BREAK) ? -s.b * lj : -s.a * lj;
    const float trap = (j == 0 || j == G - 1) ? 0.0f : LOG2;  // log c_j
    const bool live = j < G;
    s_mu[j] = !live ? 0.0f : (mco >= s.mpisn) ? s.mbhmax + s.curv * d * d : mco;
    s_logc[j] = live ? logc + trap + log_norm : -INFINITY;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float inv_sigma = 1.0f / s.sigma;
  const float log_half_dmco = logf(0.5f * s.dmco);
  for (int i = blockIdx.x * warps + warp; i < G; i += BLOCKS * warps) {
    const float mbh = GRID_MBH_LO + (float)i * s.dmbh;
    float m = -INFINITY, acc = 0.0f;  // merged over passes; one pass at G <= 256
    for (int j0 = 0; j0 < Gp; j0 += PASS) {
      float mu[COLS], k[COLS];
      load_cols(s_mu, j0, lane, mu);
      load_cols(s_logc, j0, lane, k);
      float top = -INFINITY;
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        const float r = (mbh - mu[t]) * inv_sigma;
        k[t] = fmaf(-0.5f * r, r, k[t]);
        top = fmaxf(top, k[t]);
      }
      const float m_new = fmaxf(m, warp_max(top));  // finite: every pass holds a live column
      float part = 0.0f;
#pragma unroll
      for (int t = 0; t < COLS; ++t) part += __expf(k[t] - m_new);
      acc = fmaf(acc, __expf(m - m_new), part);
      m = m_new;
    }
    acc = warp_sum(acc);
    if (lane == 0) out[(size_t)c * G + i] = m + logf(acc) + log_half_dmco;
  }
}

// "This block runs": nothing is published, so no memory ordering is asked for.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// grid (BLOCKS, C) in clusters of BLOCKS; block 32 * warps threads; dynamic shared memory
// 7 * padded(G) + NSUM * (WARPS_BWD + BLOCKS) floats
__global__ void __launch_bounds__(32 * WARPS_BWD, 4)
bump_bwd_kernel(const float* __restrict__ params, const float* __restrict__ logdn,
                const float* __restrict__ g, float* __restrict__ dparams, int G) {
  cluster_arrive_relaxed();  // waited on before the store into the first block
  extern __shared__ float4 smem4[];
  const int Gp = padded(G);
  float* s_mu = reinterpret_cast<float*>(smem4);  // mu(mco_j)
  float* s_logc = s_mu + Gp;   // logc_j + log c_j - log(sqrt(2 pi) sigma); -inf past G
  float* s_la = s_logc + Gp;   // d logc / d a  (-lj below the break, 0 above)
  float* s_lb = s_la + Gp;     // d logc / d b
  float* s_x = s_lb + Gp;      // X_j = (d logc / d mco) phi_j
  float* s_p = s_x + Gp;       // P_j = d mu / d mpisn  + (d mu / d mco) phi_j (d mco_hi / d mpisn)
  float* s_b = s_p + Gp;       // B_j = d mu / d mbhmax + (d mu / d mco) phi_j (d mco_hi / d mbhmax)
  float* s_red = s_b + Gp;     // (WARPS_BWD, NSUM) sums of this block's warps
  float* s_part = s_red + WARPS_BWD * NSUM;  // (BLOCKS, NSUM) block sums; the first block's is used
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  // This warp's rows are first, first + stride, ...  Lane u asks now for the cotangent and the
  // table entry of the u-th of them, so the loads fly while the tables are built and a row
  // waits for no global memory: it takes its pair from lane u by a shuffle.
  const int stride = BLOCKS * warps;
  const int first = blockIdx.x * warps + warp;
  float g_lane = 0.0f, ld_lane = 0.0f;
  if (first + lane * stride < G) {
    g_lane = g[(size_t)c * G + first + lane * stride];
    ld_lane = logdn[(size_t)c * G + first + lane * stride];
  }
  const Packed s = pack(params + 5 * c, G);
  const float log_norm = -0.5f * LOG_2PI - logf(s.sigma);
  const float phi_scale = 1.0f / (float)(G - 1);
  for (int j = threadIdx.x; j < Gp; j += blockDim.x) {
    const float mco = GRID_MCO_LO + (float)j * s.dmco;
    const float d = mco - s.mco_peak;
    const bool live = j < G;
    const bool parab = mco >= s.mpisn;
    const bool high = mco >= MCO_BREAK;
    const float lj = logf(mco / MCO_BREAK);
    const float trap = (j == 0 || j == G - 1) ? 0.0f : LOG2;
    const float phi_j = (float)j * phi_scale;
    const float cd = s.curv * d;
    const float dmu_dmco = parab ? 2.0f * cd : 1.0f;
    const float dmu_dmpisn = parab ? -4.0f * cd * cd + 2.0f * cd : 0.0f;
    const float dmu_dmbhmax = parab ? 1.0f + 4.0f * cd * cd - 4.0f * cd : 0.0f;
    const float dc_dmco = (high ? -s.b : -s.a) / mco;
    s_mu[j] = !live ? 0.0f : parab ? s.mbhmax + cd * d : mco;
    s_logc[j] = live ? (high ? -s.b * lj : -s.a * lj) + trap + log_norm : -INFINITY;
    s_la[j] = (live && !high) ? -lj : 0.0f;
    s_lb[j] = (live && high) ? -lj : 0.0f;
    s_x[j] = live ? dc_dmco * phi_j : 0.0f;
    s_p[j] = live ? dmu_dmpisn + dmu_dmco * (phi_j * s.dmcohi_dmpisn) : 0.0f;
    s_b[j] = live ? dmu_dmbhmax + dmu_dmco * (phi_j * s.dmcohi_dmbhmax) : 0.0f;
  }
  __syncthreads();
  const float inv_sigma = 1.0f / s.sigma;
  const float log_half_dmco = logf(0.5f * s.dmco);
  // this lane's share of [d a, d b, d mpisn, d mbhmax, d sigma, sum_i g_i]
  float sum[NSUM] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int n = 0;  // rows of this warp whose pair the lanes hold and that are done
  for (int i = first; i < G; i += stride, ++n) {
    if (n == 32) {  // more than 32 rows a warp (G > 32 * stride): the next 32 pairs
      n = 0;
      const bool live = i + lane * stride < G;
      g_lane = live ? g[(size_t)c * G + i + lane * stride] : 0.0f;
      ld_lane = live ? logdn[(size_t)c * G + i + lane * stride] : 0.0f;
    }
    const float gi = __shfl_sync(FULL, g_lane, n);
    const float L = __shfl_sync(FULL, ld_lane, n) - log_half_dmco;
    const float phi_i = (float)i * phi_scale;
    const float mbh = GRID_MBH_LO + (float)i * s.dmbh;
    // moments of w = c_j exp(K_ij - L_i) over this lane's columns
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, sa = 0.f, sb = 0.f, sx = 0.f, sp = 0.f, sB = 0.f;
    for (int j0 = 0; j0 < Gp; j0 += PASS) {
      float mu[COLS], w[COLS], wr[COLS], col[COLS];
      load_cols(s_mu, j0, lane, mu);
      load_cols(s_logc, j0, lane, w);
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        const float r = (mbh - mu[t]) * inv_sigma;
        w[t] = __expf(fmaf(-0.5f * r, r, w[t]) - L);
        wr[t] = w[t] * r;
        s0 += w[t];
        s1 += wr[t];
        s2 = fmaf(wr[t], r, s2);
      }
      load_cols(s_la, j0, lane, col);
#pragma unroll
      for (int t = 0; t < COLS; ++t) sa = fmaf(w[t], col[t], sa);
      load_cols(s_lb, j0, lane, col);
#pragma unroll
      for (int t = 0; t < COLS; ++t) sb = fmaf(w[t], col[t], sb);
      load_cols(s_x, j0, lane, col);
#pragma unroll
      for (int t = 0; t < COLS; ++t) sx = fmaf(w[t], col[t], sx);
      load_cols(s_p, j0, lane, col);
#pragma unroll
      for (int t = 0; t < COLS; ++t) sp = fmaf(wr[t], col[t], sp);
      load_cols(s_b, j0, lane, col);
#pragma unroll
      for (int t = 0; t < COLS; ++t) sB = fmaf(wr[t], col[t], sB);
    }
    sum[0] = fmaf(gi, sa, sum[0]);
    sum[1] = fmaf(gi, sb, sum[1]);
    sum[2] = fmaf(gi, fmaf(inv_sigma, sp, sx * s.dmcohi_dmpisn), sum[2]);
    sum[3] = fmaf(gi, fmaf(inv_sigma, sB - phi_i * s1, sx * s.dmcohi_dmbhmax), sum[3]);
    sum[4] = fmaf(gi * inv_sigma, (s2 - s0) - 7.0f * phi_i * s1, sum[4]);
    if (lane == 0) sum[5] += gi;
  }
  // the block's six sums: over lanes by shuffles, over warps by the first warp
#pragma unroll
  for (int q = 0; q < NSUM; ++q) {
    const float v = warp_sum(sum[q]);
    if (lane == 0) s_red[warp * NSUM + q] = v;
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster is running: its shared memory may be written
  cg::cluster_group cluster = cg::this_cluster();
  if (warp == 0) {
    float mine = 0.0f;
#pragma unroll
    for (int q = 0; q < NSUM; ++q) {
      const float v = warp_sum(lane < warps ? s_red[lane * NSUM + q] : 0.0f);
      if (lane == q) mine = v;
    }
    if (lane < NSUM) {
      cluster.map_shared_rank(s_part, 0)[(int)cluster.block_rank() * NSUM + lane] = mine;
    }
  }
  cluster_arrive();
  cluster_wait();  // all BLOCKS partials lie in the first block's shared memory
  if (cluster.block_rank() == 0 && warp == 0) {
    float v = 0.0f;
    if (lane < NSUM) {
      for (int r = 0; r < BLOCKS; ++r) v += s_part[r * NSUM + lane];  // in block order
    }
    const float gsum = __shfl_sync(FULL, v, NSUM - 1);
    // trapezoid-measure term: d log(dmco/2) = d mco_hi / ((G-1) dmco)
    const float meas = gsum / ((float)(G - 1) * s.dmco);
    if (lane == 2) v += meas * s.dmcohi_dmpisn;
    if (lane == 3) v += meas * s.dmcohi_dmbhmax;
    if (lane < 5) dparams[5 * c + lane] = v;
  }
}

bool bad_shape(int C, int G) { return C < 0 || C > 65535 || G < 2 || G > MAX_G; }

int block_threads(int G, int max_warps) {
  const int rows = (G + BLOCKS - 1) / BLOCKS;  // rows of one block
  return 32 * (rows < max_warps ? rows : max_warps);
}

}  // namespace

extern "C" int bump_fwd(const float* params, float* out, int C, int G, void* stream) {
  if (bad_shape(C, G)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const size_t smem = 2 * (size_t)padded(G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bump_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bump_fwd_kernel<<<dim3(BLOCKS, C, 1), block_threads(G, WARPS_FWD), smem, (cudaStream_t)stream>>>(params, out, G);
  return (int)cudaGetLastError();
}

extern "C" int bump_bwd(const float* params, const float* logdn, const float* g, float* dparams,
                        int C, int G, void* stream) {
  if (bad_shape(C, G)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const size_t smem = (7 * (size_t)padded(G) + NSUM * (WARPS_BWD + BLOCKS)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bump_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BLOCKS, C, 1);
  cfg.blockDim = dim3(block_threads(G, WARPS_BWD), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, bump_bwd_kernel, params, logdn, g, dparams, G);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
