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
// Layout: one block per chain, threads stride over the BH rows i, an online
// log-sum-exp runs along j.  Everything that depends on j alone (mco_j, mu_j, logc_j
// and, in the backward, their derivatives) is computed once per block into shared
// memory.  Bound on an H100: operations, not bytes — G*G cells of one exp each (plus
// a few FMAs) against 20 bytes in and 4*G bytes out per chain; with C=16 chains the
// grid is 16 blocks, so the kernel is latency-bound long before it is compute-bound.
// Simple and right first: no tensor cores, no TMA.
//
// C interface (bound with ctypes), float32, contiguous:
//   params (C,5) = [a, b, mpisn, mbhmax, sigma]; out/logdn/g (C,G); dparams (C,5).
//   Each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr float LOG_2PI = 1.8378770664093453f;
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

__device__ __forceinline__ float trap_log_weight(int j, int G) {
  return (j == 0 || j == G - 1) ? 0.0f : 0.69314718055994531f;  // log c_j
}

__global__ void bump_fwd_kernel(const float* __restrict__ params, float* __restrict__ out, int G) {
  extern __shared__ float smem[];
  float* s_mu = smem;          // (G,) mu(mco_j)
  float* s_logc = smem + G;    // (G,) logc(mco_j) + log c_j - log(sqrt(2 pi) sigma)
  const int c = blockIdx.x;
  const Packed s = pack(params + 5 * c, G);
  const float log_norm = -0.5f * LOG_2PI - logf(s.sigma);
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    const float mco = GRID_MCO_LO + (float)j * s.dmco;
    const float d = mco - s.mco_peak;
    s_mu[j] = (mco >= s.mpisn) ? s.mbhmax + s.curv * d * d : mco;
    const float lj = logf(mco / MCO_BREAK);
    const float logc = (mco >= MCO_BREAK) ? -s.b * lj : -s.a * lj;
    s_logc[j] = logc + trap_log_weight(j, G) + log_norm;
  }
  __syncthreads();
  const float inv_sigma = 1.0f / s.sigma;
  const float log_half_dmco = logf(0.5f * s.dmco);
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    const float mbh = GRID_MBH_LO + (float)i * s.dmbh;
    float m = -INFINITY, acc = 0.0f;  // online log-sum-exp over j
    for (int j = 0; j < G; ++j) {
      const float r = (mbh - s_mu[j]) * inv_sigma;
      const float k = s_logc[j] - 0.5f * r * r;
      if (k > m) {
        acc = acc * expf(m - k) + 1.0f;
        m = k;
      } else {
        acc += expf(k - m);
      }
    }
    out[(size_t)c * G + i] = m + logf(acc) + log_half_dmco;
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  }
  return total;  // valid in thread 0 only
}

__global__ void bump_bwd_kernel(const float* __restrict__ params, const float* __restrict__ logdn,
                                const float* __restrict__ g, float* __restrict__ dparams, int G) {
  extern __shared__ float smem[];
  float* s_mu = smem;               // mu(mco_j)
  float* s_logc = smem + G;         // logc_j + log c_j - log(sqrt(2 pi) sigma)
  float* s_la = smem + 2 * G;       // d logc / d a  (0 above the break, -lj below)
  float* s_lb = smem + 3 * G;       // d logc / d b
  float* s_dmu_dmco = smem + 4 * G;
  float* s_dmu_dmpisn = smem + 5 * G;
  float* s_dmu_dmbhmax = smem + 6 * G;
  float* s_dc_dmco = smem + 7 * G;
  float* red = smem + 8 * G;        // (32,) reduction scratch
  const int c = blockIdx.x;
  const Packed s = pack(params + 5 * c, G);
  const float log_norm = -0.5f * LOG_2PI - logf(s.sigma);
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    const float mco = GRID_MCO_LO + (float)j * s.dmco;
    const float d = mco - s.mco_peak;
    const bool parab = mco >= s.mpisn;
    const bool high = mco >= MCO_BREAK;
    const float lj = logf(mco / MCO_BREAK);
    s_mu[j] = parab ? s.mbhmax + s.curv * d * d : mco;
    s_logc[j] = (high ? -s.b * lj : -s.a * lj) + trap_log_weight(j, G) + log_norm;
    s_la[j] = high ? 0.0f : -lj;
    s_lb[j] = high ? -lj : 0.0f;
    s_dmu_dmco[j] = parab ? 2.0f * s.curv * d : 1.0f;
    s_dmu_dmpisn[j] = parab ? -4.0f * s.curv * s.curv * d * d + 2.0f * s.curv * d : 0.0f;
    s_dmu_dmbhmax[j] = parab ? 1.0f + 4.0f * s.curv * s.curv * d * d - 4.0f * s.curv * d : 0.0f;
    s_dc_dmco[j] = (high ? -s.b : -s.a) / mco;
  }
  __syncthreads();
  const float inv_sigma = 1.0f / s.sigma;
  const float phi_scale = 1.0f / (float)(G - 1);
  const float log_half_dmco = logf(0.5f * s.dmco);
  float da = 0.f, db = 0.f, dsig = 0.f, dmp = 0.f, dmb = 0.f, gsum = 0.f;
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    const float gi = g[(size_t)c * G + i];
    gsum += gi;
    if (gi == 0.0f) continue;
    const float L = logdn[(size_t)c * G + i] - log_half_dmco;
    const float phi_i = (float)i * phi_scale;
    const float mbh = GRID_MBH_LO + (float)i * s.dmbh;
    float a_a = 0.f, a_b = 0.f, a_sig = 0.f, a_mp = 0.f, a_mb = 0.f;
    for (int j = 0; j < G; ++j) {
      const float r = (mbh - s_mu[j]) * inv_sigma;
      const float w = expf(s_logc[j] - 0.5f * r * r - L);  // c_j exp(K_ij - L_i)
      const float ros = r * inv_sigma;
      const float phi_j = (float)j * phi_scale;
      const float dk_dmco = s_dc_dmco[j] + ros * s_dmu_dmco[j];
      a_a += w * s_la[j];
      a_b += w * s_lb[j];
      a_sig += w * ((r * r - 1.0f) * inv_sigma - ros * (7.0f * phi_i));
      a_mp += w * (ros * s_dmu_dmpisn[j] + dk_dmco * (phi_j * s.dmcohi_dmpisn));
      a_mb += w * (ros * s_dmu_dmbhmax[j] - ros * phi_i + dk_dmco * (phi_j * s.dmcohi_dmbhmax));
    }
    da += gi * a_a; db += gi * a_b; dsig += gi * a_sig; dmp += gi * a_mp; dmb += gi * a_mb;
  }
  da = block_sum(da, red);
  db = block_sum(db, red);
  dsig = block_sum(dsig, red);
  dmp = block_sum(dmp, red);
  dmb = block_sum(dmb, red);
  gsum = block_sum(gsum, red);
  if (threadIdx.x == 0) {
    // trapezoid-measure term: d log(dmco/2) = d mco_hi / ((G-1) dmco)
    const float meas = 1.0f / ((float)(G - 1) * s.dmco);
    float* o = dparams + 5 * c;
    o[0] = da;
    o[1] = db;
    o[2] = dmp + gsum * s.dmcohi_dmpisn * meas;
    o[3] = dmb + gsum * s.dmcohi_dmbhmax * meas;
    o[4] = dsig;
  }
}

}  // namespace

extern "C" int bump_fwd(const float* params, float* out, int C, int G, void* stream) {
  const size_t smem = 2 * (size_t)G * sizeof(float);
  bump_fwd_kernel<<<C, THREADS, smem, (cudaStream_t)stream>>>(params, out, G);
  return (int)cudaGetLastError();
}

extern "C" int bump_bwd(const float* params, const float* logdn, const float* g, float* dparams,
                        int C, int G, void* stream) {
  const size_t smem = (8 * (size_t)G + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(bump_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  bump_bwd_kernel<<<C, THREADS, smem, (cudaStream_t)stream>>>(params, logdn, g, dparams, G);
  return (int)cudaGetLastError();
}
