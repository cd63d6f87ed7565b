// Kernel B: the detector-frame log-weight of every PE sample and injection,
// forward and hand-derived backward, batched over chains.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas_logwts.py:
//   forward  _fwd_call -> _fwd_kernel / _block_logwts (pallas_logwts.py:184, :146, :82-139)
//   backward _logwts_core_bwd -> _bwd_kernel           (pallas_logwts.py:217, :154)
// The Pallas backward recomputes the block under a JAX vjp; here the chain rule is
// written out by hand (the same formulas as the plain twin in ops/cuda_logwts.py).
//
// Per query (a = m1_det, q, dL, log pdraw) and chain c:
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
// Layout: grid (query blocks, chains); each block copies its chain's tables (K float2 +
// G floats, 9 KB at K=1024, G=256) and 15 scalars into shared memory and walks QPB queries,
// THREADS at a time, reading each query as one float4.  The backward scatter-adds the table
// cotangents into shared-memory bins (atomics), reduces the scalar cotangents across the
// block (warp shuffles), and flushes both to global memory with one atomicAdd per non-zero
// bin and per scalar.  Rows whose weight is -inf (m < 5, or the bump cut) contribute exactly
// zero to the cut branch: its weight is set to 0, never formed as 0 * inf.
//
// Bound on an H100: the forward moves 16 B in per query and 4 B out per chain-query; its
// transcendentals (about a dozen log/exp per chain-query) dominate the operation count.  At
// N = 38,912 and C = 16 both bounds are a few microseconds, so launch latency and the
// backward's shared-memory atomics on hot detector-table bins set the time.
// Simple and right first: no tensor cores, no TMA.
//
// C interface (bound with ctypes), float32, contiguous:
//   det (C,K,2) [z, log_jac]; bump (C,G); scal (C,15); qry (N,4) [a, q, dL, log pdraw];
//   out, gout (C,N); d_det (C,K,2), d_bump (C,G), d_scal (C,15) must be zeroed by the caller.
//   Each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int QPB = 2048;  // queries per block
constexpr int NS = 15;
constexpr float LOG2 = 0.69314718055994531f;
constexpr float MBH_MIN = 5.0f;
constexpr float MREF = 30.0f;
constexpr float QREF = 1.0f;

// scalar slots, as the Pallas layout (pallas_logwts.py:57-61); slots 13-14 (table
// lengths) are kept for layout only: the kernel takes K and G as int arguments.
enum Slot { V0 = 0, DV, MBH_LO, DMBH, MBH_HI, C_TAIL, MBHMAX, LPN, LNORM, BETA, LAM, KAPPA, ZP };

__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoidf(float x) {
  if (x >= 0.0f) return 1.0f / (1.0f + expf(-x));
  const float e = expf(x);
  return e / (1.0f + e);
}

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
  float ld;   // log dN/dm without log_norm; -inf when dead
  bool dead;  // m < MBH_MIN
  bool cut;   // bump outside its support
  Bracket br;
  float pos, b0, b1, lb, lt, lr, x;
};

__device__ __forceinline__ Mass mass_term(float m, const float* s, const float* bump, int G) {
  Mass r;
  r.pos = (m - s[MBH_LO]) / s[DMBH];
  r.br = bracket(r.pos, G);
  r.b0 = bump[r.br.lo];
  r.b1 = bump[r.br.lo + 1];
  r.lb = r.b0 + r.br.t * (r.b1 - r.b0);
  r.cut = (m <= s[MBH_LO]) || (m >= s[MBH_HI]);
  r.lr = logf(m / s[MBHMAX]);
  r.x = (m - s[MBHMAX]) / (0.05f * s[MBHMAX]);
  r.lt = -s[C_TAIL] * r.lr + s[LPN] + LOG2 - softplusf(-r.x);
  float ld = r.lt;
  if (!r.cut) ld = fmaxf(r.lb, r.lt) + log1pf(expf(-fabsf(r.lb - r.lt)));
  r.dead = m < MBH_MIN;
  r.ld = r.dead ? -INFINITY : ld;
  return r;
}

struct Query {
  Bracket bz;
  float posz, z0, z1, j0, j1, z, lj, m1, m2, q, l1pz, lr_zp, lzp;
  Mass w1, w2;
  float out;
};

__device__ __forceinline__ Query evaluate(float4 qv, const float* s, const float2* det, int K,
                                          const float* bump, int G) {
  Query r;
  r.q = qv.y;
  r.posz = (logf(qv.z) - s[V0]) / s[DV];
  r.bz = bracket(r.posz, K);
  const float2 e0 = det[r.bz.lo], e1 = det[r.bz.lo + 1];
  r.z0 = e0.x; r.j0 = e0.y; r.z1 = e1.x; r.j1 = e1.y;
  r.z = r.z0 + r.bz.t * (r.z1 - r.z0);
  r.lj = r.j0 + r.bz.t * (r.j1 - r.j0);
  const float opz = 1.0f + r.z;
  r.m1 = qv.x / opz;
  r.m2 = r.q * r.m1;
  r.w1 = mass_term(r.m1, s, bump, G);
  r.w2 = mass_term(r.m2, s, bump, G);
  r.l1pz = log1pf(r.z);
  r.lzp = log1pf(s[ZP]);
  r.lr_zp = logf(opz / (1.0f + s[ZP]));
  const float log_dndv = s[LAM] * r.l1pz - softplusf(s[KAPPA] * r.lr_zp) + softplusf(-s[KAPPA] * r.lzp);
  r.out = (r.w1.ld + s[LNORM]) + (r.w2.ld + s[LNORM])
          + s[BETA] * logf((r.m1 + r.m2) / (MREF * (1.0f + QREF))) + logf(r.m1)
          + log_dndv - 2.0f * r.l1pz + r.lj - qv.w;
  return r;
}

__device__ __forceinline__ void load_tables(const float* det, const float* bump, const float* scal,
                                            int K, int G, int c, float2* s_det, float* s_bump,
                                            float* s_scal) {
  const float2* det_c = reinterpret_cast<const float2*>(det) + (size_t)c * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_det[k] = det_c[k];
  for (int k = threadIdx.x; k < G; k += blockDim.x) s_bump[k] = bump[(size_t)c * G + k];
  if (threadIdx.x < NS) s_scal[threadIdx.x] = scal[(size_t)c * NS + threadIdx.x];
}

__global__ void logwts_fwd_kernel(const float* __restrict__ det, const float* __restrict__ bump,
                                  const float* __restrict__ scal, const float4* __restrict__ qry,
                                  float* __restrict__ out, int K, int G, int N) {
  extern __shared__ float smem[];
  float2* s_det = reinterpret_cast<float2*>(smem);
  float* s_bump = smem + 2 * K;
  float* s_scal = s_bump + G;
  const int c = blockIdx.y;
  load_tables(det, bump, scal, K, G, c, s_det, s_bump, s_scal);
  __syncthreads();
  const int start = blockIdx.x * QPB;
  const int stop = min(start + QPB, N);
  for (int n = start + threadIdx.x; n < stop; n += blockDim.x) {
    const Query r = evaluate(qry[n], s_scal, s_det, K, s_bump, G);
    out[(size_t)c * N + n] = r.out;
  }
}

// Cotangents of one mass term; returns d ld / d m (0 when dead).
__device__ __forceinline__ float mass_bwd(const Mass& w, float m, float g, const float* s,
                                          float* s_dbump, float* acc) {
  if (w.dead) return 0.0f;
  float wb = 0.0f, wt = 1.0f;
  if (!w.cut) {
    wb = expf(w.lb - w.ld);
    wt = expf(w.lt - w.ld);
  }
  const float inv_w = 1.0f / (0.05f * s[MBHMAX]);
  const float sg = sigmoidf(-w.x);
  const float slope = w.br.slope ? (w.b1 - w.b0) : 0.0f;
  if (wb != 0.0f && g != 0.0f) {
    atomicAdd(&s_dbump[w.br.lo], g * wb * (1.0f - w.br.t));
    atomicAdd(&s_dbump[w.br.lo + 1], g * wb * w.br.t);
  }
  const float gs = g * wb * slope / s[DMBH];
  acc[MBH_LO] -= gs;
  acc[DMBH] -= gs * w.pos;
  acc[C_TAIL] -= g * wt * w.lr;
  acc[LPN] += g * wt;
  acc[MBHMAX] += g * wt * (s[C_TAIL] / s[MBHMAX] - sg * m * inv_w / s[MBHMAX]);
  return wb * slope / s[DMBH] + wt * (-s[C_TAIL] / m + sg * inv_w);
}

__global__ void logwts_bwd_kernel(const float* __restrict__ det, const float* __restrict__ bump,
                                  const float* __restrict__ scal, const float4* __restrict__ qry,
                                  const float* __restrict__ gout, float* __restrict__ d_det,
                                  float* __restrict__ d_bump, float* __restrict__ d_scal,
                                  int K, int G, int N) {
  extern __shared__ float smem[];
  float2* s_det = reinterpret_cast<float2*>(smem);
  float* s_bump = smem + 2 * K;
  float* s_scal = s_bump + G;
  float* s_ddet = s_scal + NS;         // (2K,) interleaved [d z, d log_jac]
  float* s_dbump = s_ddet + 2 * K;     // (G,)
  float* s_red = s_dbump + G;          // (THREADS/32, NS)
  const int c = blockIdx.y;
  load_tables(det, bump, scal, K, G, c, s_det, s_bump, s_scal);
  for (int k = threadIdx.x; k < 2 * K; k += blockDim.x) s_ddet[k] = 0.0f;
  for (int k = threadIdx.x; k < G; k += blockDim.x) s_dbump[k] = 0.0f;
  __syncthreads();

  float acc[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) acc[k] = 0.0f;

  const int start = blockIdx.x * QPB;
  const int stop = min(start + QPB, N);
  for (int n = start + threadIdx.x; n < stop; n += blockDim.x) {
    const float g = gout[(size_t)c * N + n];
    if (g == 0.0f) continue;
    const float4 qv = qry[n];
    const Query r = evaluate(qv, s_scal, s_det, K, s_bump, G);
    const float* s = s_scal;
    // log_norm enters both mass terms after the cut, so it sees every row
    acc[LNORM] += 2.0f * g;
    const float d1 = mass_bwd(r.w1, r.m1, g, s, s_dbump, acc);
    const float d2 = mass_bwd(r.w2, r.m2, g, s, s_dbump, acc);
    const float mt = r.m1 + r.m2;
    acc[BETA] += g * logf(mt / (MREF * (1.0f + QREF)));
    const float dout_dm1 = d1 + r.q * d2 + s[BETA] * (1.0f + r.q) / mt + 1.0f / r.m1;
    const float opz = 1.0f + r.z;
    const float sk = sigmoidf(s[KAPPA] * r.lr_zp);
    const float sz = sigmoidf(-s[KAPPA] * r.lzp);
    const float dout_dz = dout_dm1 * (-r.m1 / opz) + s[LAM] / opz - sk * s[KAPPA] / opz - 2.0f / opz;
    acc[LAM] += g * r.l1pz;
    acc[KAPPA] += g * (-sk * r.lr_zp - sz * r.lzp);
    acc[ZP] += g * (sk - sz) * s[KAPPA] / (1.0f + s[ZP]);
    const float gz = g * dout_dz;
    const int lo = r.bz.lo;
    const float t = r.bz.t;
    atomicAdd(&s_ddet[2 * lo], gz * (1.0f - t));
    atomicAdd(&s_ddet[2 * lo + 2], gz * t);
    atomicAdd(&s_ddet[2 * lo + 1], g * (1.0f - t));
    atomicAdd(&s_ddet[2 * lo + 3], g * t);
    const float dpos = r.bz.slope ? gz * (r.z1 - r.z0) + g * (r.j1 - r.j0) : 0.0f;
    acc[V0] -= dpos / s[DV];
    acc[DV] -= dpos * r.posz / s[DV];
  }

  // block reduction of the scalar cotangents
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[warp * NS + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    float v = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += s_red[w * NS + threadIdx.x];
    if (v != 0.0f) atomicAdd(&d_scal[(size_t)c * NS + threadIdx.x], v);
  }
  for (int k = threadIdx.x; k < 2 * K; k += blockDim.x) {
    const float v = s_ddet[k];
    if (v != 0.0f) atomicAdd(&d_det[(size_t)c * 2 * K + k], v);
  }
  for (int k = threadIdx.x; k < G; k += blockDim.x) {
    const float v = s_dbump[k];
    if (v != 0.0f) atomicAdd(&d_bump[(size_t)c * G + k], v);
  }
}

size_t fwd_smem(int K, int G) { return (2 * (size_t)K + G + NS) * sizeof(float); }
size_t bwd_smem(int K, int G) {
  return (4 * (size_t)K + 2 * (size_t)G + NS + (THREADS / 32) * NS) * sizeof(float);
}

}  // namespace

extern "C" int logwts_fwd(const float* det, const float* bump, const float* scal, const float* qry,
                          float* out, int C, int K, int G, int N, void* stream) {
  const size_t smem = fwd_smem(K, G);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(logwts_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((N + QPB - 1) / QPB, C);
  logwts_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      det, bump, scal, reinterpret_cast<const float4*>(qry), out, K, G, N);
  return (int)cudaGetLastError();
}

extern "C" int logwts_bwd(const float* det, const float* bump, const float* scal, const float* qry,
                          const float* gout, float* d_det, float* d_bump, float* d_scal,
                          int C, int K, int G, int N, void* stream) {
  const size_t smem = bwd_smem(K, G);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(logwts_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((N + QPB - 1) / QPB, C);
  logwts_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      det, bump, scal, reinterpret_cast<const float4*>(qry), gout, d_det, d_bump, d_scal, K, G, N);
  return (int)cudaGetLastError();
}
