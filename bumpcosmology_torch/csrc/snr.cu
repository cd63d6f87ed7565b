// Kernel C: the injection campaign's SNR integral, one thread per injection.
//
// Replaces the Pallas TPU kernel of the JAX package's mock/pallas_snr.py:
//   snr_integral_pallas -> _amp_kernel_body (pallas_snr.py:116, :37)
//
// For injection i (detector-frame masses m1, m2 in Msun, distance dl in Gpc):
//   out_i = sum_k w_k (amp_scale A(f_k; i))^2 inv_psd_k
// with A the PhenomA piecewise amplitude (inspiral f^-7/6, merger f^-2/3,
// Lorentzian ringdown, zero from f_cut on) and the trapezoid rule on the
// log-uniform grid f_k = exp(log f_min + k dlog) in closed form:
//   w_k = c_mid f_k inside, c_first f_0 and c_last f_{n_f-1} at the ends,
//   c_mid = (e^dlog - e^-dlog)/2, c_first = (e^dlog - 1)/2, c_last = (1 - e^-dlog)/2.
// Only the (N,) integrals leave the kernel; nothing is differentiated.
//
// The grid f_k comes from the wrapper (one (n_f,) tensor, the same one the
// plain PyTorch twin uses), and the per-injection transition frequencies are
// computed with round-to-nearest intrinsics that the compiler never contracts
// into FMAs.  So the kernel and its twin cut at f >= f_cut on the same grid
// points: a 1-ulp difference at the cut would drop or keep a whole ringdown
// term, far more than the comparison's tolerance.
//
// Layout: 256 threads per block, one injection per thread.  Each block stages
// f_k and w_k inv_psd_k (2 n_f floats, 4 KB at n_f = 512) in shared memory
// once; every thread of a warp then reads the same k at once (a broadcast).
// The grid is sorted, so a thread computes only the branch that applies at
// each f_k and leaves its loop at the first f_k >= f_cut.
//
// Bound on an H100: operations, and among them the special-function unit.
// Each live point costs one powf and one IEEE division (inspiral, merger) or
// one division (ringdown), against 16 bytes per injection.  The design does
// one transcendental per live point instead of the three that a branch-free
// where() pays.  Next step, left for a later change: split each injection's
// sorted f range into its three contiguous segments and replace powf by exp2
// of a precomputed log2 f_k (one ex2 and one FMA per point).
//
// C interface (bound with ctypes), float32, contiguous:
//   m1, m2, dl, out (N,); f_grid, inv_psd (n_f,).
//   Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr float MSUN_S = 4.925490947641267e-6f;  // G Msun / c^3 [s]
constexpr float C_SI = 2.99792458e8f;             // [m/s]
constexpr float GPC_M = 3.0856775814913673e25f;   // [m]
constexpr float PI = 3.14159265358979323846f;
constexpr float NEWT = 0.21278751013966343f;      // sqrt(5/24) pi^(-2/3)
constexpr float INSP_EXP = -7.0f / 6.0f;
constexpr float MERG_EXP = -2.0f / 3.0f;

// (a eta^2 + b eta + c) / (pi M_s), rounded operation by operation as the
// plain twin's tensor code rounds it.
__device__ __forceinline__ float transition(float a, float b, float c, float eta, float m_total_s) {
  const float num = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, eta), eta), __fmul_rn(b, eta)), c);
  return __fdiv_rn(num, __fmul_rn(PI, m_total_s));
}

__global__ void snr_integral_kernel(const float* __restrict__ m1, const float* __restrict__ m2,
                                    const float* __restrict__ dl, const float* __restrict__ f_grid,
                                    const float* __restrict__ inv_psd, float* __restrict__ out, int n,
                                    int n_f, float c_first, float c_mid, float c_last, float amp_scale) {
  extern __shared__ float smem[];
  float* s_f = smem;          // (n_f,) f_k
  float* s_wpsd = smem + n_f; // (n_f,) w_k inv_psd_k
  for (int k = threadIdx.x; k < n_f; k += blockDim.x) {
    const float f = f_grid[k];
    const float c = (k == 0) ? c_first : ((k == n_f - 1) ? c_last : c_mid);
    s_f[k] = f;
    s_wpsd[k] = c * f * inv_psd[k];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float a = m1[i], b = m2[i];
  const float m_total = __fadd_rn(a, b);
  const float eta = __fdiv_rn(__fmul_rn(a, b), __fmul_rn(m_total, m_total));
  const float m_total_s = __fmul_rn(m_total, MSUN_S);
  const float f_merg = transition(2.9740e-1f, 4.4810e-2f, 9.5560e-2f, eta, m_total_s);
  const float f_ring = transition(5.9411e-1f, 8.9794e-2f, 1.9111e-1f, eta, m_total_s);
  const float sigma = transition(5.0801e-1f, 7.7515e-2f, 2.2369e-2f, eta, m_total_s);
  const float f_cut = transition(8.4845e-1f, 1.2848e-1f, 2.7299e-1f, eta, m_total_s);

  const float mc_s = powf(a * b, 0.6f) / powf(m_total, 0.2f) * MSUN_S;
  const float a_newt = NEWT * powf(mc_s, 5.0f / 6.0f) * (C_SI / (dl[i] * GPC_M)) * amp_scale;
  const float amp0 = a_newt * powf(f_merg, INSP_EXP);  // A at f_merg; shape is relative to it
  const float hw = 0.5f * sigma;
  const float hw2 = hw * hw;
  const float ring_scale = powf(f_ring / f_merg, MERG_EXP);

  float acc = 0.0f;
  for (int k = 0; k < n_f; ++k) {
    const float f = s_f[k];
    if (f >= f_cut) break;  // the grid is sorted: every later point is cut too
    float shape;
    if (f < f_merg) {
      shape = powf(f / f_merg, INSP_EXP);
    } else if (f < f_ring) {
      shape = powf(f / f_merg, MERG_EXP);
    } else {
      const float d = f - f_ring;
      shape = ring_scale * (hw2 / (d * d + hw2));
    }
    const float amp = amp0 * shape;
    acc += amp * amp * s_wpsd[k];
  }
  out[i] = acc;
}

}  // namespace

extern "C" int snr_integral(const float* m1, const float* m2, const float* dl, const float* f_grid,
                            const float* inv_psd, float* out, int n, int n_f, float c_first, float c_mid,
                            float c_last, float amp_scale, void* stream) {
  const size_t smem = 2 * (size_t)n_f * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(snr_integral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  snr_integral_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      m1, m2, dl, f_grid, inv_psd, out, n, n_f, c_first, c_mid, c_last, amp_scale);
  return (int)cudaGetLastError();
}
