// Kernel P: the priors and transforms of a model's sites, forward and backward, batched over chains.
//
// Replaces no TPU kernel.  The JAX package computes the priors of inference/model.py
// (_log_prior_and_jac and constrain, over the families of inference/distributions.py) inside the
// one jitted potential, where XLA fuses them; in eager PyTorch the same per-site scalar code on
// (C,) columns costs about 900 small launches a value+grad.  These two launches compute it:
//
//   forward   theta (C, dim) -> sites x (dim, C), log_prior (C,)
//             x_i        = constrain_i(theta_i)
//             log_prior  = sum_i log_prob_i(x_i) + constrain_log_jac_i(theta_i), summed in site order
//   backward  (theta, d sites (dim, C), d log_prior) -> d theta (C, dim), elementwise
//
// The sites come out site-major, (dim, C), so that each site's (C,) column, which the
// log-likelihood takes as a tensor of its own, is contiguous (a view of a (C, dim) table would
// have a stride of dim in every one of the log-likelihood's operations on it).
//
// Each site is one row of a table of NCOL numbers of the kernel's type (ops/cuda_priors.py::table_row
// builds it from the site's prior in float64, and device_table casts it once):
//   transform  0 identity, 1 low + width * sigmoid(u), 2 low + exp(u), 3 high - exp(u)
//   density    0 normal, 1 normal with the support test low <= x <= high and - log Z,
//              2 uniform: - log width inside [low, high]
//   loc, scale, low, high (+-inf for an open side), width, log width, log scale, log Z
//
// The forward keeps the plain twin's float32 operations and their order (every constant is the
// twin's Python float rounded once to the kernel's type, as torch rounds a scalar operand):
//   sigmoid    1 / (1 + exp(-u))
//   x          low + width * sigmoid, low + exp(u), high - exp(u): two roundings, no fused multiply-add
//   z          (x - loc) / scale, a true division
//   normal     (((-0.5 z) z - log sqrt(2 pi)) - log scale) - log Z, -inf outside the support (density 1)
//   log |J|    sigmoid: (log width - softplus(-u)) - softplus(u); exp: u; identity: 0
//   softplus   max(v, 0) + log1p(exp(-|v|)) (ops/special.py: no linear threshold, NaN kept)
//   total      (total + log_prob_i) + log_jac_i, i = 0 .. dim - 1 in order, from 0
// Every product and sum is an __f*_rn / __d*_rn intrinsic, so the compiler contracts none of them.
//
// The backward is analytic, with the twin's subgradients where they matter:
//   d x / d u      sigmoid: ((g width) (1 - s)) s, as torch's sigmoid backward rounds it;
//                  exp: +-g exp(u); identity: g
//   d log_prob/dx  normal: -(g z) / scale; zero outside the support (the twin's where), and zero
//                  for the uniform density, whose value does not depend on x
//   d log|J| / du  sigmoid: -tanh(u / 2); exp: 1.  At u = 0 the twin's clamp_min subgradients
//                  (+1 through softplus(u), -1 through softplus(-u)) cancel to 0, the analytic value;
//                  elsewhere the twin's 1 - 2 e / (1 + e) (e = exp(-|u|)) loses up to an ulp of 1 to
//                  cancellation near u = 0, and the kernel's tanh does not.
//   d theta        (d x/du of the sites' cotangent) + ((d x/du of d log_prob/dx) + d log|J|/du)
//
// What bounds it on an H100: nothing but latency.  A value+grad of the flagship (4 chains x 15
// sites) reads and writes about a kilobyte and computes a few hundred special functions; each
// launch is a single block.  So each direction is one launch and nothing more:
//   * forward: one warp a chain (WARPS chains a block), a lane a site, further passes of 32 sites
//     for dim > 32.  The log prior is added up by every lane of the warp in site order through
//     shuffles, the twin's order: bit for bit the same from run to run, with no atomics.
//   * backward: one thread an entry of theta; no reduction, no atomics.
//
// C interface (bound with ctypes), contiguous, of the type the name ends in (f32 float, f64 double):
//   theta, dtheta (C, dim); sites, g_sites (dim, C); log_prior, g_log_prior (C,); table (dim, NCOL).
//   Any C >= 1 and dim >= 1 with C * dim < 2^31.  Each function returns the CUDA error of its
//   launch (0 on success; cudaErrorInvalidValue for a shape outside those ranges).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NCOL = 10;       // numbers a site's row holds
constexpr int WARPS = 4;       // chains a block of the forward
constexpr int BWD_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

// the table's columns (ops/cuda_priors.py::COLUMNS)
constexpr int TRANSFORM = 0, DENSITY = 1, LOC = 2, SCALE = 3, LOW = 4, HIGH = 5, WIDTH = 6,
              LOG_WIDTH = 7, LOG_SCALE = 8, LOG_Z = 9;
// transform codes
constexpr int IDENTITY = 0, SIGMOID = 1, EXP_ABOVE_LOW = 2, EXP_BELOW_HIGH = 3;
// density codes
constexpr int NORMAL = 0, UNIFORM = 2;  // and 1, the truncated normal: a normal density with the support test

template <typename T> struct R;  // correctly rounded arithmetic, never contracted, and the functions

template <> struct R<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float log1p(float a) { return log1pf(a); }
  static __device__ __forceinline__ float tanh(float a) { return tanhf(a); }
  static __device__ __forceinline__ float abs(float a) { return fabsf(a); }
};

template <> struct R<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double log1p(double a) { return ::log1p(a); }
  static __device__ __forceinline__ double tanh(double a) { return ::tanh(a); }
  static __device__ __forceinline__ double abs(double a) { return ::fabs(a); }
};

// ops/special.py::softplus: clamp_min(v, 0) + log1p(exp(-|v|)); a NaN stays NaN.
template <typename T>
__device__ __forceinline__ T softplus(T v) {
  const T pos = (v < T(0)) ? T(0) : v;
  return R<T>::add(pos, R<T>::log1p(R<T>::exp(-R<T>::abs(v))));
}

// One site at u: what the forward and the backward both need.
template <typename T>
struct Site {
  T x;       // the constrained value
  T s;       // sigmoid(u) (sigmoid transform)
  T e;       // exp(u) (exp transforms)
  T z;       // (x - loc) / scale (normal densities)
  bool inside;  // x in the support (the densities that test it)
};

template <typename T>
__device__ __forceinline__ Site<T> constrain(const T* row, int transform, int density, T u) {
  Site<T> st;
  st.s = T(0);
  st.e = T(0);
  if (transform == SIGMOID) {
    st.s = R<T>::div(T(1), R<T>::add(T(1), R<T>::exp(-u)));
    st.x = R<T>::add(row[LOW], R<T>::mul(row[WIDTH], st.s));
  } else if (transform == EXP_ABOVE_LOW) {
    st.e = R<T>::exp(u);
    st.x = R<T>::add(row[LOW], st.e);
  } else if (transform == EXP_BELOW_HIGH) {
    st.e = R<T>::exp(u);
    st.x = R<T>::sub(row[HIGH], st.e);
  } else {
    st.x = u;
  }
  st.z = (density == UNIFORM) ? T(0) : R<T>::div(R<T>::sub(st.x, row[LOC]), row[SCALE]);
  st.inside = (density == NORMAL) || (st.x >= row[LOW] && st.x <= row[HIGH]);
  return st;
}

template <typename T>
__device__ __forceinline__ void log_prob_and_jac(const T* row, int transform, int density, T u,
                                                 const Site<T>& st, T& lp, T& lj) {
  constexpr T LOG_SQRT_2PI = T(0.91893853320467274178);
  if (density == UNIFORM) {
    lp = st.inside ? -row[LOG_WIDTH] : T(-INFINITY);
  } else {
    T v = R<T>::mul(R<T>::mul(T(-0.5), st.z), st.z);
    v = R<T>::sub(R<T>::sub(R<T>::sub(v, LOG_SQRT_2PI), row[LOG_SCALE]), row[LOG_Z]);
    lp = st.inside ? v : T(-INFINITY);
  }
  if (transform == SIGMOID) {
    lj = R<T>::sub(R<T>::sub(row[LOG_WIDTH], softplus(-u)), softplus(u));
  } else if (transform == IDENTITY) {
    lj = T(0);
  } else {
    lj = u;
  }
}

// grid ceil(C / WARPS); block 32 * WARPS threads; a warp a chain, a lane a site
template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
priors_fwd_kernel(const T* __restrict__ theta, const T* __restrict__ table, T* __restrict__ sites,
                  T* __restrict__ log_prior, int C, int dim) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= C) return;  // the whole warp: c is the same in every lane
  T total = T(0);
  for (int i0 = 0; i0 < dim; i0 += 32) {
    const int i = i0 + lane;
    T lp = T(0), lj = T(0);
    if (i < dim) {
      const T* row = table + (size_t)i * NCOL;
      const int transform = (int)row[TRANSFORM], density = (int)row[DENSITY];
      const T u = theta[(size_t)c * dim + i];
      const Site<T> st = constrain(row, transform, density, u);
      log_prob_and_jac(row, transform, density, u, st, lp, lj);
      sites[(size_t)i * C + c] = st.x;
    }
    const int n = min(32, dim - i0);
    for (int k = 0; k < n; ++k) {
      total = R<T>::add(R<T>::add(total, __shfl_sync(FULL, lp, k)), __shfl_sync(FULL, lj, k));
    }
  }
  if (lane == 0) log_prior[c] = total;
}

// d x / d u applied to a cotangent g of x, rounded as torch's backward of the transform rounds it
template <typename T>
__device__ __forceinline__ T through_transform(const T* row, int transform, const Site<T>& st, T g) {
  if (transform == SIGMOID) {
    return R<T>::mul(R<T>::mul(R<T>::mul(g, row[WIDTH]), R<T>::sub(T(1), st.s)), st.s);
  }
  if (transform == EXP_ABOVE_LOW) return R<T>::mul(g, st.e);
  if (transform == EXP_BELOW_HIGH) return R<T>::mul(-g, st.e);
  return g;
}

// grid ceil(C * dim / BWD_THREADS); block BWD_THREADS threads; a thread an entry of theta
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
priors_bwd_kernel(const T* __restrict__ theta, const T* __restrict__ table, const T* __restrict__ g_sites,
                  const T* __restrict__ g_log_prior, T* __restrict__ dtheta, int C, int dim) {
  const int t = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (t >= C * dim) return;
  const int c = t / dim, i = t - c * dim;
  const T* row = table + (size_t)i * NCOL;
  const int transform = (int)row[TRANSFORM], density = (int)row[DENSITY];
  const T u = theta[t];
  const T g = g_log_prior[c];
  const Site<T> st = constrain(row, transform, density, u);
  // the density's cotangent of x: the twin's where() gives the branch outside the support nothing
  const T g_x = (density == UNIFORM || !st.inside) ? T(0)
                                                   : R<T>::div(-R<T>::mul(g, st.z), row[SCALE]);
  T g_jac = T(0);
  if (transform == SIGMOID) {
    g_jac = R<T>::mul(g, -R<T>::tanh(R<T>::mul(T(0.5), u)));
  } else if (transform != IDENTITY) {
    g_jac = g;
  }
  const T from_sites = through_transform(row, transform, st, g_sites[(size_t)i * C + c]);
  const T from_prior = R<T>::add(through_transform(row, transform, st, g_x), g_jac);
  dtheta[t] = R<T>::add(from_sites, from_prior);
}

bool bad_shape(int C, int dim) { return C < 1 || dim < 1 || (long long)C * dim >= (1LL << 31); }

template <typename T>
int launch_fwd(const void* theta, const void* table, void* sites, void* log_prior, int C, int dim,
               void* stream) {
  if (bad_shape(C, dim)) return (int)cudaErrorInvalidValue;
  priors_fwd_kernel<T><<<(C + WARPS - 1) / WARPS, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const T*)theta, (const T*)table, (T*)sites, (T*)log_prior, C, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* theta, const void* table, const void* g_sites, const void* g_log_prior,
               void* dtheta, int C, int dim, void* stream) {
  if (bad_shape(C, dim)) return (int)cudaErrorInvalidValue;
  const int n = C * dim;
  priors_bwd_kernel<T><<<(n + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)theta, (const T*)table, (const T*)g_sites, (const T*)g_log_prior, (T*)dtheta, C, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int priors_fwd_f32(const void* theta, const void* table, void* sites, void* log_prior, int C,
                              int dim, void* stream) {
  return launch_fwd<float>(theta, table, sites, log_prior, C, dim, stream);
}

extern "C" int priors_bwd_f32(const void* theta, const void* table, const void* g_sites, const void* g_log_prior,
                              void* dtheta, int C, int dim, void* stream) {
  return launch_bwd<float>(theta, table, g_sites, g_log_prior, dtheta, C, dim, stream);
}

extern "C" int priors_fwd_f64(const void* theta, const void* table, void* sites, void* log_prior, int C,
                              int dim, void* stream) {
  return launch_fwd<double>(theta, table, sites, log_prior, C, dim, stream);
}

extern "C" int priors_bwd_f64(const void* theta, const void* table, const void* g_sites, const void* g_log_prior,
                              void* dtheta, int C, int dim, void* stream) {
  return launch_bwd<double>(theta, table, g_sites, g_log_prior, dtheta, C, dim, stream);
}
