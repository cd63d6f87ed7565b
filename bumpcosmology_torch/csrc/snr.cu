// Kernel C: the injection campaign's SNR integral, by segment sums.
//
// Replaces the Pallas TPU kernel of the JAX package's mock/pallas_snr.py:
//   snr_integral_pallas -> _amp_kernel_body (pallas_snr.py:116, :37)
//
// For injection i (detector-frame masses m1, m2 in Msun, distance dl in Gpc):
//   out_i = sum_k g_k (amp_scale A(f_k; i))^2,   g_k = w_k inv_psd_k,
// with A the PhenomA piecewise amplitude (zero from f_cut on) and the trapezoid
// rule on the log-uniform grid f_k in closed form: w_k = c_mid f_k inside,
// c_first f_0 and c_last f_{n_f-1} at the ends.
//
// The algebra.  With a = amp_scale A_N (A_N the Newtonian amplitude at dl):
//   inspiral  f < f_merg:           A^2 = a^2 f^(-7/3)
//   merger    f_merg <= f < f_ring: A^2 = a^2 f_merg^-1 f^(-4/3)
//   ringdown  f_ring <= f < f_cut:  A^2 = a^2 f_merg^-1 f_ring^(-4/3) L(f)^2,
//                                   L = hw^2 / ((f - f_ring)^2 + hw^2), hw = sigma/2.
// In the first two segments the f-dependence is the same for every row, so
//   out_i = a^2 (Gi[n1] + (Gm[n2] - Gm[n1] + f_ring^(-4/3) sum_{n2 <= k < n3} L_k^2 g_k) / f_merg)
//   Gi[n] = sum_{k<n} f_k^(-7/3) g_k,  Gm[n] = sum_{k<n} f_k^(-4/3) g_k   (float64)
//   n3 = #{f_k < f_cut},  n1 = min(#{f_k < f_merg}, n3),  n2 = min(#{f_k < f_ring}, n3),
// and a^2 = A2_UNIT amp_scale^2 m1 m2 M^(-1/3) / dl^2, since Mc^(5/3) = m1 m2 M^(-1/3).
// f_cut / f_ring = 1.43 for every mass ratio, so the ringdown holds at most 35
// grid points at n_f = 512 (dlog = 0.0104), against some 250 live points a row
// for a loop over the grid.  Rows with n3 = 0 (f_cut at or below f_0) come out
// as exact zeros: every term is an empty sum.
//
// Two launches a call, one stream:
// 1. snr_tables_kernel, one block: the two exclusive prefix tables (Gi, Gm)
//    as (n_f + 1,) double2, a shuffle scan in float64, into a scratch tensor
//    that the wrapper allocates.  It is rebuilt on every call, so a detector
//    with its own tabulated PSD (another inv_psd on the same grid) needs
//    nothing else.
// 2. snr_rows_kernel, a persistent grid (as many blocks as fit on the card at
//    once, rows in a grid-stride loop, one thread a row): each block stages
//    the tables and (f_k, g_k) in shared memory once (12 KB at n_f = 512) and
//    then walks its rows, so the staging is paid per resident block and not
//    per 256 rows.  One thread a row keeps a row's scalars in registers and
//    needs no reduction; the ringdowns of a warp's rows are about equally long.
//
// Numerics.  The four transition frequencies are rounded with round-to-nearest
// intrinsics that the compiler never contracts into FMAs, as the plain twin's
// tensor code rounds them: a 1-ulp difference at a cut drops or keeps a whole
// term.  Each count is taken on the grid AS STORED (the float32 tensor the twin
// compares against): a guess from __logf, then moved against the neighbouring
// stored knots until f_{k-1} < x <= f_k, so the guess's error never reaches the
// result.  The prefix differences stay in float64 until the row's factor has
// multiplied them: Gm[n2] - Gm[n1] cancels in float32 when the merger is a
// short stretch at the end of a long sum.  The row's own factors (m1 m2,
// M^(-1/3), 1/dl^2, 1/f_merg, f_ring^(-4/3)) are float32 results of one or two
// ulp, widened before they multiply.  The ringdown sum is float32 (at most 35
// positive terms).  The float32 twin rounds some 250 powf terms a row and adds
// them in float32; the two differ by about 1e-6 relative, a twentieth of the
// comparison's rtol 2e-5 (the CPU tests hold the same algebra in plain PyTorch
// to the JAX package and to the twin, rows on the knots included).  Against
// the same sum in float64 on the campaign's rows (chip_smoke.py phase 6, on an
// H100) the kernel's largest relative distance is 5.7e-7 and the twin's
// 1.7e-6: most of what separates the two is the twin's own rounding.
//
// Bound on an H100: the special-function unit.  The least work of these inputs
// is one reciprocal per live ringdown point (the Lorentzian; some 34 a row on
// the campaign) and 8 results a row (the reciprocals and powers of the row's
// scalars), at 16 results per clock per SM; bytes are 16 a row (three inputs,
// one output), FP32 operations fewer.  chip_smoke.py counts all three on the
// campaign's own rows.
//
// Most of this design's time is the ringdown loop, and there the shared-memory
// reads: 32 rows of a warp read (f_k, g_k) at unrelated k, and the float2 loads
// of a warp collide in the 16 bank pairs.  Each lane therefore starts its segment at the
// point whose bank pair (k mod 16) is its lane's and wraps around the segment
// in one loop, so the lanes of a warp, all at one step, spread over the bank
// pairs.  Measured on an H100 (700 W) with tools/kernel_times.py on the
// campaign's 1,828,051 rows (row launch, device us): the first form of this
// kernel (powf for the row's factors, a division in the Lorentzian, the
// wrap by a modulo) 78.5; a lean loop body and the row factors from one cube
// root, the lanes' start staggered over two loops (from start to the end,
// then from 0 to start) 63.7, the same as without the stagger (no ringdown at
// all: 24.9; no count corrections: 58.4); the stagger in one loop that wraps
// 54.1, against 62.5 for the same loop in the grid's order (both with the
// next two).  What did not help: prefetching the next row's inputs (0.5 us),
// a programmatic dependent launch of the row kernel (0.6 us a call), 128 or 512
// threads a block (within 1 us of 256), fast divisions at the transition
// frequencies (1 us, and a cut that moves).  The one-block table launch takes
// 2.3 us.
// The first port of this kernel looped every row over all its grid points
// below f_cut with a powf and a division each: 4.87 ms, 19x its bound then.
//
// C interface (bound with ctypes), float32 unless noted, contiguous:
//   m1, m2, dl, out (N,); f_grid, inv_psd (n_f,); tab (n_f + 1,) double2 scratch.
//   Returns the first cudaGetLastError() of the two launches.

#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int TABLE_THREADS = 512;
constexpr int ROW_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MSUN_S = 4.925490947641267e-6f;  // G Msun / c^3 [s]
constexpr float C_SI = 2.99792458e8f;             // [m/s]
constexpr float GPC_M = 3.0856775814913673e25f;   // [m]
constexpr float PI = 3.14159265358979323846f;
// a^2 = (amp_scale A_N)^2 = A2_UNIT amp_scale^2 m1 m2 M^(-1/3) / dl^2, with
// A_N = sqrt(5/24) pi^(-2/3) (G Mc/c^3)^(5/6) c / dl and Mc^(5/3) = m1 m2 M^(-1/3)
// (masses in Msun, dl in Gpc): sqrt(5/24)^2 pi^(-4/3) MSUN_S^(5/3) (c / GPC_M)^2
constexpr double A2_UNIT = 6.094177833493161e-45;

__device__ __forceinline__ float trapezoid_c(int k, int n_f, float c_first, float c_mid, float c_last) {
  return (k == 0) ? c_first : ((k == n_f - 1) ? c_last : c_mid);
}

// (a eta^2 + b eta + c) / (pi M_s), rounded operation by operation as the
// plain twin's tensor code rounds it.
__device__ __forceinline__ float transition(float a, float b, float c, float eta, float m_total_s) {
  const float num = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, eta), eta), __fmul_rn(b, eta)), c);
  return __fdiv_rn(num, __fmul_rn(PI, m_total_s));
}

// #{k : f_k < x} on the stored grid: a guess from the log-uniform spacing,
// then moved until f_{k-1} < x <= f_k.  The grid is sorted, so the loops end
// at the exact count from any guess (a NaN x counts 0, +inf counts n_f).
__device__ __forceinline__ int count_below(const float2* s_fg, int n_f, float x, float log_f0, float inv_dlog) {
  const float t = ceilf((__logf(x) - log_f0) * inv_dlog);
  int k = (int)fminf(fmaxf(t, 0.0f), (float)n_f);
  while (k > 0 && s_fg[k - 1].x >= x) --k;
  while (k < n_f && s_fg[k].x < x) ++k;
  return k;
}

// 1/x to about 1 ulp: one MUFU.RCP, no Newton step and no special-case branch
__device__ __forceinline__ float fast_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// sum_{k < len} g_k / ((f_k - f_ring)^2 + hw2)^2 over the ringdown seg[0, len),
// that is sum L_k^2 g_k / hw^4, from seg[start] on and wrapping to seg[0].
__device__ __forceinline__ float ringdown_sum(const float2* seg, int len, int start, float f_ring, float hw2) {
  float acc = 0.0f;
  int j = start;
#pragma unroll 4
  for (int s = 0; s < len; ++s) {
    const float2 fg = seg[j];
    const float d = fg.x - f_ring;
    const float r = fast_rcp(fmaf(d, d, hw2));
    acc = fmaf(r * r, fg.y, acc);
    j = (j + 1 == len) ? 0 : j + 1;
  }
  return acc;
}

// One row's integral from its masses and distance (the header's algebra).
__device__ __forceinline__ float row_integral(float a, float b, float d_l, const float2* s_fg, const double2* s_tab,
                                              int n_f, float log_f0, float inv_dlog, float amp_scale, int lane) {
  const float m_total = __fadd_rn(a, b);
  const float eta = __fdiv_rn(__fmul_rn(a, b), __fmul_rn(m_total, m_total));
  const float m_total_s = __fmul_rn(m_total, MSUN_S);
  const float f_cut = transition(8.4845e-1f, 1.2848e-1f, 2.7299e-1f, eta, m_total_s);
  const int n3 = count_below(s_fg, n_f, f_cut, log_f0, inv_dlog);
  if (n3 == 0) return 0.0f;  // every term is an empty sum
  const float f_merg = transition(2.9740e-1f, 4.4810e-2f, 9.5560e-2f, eta, m_total_s);
  const float f_ring = transition(5.9411e-1f, 8.9794e-2f, 1.9111e-1f, eta, m_total_s);
  const float sigma = transition(5.0801e-1f, 7.7515e-2f, 2.2369e-2f, eta, m_total_s);
  const int n1 = min(count_below(s_fg, n_f, f_merg, log_f0, inv_dlog), n3);
  const int n2 = max(min(count_below(s_fg, n_f, f_ring, log_f0, inv_dlog), n3), n1);

  const int len = n3 - n2;
  const float hw = 0.5f * sigma;
  const float hw2 = hw * hw;
  int start = (lane - n2) & 15;  // the point whose bank pair is this lane's
  if (start >= len) start = len > 0 ? start % len : 0;
  const float ring = ringdown_sum(s_fg + n2, len, start, f_ring, hw2);

  const double a2 = A2_UNIT * ((double)amp_scale * (double)amp_scale) * ((double)a * (double)b) *
                    (double)rcbrtf(m_total) * (double)fast_rcp(d_l * d_l);
  const float r_ring = rcbrtf(f_ring);
  const double ring_scale = (double)(r_ring * r_ring) * (double)(r_ring * r_ring) * ((double)hw2 * (double)hw2);
  const double2 t1 = s_tab[n1];
  const double gm2 = s_tab[n2].y;
  return (float)(a2 * (t1.x + (double)fast_rcp(f_merg) * ((gm2 - t1.y) + ring_scale * (double)ring)));
}

__global__ void __launch_bounds__(TABLE_THREADS)
snr_tables_kernel(const float* __restrict__ f_grid, const float* __restrict__ inv_psd, double2* __restrict__ tab,
                  int n_f, float c_first, float c_mid, float c_last) {
  __shared__ double2 s_warp[TABLE_THREADS / 32];
  __shared__ double2 s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    tab[0] = make_double2(0.0, 0.0);
    s_carry = make_double2(0.0, 0.0);
  }
  for (int base = 0; base < n_f; base += TABLE_THREADS) {
    const int k = base + threadIdx.x;
    double ti = 0.0, tm = 0.0;
    if (k < n_f) {
      const double f = f_grid[k];
      const double g = (double)trapezoid_c(k, n_f, c_first, c_mid, c_last) * f * (double)inv_psd[k];
      const double lf = log(f);
      ti = exp(-7.0 / 3.0 * lf) * g;
      tm = exp(-4.0 / 3.0 * lf) * g;
    }
    for (int off = 1; off < 32; off <<= 1) {  // inclusive scan within the warp
      const double ui = __shfl_up_sync(FULL, ti, off), um = __shfl_up_sync(FULL, tm, off);
      if (lane >= off) {
        ti += ui;
        tm += um;
      }
    }
    if (lane == 31) s_warp[warp] = make_double2(ti, tm);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      double2 v = (lane < TABLE_THREADS / 32) ? s_warp[lane] : make_double2(0.0, 0.0);
      for (int off = 1; off < 32; off <<= 1) {
        const double ux = __shfl_up_sync(FULL, v.x, off), uy = __shfl_up_sync(FULL, v.y, off);
        if (lane >= off) {
          v.x += ux;
          v.y += uy;
        }
      }
      if (lane < TABLE_THREADS / 32) s_warp[lane] = v;
    }
    __syncthreads();
    const double2 before = (warp > 0) ? s_warp[warp - 1] : make_double2(0.0, 0.0);
    const double pi = s_carry.x + before.x + ti, pm = s_carry.y + before.y + tm;
    if (k < n_f) tab[k + 1] = make_double2(pi, pm);
    __syncthreads();  // every thread has read s_warp and s_carry
    if (threadIdx.x == TABLE_THREADS - 1) s_carry = make_double2(pi, pm);  // the running total
    __syncthreads();
  }
}

__global__ void __launch_bounds__(ROW_THREADS)
snr_rows_kernel(const float* __restrict__ m1, const float* __restrict__ m2, const float* __restrict__ dl,
                const float* __restrict__ f_grid, const float* __restrict__ inv_psd,
                const double2* __restrict__ tab, float* __restrict__ out, int n, int n_f, float c_first,
                float c_mid, float c_last, float amp_scale) {
  extern __shared__ double2 smem[];
  double2* s_tab = smem;                                    // (n_f + 1,) (Gi, Gm)
  float2* s_fg = reinterpret_cast<float2*>(smem + n_f + 1);  // (n_f,) (f_k, g_k)
  for (int k = threadIdx.x; k <= n_f; k += ROW_THREADS) s_tab[k] = tab[k];
  for (int k = threadIdx.x; k < n_f; k += ROW_THREADS) {
    const float f = f_grid[k];
    const double g = (double)trapezoid_c(k, n_f, c_first, c_mid, c_last) * (double)f * (double)inv_psd[k];
    s_fg[k] = make_float2(f, (float)g);
  }
  __syncthreads();
  const float log_f0 = __logf(s_fg[0].x);
  const float inv_dlog = (float)(n_f - 1) / (__logf(s_fg[n_f - 1].x) - log_f0);
  const int lane = threadIdx.x & 31;

  for (int i = blockIdx.x * ROW_THREADS + threadIdx.x; i < n; i += gridDim.x * ROW_THREADS) {
    out[i] = row_integral(m1[i], m2[i], dl[i], s_fg, s_tab, n_f, log_f0, inv_dlog, amp_scale, lane);
  }
}

// The persistent grid for n rows on the current device: as many blocks as fit
// at once, or fewer if the rows need fewer.  The first call for a (device,
// smem) pair sets the kernel's shared-memory limit on that device and queries
// its occupancy; later calls (a graph capture among them) only look it up.
int row_blocks(int n, size_t smem) {
  static std::mutex lock;
  static std::map<std::pair<int, size_t>, int> resident;
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks;
  {
    const std::lock_guard<std::mutex> hold(lock);
    const auto key = std::make_pair(dev, smem);
    auto it = resident.find(key);
    if (it == resident.end()) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (smem > 48 * 1024) {
        cudaFuncSetAttribute(snr_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      }
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, snr_rows_kernel, ROW_THREADS, smem);
      it = resident.emplace(key, (per_sm > 0 ? per_sm : 1) * sms).first;
    }
    blocks = it->second;
  }
  const int needed = (n + ROW_THREADS - 1) / ROW_THREADS;
  return needed < blocks ? needed : blocks;
}

}  // namespace

extern "C" int snr_integral(const float* m1, const float* m2, const float* dl, const float* f_grid,
                            const float* inv_psd, void* tab, float* out, int n, int n_f, float c_first,
                            float c_mid, float c_last, float amp_scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  double2* table = static_cast<double2*>(tab);
  snr_tables_kernel<<<1, TABLE_THREADS, 0, s>>>(f_grid, inv_psd, table, n_f, c_first, c_mid, c_last);
  const cudaError_t first = cudaGetLastError();
  if (first != cudaSuccess) return (int)first;
  const size_t smem = (size_t)(n_f + 1) * sizeof(double2) + (size_t)n_f * sizeof(float2);
  snr_rows_kernel<<<row_blocks(n, smem), ROW_THREADS, smem, s>>>(m1, m2, dl, f_grid, inv_psd, table, out, n, n_f,
                                                                 c_first, c_mid, c_last, amp_scale);
  return (int)cudaGetLastError();
}
