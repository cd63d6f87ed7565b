// The skeleton that kernel B (csrc/logwts.cu) and kernel F (csrc/families.cu) share: one thread-block
// cluster of CLUSTER blocks per chain, the rows of a chain cut into pieces that never straddle a
// segment (an event's nsamp contiguous rows, or the selection rows after them), the `lse` epilogue
// that reduces each segment's rows to one log-sum-exp over the cluster's distributed shared memory,
// the backward's table cotangents as exact fixed-point sums (in shared memory, or in a zeroed scratch
// in device memory beyond it) and the cluster launch.  csrc/logwts.cu's header explains each choice;
// the code here is B's, templated on the scalar type T (float; double for F) and on the functions M
// that take a segment's exp and log (B's __expf and logf; F's IEEE ones).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // blocks per chain: the portable maximum cluster size
constexpr unsigned FULL = 0xffffffffu;
// fixed-point table cotangents: units of 2^-40, split into words of 2^32 units
constexpr double FX_ONE = 1099511627776.0;             // 2^40
constexpr double FX_WORD = 4294967296.0;               // 2^32
constexpr double FX_INV_WORD = 2.3283064365386963e-10;  // 2^-32
constexpr double FX_HI_UNIT = 0.00390625;              // 2^-8: a hi word in units of one
constexpr double FX_LO_UNIT = 9.094947017729282e-13;   // 2^-40
constexpr float FX_RANGE = 4503599627370496.0f;        // 2^52: the bound on |v| N
constexpr unsigned long long FX_MARK = 1ull << 63;     // a lo word's out-of-range mark
constexpr int FX_MAX_N = 1 << 29;                      // the backward's rows a chain, below

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

__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) { return fmax(a, b); }

template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int off = 16; off > 0; off >>= 1) v = tmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// (m, s) <- the pair of log(s exp(m) + s2 exp(m2)); an empty pair is (-inf, 0)
template <typename M, typename T> __device__ __forceinline__ void lse_merge(T& m, T& s, T m2, T s2) {
  const T mm = tmax(m, m2);
  if (mm == T(-INFINITY)) {
    s = T(0);
  } else {
    s = s * M::exp(m - mm) + s2 * M::exp(m2 - mm);
  }
  m = mm;
}

// all lanes end with the merge of the warp's 32 pairs
template <typename M, typename T> __device__ __forceinline__ void warp_lse_merge(T& m, T& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const T m2 = __shfl_xor_sync(FULL, m, off);
    const T s2 = __shfl_xor_sync(FULL, s, off);
    lse_merge<M>(m, s, m2, s2);
  }
}

// A warp's piece of R rows a lane, out[j] = -inf where there is no row: its (max, sum) pair, stored
// by lane 0 at s_pm[i], s_ps[i].
template <typename M, int R, typename T>
__device__ __forceinline__ void piece_pair(const T (&o)[R], int lane, T* s_pm, T* s_ps, int i) {
  T m = o[0];
#pragma unroll
  for (int j = 1; j < R; ++j) m = tmax(m, o[j]);
  m = warp_max(m);
  T sum = T(0);
  if (m > T(-INFINITY)) {
#pragma unroll
    for (int j = 0; j < R; ++j) sum += M::exp(o[j] - m);
  }
  sum = warp_sum(sum);
  if (lane == 0) {
    s_pm[i] = m;
    s_ps[i] = sum;
  }
}

// The `lse` epilogue, after every piece of the block has its pair at s_pm, s_ps (index p - p0): the
// block's selection pieces merged into s_sel, then, after cluster.sync(), one warp per segment merges
// over the cluster (an event's few pieces where they lie, the selection's one pair per block) and
// stores one log-sum-exp; -inf for a segment whose rows are all -inf.
template <typename M, typename T>
__device__ __forceinline__ void lse_epilogue(const Work& w, T* s_pm, T* s_ps, T* s_sel, int p0, int p1,
                                             int c, T* __restrict__ lse_ev, T* __restrict__ lse_sel) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  // the block's own selection pieces first, from its own shared memory
  __syncthreads();
  if (warp == 0) {
    T m = T(-INFINITY), sum = T(0);
    for (int p = max(p0, w.p_ev) + lane; p < p1; p += 32) lse_merge<M>(m, sum, s_pm[p - p0], s_ps[p - p0]);
    warp_lse_merge<M>(m, sum);
    if (lane == 0) {
      s_sel[0] = m;
      s_sel[1] = sum;
    }
  }
  cluster.sync();
  for (int seg = rank * nwarps + warp; seg <= w.nobs; seg += CLUSTER * nwarps) {
    T m = T(-INFINITY), sum = T(0);
    if (seg < w.nobs) {
      for (int p = seg * w.spe + lane; p < (seg + 1) * w.spe; p += 32) {
        const int r = p / w.per_block;
        const int i = p - r * w.per_block;
        lse_merge<M>(m, sum, cluster.map_shared_rank(s_pm, r)[i], cluster.map_shared_rank(s_ps, r)[i]);
      }
    } else if (lane < CLUSTER) {
      const T* remote = cluster.map_shared_rank(s_sel, lane);
      lse_merge<M>(m, sum, remote[0], remote[1]);
    }
    warp_lse_merge<M>(m, sum);
    if (lane == 0) {
      const T v = m == T(-INFINITY) ? T(-INFINITY) : m + M::log(sum);
      if (seg < w.nobs) lse_ev[(size_t)c * w.nobs + seg] = v;
      else lse_sel[c] = v;
    }
  }
  cluster.sync();  // no block leaves while its shared memory may still be read
}

// A chain's table-cotangent bins in fixed point (csrc/logwts.cu's header): the hi and lo words of
// each bin (bit 63 of lo marks a contribution out of range), and the limit on |v|.
template <typename T> struct BinsT {
  unsigned long long* hi;
  unsigned long long* lo;
  T lim;
};

__device__ __forceinline__ float fx_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double fx_abs(double v) { return fabs(v); }

template <typename T> __device__ __forceinline__ void fx_add(const BinsT<T>& b, int bin, T v) {
  if (v == T(0)) return;
  if (!(fx_abs(v) < b.lim)) {  // also NaN and inf
    atomicOr(&b.lo[bin], FX_MARK);
    return;
  }
  const double x = rint((double)v * FX_ONE);
  const double h = floor(x * FX_INV_WORD);
  const double l = x - h * FX_WORD;  // exact: an integer in [0, 2^32)
  atomicAdd(&b.hi[bin], (unsigned long long)(long long)h);
  if (l != 0.0) atomicAdd(&b.lo[bin], (unsigned long long)l);
}

// A bin's value from its summed words; NaN where a contribution was out of range.
template <typename T> __device__ __forceinline__ T fx_value(unsigned long long hi, unsigned long long lo,
                                                            unsigned long long bad) {
  return bad ? T(NAN) : (T)((double)(long long)hi * FX_HI_UNIT + (double)lo * FX_LO_UNIT);
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

}  // namespace
