// Kernel T: the joint log-likelihood's cosmology and detector tables, one launch forward and one
// hand-derived backward, batched over chains.  Replaces no TPU kernel: the JAX package builds the tables
// in XLA (models/cosmology.py), where they fuse; in eager PyTorch the same code (build_cosmology, then
// build_detector_table) costs about 170 launches a value+grad, forward and backward, on every cell.
//
// Input per chain c: the sites h, Om, w (C,) each; the knots' grid (n points of log1p z from 0 to
// log1p zmax, step du) and the detector table's (n points of log dL from v0 to v1).  Output: the
// detector table (C, n, 2) = [z, log_jac], what kernels B and F read.  What a knot and a node compute,
// and their chain rule, are csrc/tables_math.cuh's (its header gives the formulas).  Float32 and float64.
//
// What bounds it on an H100: latency.  A chain's tables are a few thousand special functions and a
// prefix sum over the knots, which one block does; the card has 132 SMs and the cells 4 chains.  So one
// block a chain, everything of the chain in its shared memory (its dl, dvc, ddl and prefix sums, and in
// the backward each node's bracket and cotangents); a table too long for a block's shared memory puts the
// same arrays in a scratch in device memory (route 1, from the shape and type before the launch).
//   forward: each thread takes the segments of a contiguous run of knots and the block scans them (one
//     order, fixed by n and the block's size); the knots' entries; then each node's two brackets and
//     columns, written to the output.
//   backward: the forward again (nothing is saved but the sites); each node's cotangents on the six
//     entries it read; each knot sums those of the nodes that read it in node order (a node's brackets
//     are monotone in its index, so a knot's nodes are a contiguous run found by bisection, or, were they
//     not, every node in order: the same sum), takes them to its prefix sum's, inv_e's and dh's; the
//     block's suffix scan of the prefix sums' cotangents; each knot's inv_e to Om, 1 - Om and the exponent;
//     four block sums in a fixed tree.  No atomics: two launches give the same bits, and a chain's bits do
//     not depend on how many chains the launch holds.
// csrc/tables.cu is built with -fmad=false (ops/_build.py), so every operation rounds as the twin's
// separate launches do.
//
// C interface (bound with ctypes), contiguous, of the type dsize gives (4: float, 8: double):
//   tables_fwd   h, om, w (C,) -> out (C, n, 2)
//   tables_bwd   h, om, w (C,), g (C, n, 2) -> d_sites (3, C): the cotangents of h, Om and w
//   tables_work  the bytes of device scratch a chain needs in one direction (0: shared memory suffices)
// work is that scratch, (C, bytes), or null where none is needed.  Each launch returns the CUDA error of
// its launch (0 on success), cudaErrorInvalidValue for a shape or type outside its range, or ERR_SMEM (-1)
// where a chain needs device scratch and none was given.

#include <cuda_runtime.h>
#include <math.h>

#include "rows.cuh"  // the shared-memory opt-in (smem_optin, SmemAllowed, ERR_SMEM) and warp_sum
#include "tables_math.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// A chain's arrays: dl, dvc, ddl and the prefix sums, n each; the backward adds each node's six
// cotangents and two brackets.  After the backward's node pass dvc and ddl hold the knots' cotangents.
template <typename T> size_t work_bytes(int n, bool backward) {
  const size_t t = (size_t)(backward ? 10 : 4) * n + 4 * WARPS;
  return t * sizeof(T) + (backward ? 2 * (size_t)n * sizeof(int) : 0);
}

template <typename T> struct Grid {
  T u_end, u_step, v0, v1, v_step, inv_du;
  int n;
  __device__ T u(int i) const { return tab::linspace_at(T(0), u_end, u_step, n, i); }
  __device__ T v(int k) const { return tab::linspace_at(v0, v1, v_step, n, k); }
};

// In-place inclusive scan of a[0, len) (a suffix scan with rev), each thread a contiguous run.
template <typename T> __device__ void block_scan(T* a, int len, bool rev, T* s_warp) {
  const int per = (len + THREADS - 1) / THREADS;
  const int b = threadIdx.x * per, e = min(b + per, len);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T s = T(0);
  for (int i = b; i < e; ++i) s += a[rev ? len - 1 - i : i];
  T v = s;  // inclusive scan of the runs' sums over the warp
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T wv = lane < WARPS ? s_warp[lane] : T(0);
    for (int off = 1; off < WARPS; off <<= 1) {
      const T y = __shfl_up_sync(FULL, wv, off);
      if (lane >= off) wv += y;
    }
    if (lane < WARPS) s_warp[lane] = wv;
  }
  __syncthreads();
  T run = __shfl_up_sync(FULL, v, 1);  // the runs before this one in the warp
  if (lane == 0) run = T(0);
  if (warp > 0) run = s_warp[warp - 1] + run;
  for (int i = b; i < e; ++i) {
    T& x = a[rev ? len - 1 - i : i];
    run += x;
    x = run;
  }
  __syncthreads();
}

// Thread 0 gets the block's sum of v, in a fixed tree.
template <typename T> __device__ T block_sum(T v, T* s_warp) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0)
    for (int i = 0; i < WARPS; ++i) s += s_warp[i];
  return s;
}

// The forward's arrays of chain k in the block: the prefix sums I and the knots' dl, dvc, ddl.
template <typename T>
__device__ void build_knots(const tab::Chain<T>& k, const Grid<T>& g, T* dl, T* dvc, T* ddl, T* I, T* s_warp) {
  const int n = g.n, per = (n - 1 + THREADS - 1) / THREADS;
  const int b = threadIdx.x * per, e = min(b + per, n - 1);
  if (b < e) {
    tab::Knot<T> a = tab::knot(k, g.u(b));
    for (int j = b; j < e; ++j) {
      const tab::Knot<T> c = tab::knot(k, g.u(j + 1));
      I[j + 1] = tab::segment(a, c);
      a = c;
    }
  }
  if (threadIdx.x == 0) I[0] = T(0);
  __syncthreads();
  block_scan(I + 1, n - 1, false, s_warp);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const tab::Entries<T> r = tab::entries(k, tab::knot(k, g.u(i)), I[i]);
    dl[i] = r.dl;
    dvc[i] = r.dvc;
    ddl[i] = r.ddl;
  }
  __syncthreads();
}

template <typename T>
__device__ tab::Node<T> eval_node(const Grid<T>& g, int idx, const T* dl, const T* dvc, const T* ddl) {
  const int n = g.n;
  const T x = tab::Fn<T>::exp(g.v(idx));
  const int lo = tab::dl_bracket(dl, n, x);
  tab::Node<T> r;
  tab::node_z(r, x, dl, lo, tab::Fn<T>::expm1(g.u(lo)), tab::Fn<T>::expm1(g.u(lo + 1)), g.inv_du, n);
  tab::node_jac(r, dvc[r.lo2], dvc[r.lo2 + 1], ddl[r.lo2], ddl[r.lo2 + 1]);
  return r;
}

__device__ __forceinline__ unsigned char* chain_work(unsigned char* work, size_t bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  return work ? work + (size_t)blockIdx.x * bytes : smem;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tables_fwd_kernel(const T* __restrict__ h, const T* __restrict__ om, const T* __restrict__ w, T* __restrict__ out,
                  unsigned char* work, size_t bytes, Grid<T> g) {
  const int c = blockIdx.x, n = g.n;
  T* dl = reinterpret_cast<T*>(chain_work(work, bytes));
  T *dvc = dl + n, *ddl = dvc + n, *I = ddl + n, *s_warp = I + n;
  const tab::Chain<T> k = tab::chain_init(h[c], om[c], w[c]);
  build_knots(k, g, dl, dvc, ddl, I, s_warp);
  T* oc = out + (size_t)c * 2 * n;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const tab::Node<T> r = eval_node(g, idx, dl, dvc, ddl);
    oc[2 * idx] = r.zk;
    oc[2 * idx + 1] = r.lj;
  }
}

// The first index of the non-decreasing a[0, len) at or above v.
__device__ __forceinline__ int lower_bound(const int* a, int len, int v) {
  int s = 0, e = len;
  while (s < e) {
    const int m = s + ((e - s) >> 1);
    if (a[m] < v) s = m + 1;
    else e = m;
  }
  return s;
}

// The sum, in node order, of c0 over the nodes bracketed at i and of c1 over those bracketed at i - 1.
template <typename T>
__device__ T gather(const int* lo, const T* c0, const T* c1, int n_nodes, int i, bool monotone) {
  T s0 = T(0), s1 = T(0);
  if (monotone) {
    const int a = lower_bound(lo, n_nodes, i - 1), b = lower_bound(lo, n_nodes, i), e = lower_bound(lo, n_nodes, i + 1);
    for (int idx = b; idx < e; ++idx) s0 += c0[idx];
    for (int idx = a; idx < b; ++idx) s1 += c1[idx];
  } else {
    for (int idx = 0; idx < n_nodes; ++idx) {
      if (lo[idx] == i) s0 += c0[idx];
      if (lo[idx] == i - 1) s1 += c1[idx];
    }
  }
  return s0 + s1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tables_bwd_kernel(const T* __restrict__ h, const T* __restrict__ om, const T* __restrict__ w,
                  const T* __restrict__ gout, T* __restrict__ d_sites, unsigned char* work, size_t bytes, Grid<T> g) {
  const int c = blockIdx.x, n = g.n;
  T* dl = reinterpret_cast<T*>(chain_work(work, bytes));
  T *dvc = dl + n, *ddl = dvc + n, *I = ddl + n;
  T *cl0 = I + n, *cl1 = cl0 + n, *cv0 = cl1 + n, *cv1 = cv0 + n, *cd0 = cv1 + n, *cd1 = cd0 + n;
  T* s_warp = cd1 + n;
  int* lo = reinterpret_cast<int*>(s_warp + 4 * WARPS);
  int* lo2 = lo + n;
  const tab::Chain<T> k = tab::chain_init(h[c], om[c], w[c]);
  build_knots(k, g, dl, dvc, ddl, I, s_warp);

  // each node's cotangents on the six entries it read
  const T* gc = gout + (size_t)c * 2 * n;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const tab::Node<T> r = eval_node(g, idx, dl, dvc, ddl);
    const tab::NodeGrad<T> d = tab::node_grad(r, gc[2 * idx], gc[2 * idx + 1], g.inv_du);
    lo[idx] = r.lo;
    lo2[idx] = r.lo2;
    cl0[idx] = d.dl0;
    cl1[idx] = d.dl1;
    cv0[idx] = d.dvc0;
    cv1[idx] = d.dvc1;
    cd0[idx] = d.ddl0;
    cd1[idx] = d.ddl1;
  }
  __syncthreads();
  bool down = false;
  for (int idx = threadIdx.x + 1; idx < n; idx += THREADS) down |= lo[idx] < lo[idx - 1] || lo2[idx] < lo2[idx - 1];
  const bool monotone = !__syncthreads_or(down);

  // each knot: its entries' cotangents, then those of its prefix sum (into dvc) and of inv_e (into ddl)
  T sdh = T(0);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const T gdl = gather(lo, cl0, cl1, n, i, monotone);
    const T gdvc = gather(lo2, cv0, cv1, n, i, monotone);
    const T gddl = gather(lo2, cd0, cd1, n, i, monotone);
    const tab::KnotGrad<T> r = tab::knot_grad(k, tab::knot(k, g.u(i)), I[i], gdl, gdvc, gddl);
    sdh += r.gdh;
    dvc[i] = r.gi;
    ddl[i] = r.gie;
  }
  __syncthreads();
  // the cotangent of segment j is the sum of the prefix sums' from j + 1 on
  T* gseg = dvc + 1;
  block_scan(gseg, n - 1, true, s_warp);

  T som = T(0), somm = T(0), se = T(0);
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const tab::Knot<T> q = tab::knot(k, g.u(i));
    T gie = ddl[i];
    if (i < n - 1) gie += tab::segment_grad(q, tab::knot(k, g.u(i + 1)), gseg[i]);
    if (i > 0) gie += tab::segment_grad(tab::knot(k, g.u(i - 1)), q, gseg[i - 1]);
    const tab::EGrad<T> r = tab::efunc_grad(k, q, gie);
    som += r.gom;
    somm += r.gomm;
    se += r.ge;
  }
  const T sums[4] = {block_sum(sdh, s_warp), block_sum(som, s_warp), block_sum(somm, s_warp),
                     block_sum(se, s_warp)};
  if (threadIdx.x == 0) {
    T out[3];
    tab::site_grad(k, sums[0], sums[1], sums[2], sums[3], out);
    for (int s = 0; s < 3; ++s) d_sites[(size_t)s * gridDim.x + c] = out[s];
  }
}

template <typename T> Grid<T> make_grid(int n, double u_end, double du, double v0, double v1) {
  Grid<T> g;
  g.n = n;
  g.u_end = (T)u_end;
  g.u_step = (g.u_end - T(0)) / (T)(n - 1);  // torch.linspace's step, in T
  g.v0 = (T)v0;
  g.v1 = (T)v1;
  g.v_step = (g.v1 - g.v0) / (T)(n - 1);
  g.inv_du = T(1) / (T)du;  // PyTorch's CUDA division by a Python scalar: a product by its reciprocal
  return g;
}

// One block a chain, the chain's arrays in shared memory or, where work is given, in device memory.
template <typename Kernel, typename... Args>
int launch_chains(Kernel kernel, SmemAllowed& allowed, int C, size_t bytes, const void* work, void* stream,
                  Args... args) {
  size_t smem = 0;
  if (work == nullptr) {
    size_t most = 0;
    cudaError_t err = smem_optin(most);
    if (err != cudaSuccess) return (int)err;
    if (bytes > most) return ERR_SMEM;
    smem = bytes;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > allowed.bytes[dev])) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < MAX_DEVICES) allowed.bytes[dev] = smem;
    }
  }
  kernel<<<C, THREADS, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* h, const void* om, const void* w, void* out, void* work, int C, int n, double u_end, double du,
        double v0, double v1, void* stream) {
  static SmemAllowed allowed;
  const size_t bytes = work_bytes<T>(n, false);
  return launch_chains(&tables_fwd_kernel<T>, allowed, C, bytes, work, stream, (const T*)h, (const T*)om, (const T*)w,
                (T*)out, (unsigned char*)work, bytes, make_grid<T>(n, u_end, du, v0, v1));
}

template <typename T>
int bwd(const void* h, const void* om, const void* w, const void* g, void* d_sites, void* work, int C, int n,
        double u_end, double du, double v0, double v1, void* stream) {
  static SmemAllowed allowed;
  const size_t bytes = work_bytes<T>(n, true);
  return launch_chains(&tables_bwd_kernel<T>, allowed, C, bytes, work, stream, (const T*)h, (const T*)om, (const T*)w,
                (const T*)g, (T*)d_sites, (unsigned char*)work, bytes, make_grid<T>(n, u_end, du, v0, v1));
}

bool bad_shape(int dsize, int C, int n) { return (dsize != 4 && dsize != 8) || C < 0 || n < 2 || n > (1 << 24); }

}  // namespace

extern "C" int tables_fwd(int dsize, const void* h, const void* om, const void* w, void* out, void* work, int C, int n,
                          double u_end, double du, double v0, double v1, void* stream) {
  if (bad_shape(dsize, C, n)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  return (dsize == 4 ? &fwd<float> : &fwd<double>)(h, om, w, out, work, C, n, u_end, du, v0, v1, stream);
}

extern "C" int tables_bwd(int dsize, const void* h, const void* om, const void* w, const void* g, void* d_sites,
                          void* work, int C, int n, double u_end, double du, double v0, double v1, void* stream) {
  if (bad_shape(dsize, C, n)) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  return (dsize == 4 ? &bwd<float> : &bwd<double>)(h, om, w, g, d_sites, work, C, n, u_end, du, v0, v1, stream);
}

// Into *bytes, the device scratch a chain needs for a launch of this type and n in one direction (backward
// nonzero): 0 where its arrays fit in a block's shared memory on the current device.  Returns 0 or a CUDA error.
extern "C" int tables_work(int dsize, int n, int backward, long long* bytes) {
  if (bad_shape(dsize, 1, n)) return (int)cudaErrorInvalidValue;
  size_t most = 0;
  const cudaError_t err = smem_optin(most);
  if (err != cudaSuccess) return (int)err;
  const size_t need = dsize == 4 ? work_bytes<float>(n, backward != 0) : work_bytes<double>(n, backward != 0);
  *bytes = need <= most ? 0 : (long long)need;
  return 0;
}
