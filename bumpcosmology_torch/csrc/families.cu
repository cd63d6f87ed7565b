// Kernel F: the joint log-likelihood's per-event and selection log-sum-exps for a mass family that
// normalises in q (POWER-LAW+PEAK, BROKEN POWER LAW, POWER LAW + SPLINE), one launch forward and one
// hand-derived backward, batched over chains.  Replaces no TPU kernel: the JAX package sends these families through XLA
// (likelihoods.py:351-361); in eager PyTorch their fused route costs about 870 launches a value+grad
// (the rows' weights, the segment log-sum-exps and the pivot, forward and backward).
//
// What a row computes, the pivot and the chain rule are csrc/families_math.cuh's (its header gives
// the formulas); this file holds the launches.  The skeleton is kernel B's (csrc/rows.cuh): one
// cluster of 8 blocks per chain, the rows cut into pieces that never straddle a segment, the `lse`
// epilogue (an event's nsamp contiguous rows, then the selection rows, each reduced to one
// log-sum-exp; no (C, N) tensor is written or read), and the backward's table cotangents as exact
// fixed-point sums, so that two launches give the same bits.
//
// Inputs per chain c: the detector table det (C, K, 2) = [z, log_jac] on v0 + k dv in log dL; the
// q-norm table nq (C, n_m) = log N_q on 2 + k dmq (built by models/plpeak.py::_log_nq_grid, outside);
// the sites scal (C, NS) in the order of fam::Slot (ops/cuda_families.py::SLOTS); the query rows qry,
// (N, 4) shared or (C, N, 4) one table a chain, [m1_det, q, log dL, log pdraw]; for POWER LAW + SPLINE a
// second per-chain table spl (C, 19, 4), the spline's cubic coefficients on each interval between its
// knots (models/pspline.py::spline_coefficients, outside), null for the other families.  The family is
// a compile-time code.  Float32 and float64.
//
// Forward: each block copies its chain's two tables to shared memory, one thread computes the chain's
// constants and its pivot (the density at MREF, QREF, ZREF: one more row a chain) into shared memory,
// and the warps evaluate R_FWD rows a lane and reduce them as B's `lse` forward does.
// Backward: each row with a non-zero segment cotangent is recomputed, its cotangent is
// g_seg exp(out - lse_seg) (exactly 0 for a -inf row, so an all -inf segment contributes nothing), and
// its chain rule adds g times its partials into NACC register accumulators and its table cotangents
// into the fixed-point bins: the detector's 2K, the q-norm table's n_m and (POWER LAW + SPLINE) the
// spline table's 76 in shared memory (ROUTE_SHARED), or the detector's in a zeroed (C, 2, 2K) int64
// scratch in device memory beyond that (ROUTE_GLOBAL, chosen from the family, the shape and the type
// before the launch).  The accumulators are reduced in a fixed order within each block and, after
// cluster.sync(), over the blocks in rank order by one thread of the cluster's first block, which also
// runs the pivot's backward (its cotangent is minus the rows' sum) into those sums, its two q-norm bins
// and its four spline bins, and writes the sites' cotangents.  After a second cluster.sync() each block
// converts an eighth of the bins to T.  Every output element is written
// exactly once.
//
// The arithmetic is the eager twin's, in its order and with its constants rounded once to T, and this
// file is built with -fmad=false (ops/_build.py), so that the bracket positions (which the q-norm and
// detector lookups take from m1 and log dL) are rounded as the twin rounds them.
//
// C interface (bound with ctypes), of the type dsize gives (4: float, 8: double), contiguous but for
// the cotangents g_ev (C, nobs) and g_sel (C,), which take element strides:
//   families_fwd    -> lse_ev (C, nobs), lse_sel (C,)
//   families_bwd    -> d_det (C, K, 2), d_nq (C, n_m), d_spl (C, 19, 4) for POWER LAW + SPLINE (null for the
//                      others), d_scal (C, NS), written in full; det_bins the (C, 2, 2K) int64 scratch on
//                      ROUTE_GLOBAL, unused (may be null) on ROUTE_SHARED
//   families_bwd_route -> the route a backward of this family, shape and type takes
// Each returns the CUDA error of its launch (0 on success), cudaErrorInvalidValue for a shape, family
// or type outside its range, or ERR_SMEM (-1) for a shape whose blocks do not fit in shared memory.

#include "rows.cuh"
#include "families_math.cuh"

namespace {

constexpr int R_FWD = 2;   // rows a lane holds in flight, forward
constexpr int R_BWD = 1;   // and backward
constexpr int WARPS = 16;  // most warps of a block, both directions
constexpr int NS = fam::NS;
constexpr int NACC = fam::NACC;

// the spline table's entries of a family: its bins in the backward's shared memory
__host__ __device__ constexpr int spl_coefs(int family) { return family == fam::PSPLINE ? fam::SPL_COEFS : 0; }

template <typename T> struct Ieee {  // a segment's exp and log in the lse epilogue
  static __device__ __forceinline__ T exp(T x) { return fam::Fn<T>::exp(x); }
  static __device__ __forceinline__ T log(T x) { return fam::Fn<T>::log(x); }
};

__device__ __forceinline__ void load_row(const float* qc, int n, float& a, float& q, float& l, float& p) {
  const float4 v = reinterpret_cast<const float4*>(qc)[n];
  a = v.x; q = v.y; l = v.z; p = v.w;
}
__device__ __forceinline__ void load_row(const double* qc, int n, double& a, double& q, double& l, double& p) {
  const double2 u = reinterpret_cast<const double2*>(qc)[2 * n];
  const double2 v = reinterpret_cast<const double2*>(qc)[2 * n + 1];
  a = u.x; q = u.y; l = v.x; p = v.y;
}

// A chain's tables to shared memory (the detector's first k_sh rows: all or none); one thread derives
// the chain's constants and pivot from the sites, the q-norm table and (POWER LAW + SPLINE) the spline
// table in device memory, the spline table kept in the chain's constants.  The caller synchronises the
// block afterwards.
template <typename T, int FAM>
__device__ __forceinline__ void load_chain(const T* det, const T* nq, const T* spl, const T* scal, int K, int k_sh,
                                           int n_m, T dmq, int c, T* s_det, T* s_nq, fam::Chain<T>* s_k) {
  const T* det_c = det + (size_t)c * 2 * K;
  for (int k = threadIdx.x; k < 2 * k_sh; k += blockDim.x) s_det[k] = det_c[k];
  for (int k = threadIdx.x; k < n_m; k += blockDim.x) s_nq[k] = nq[(size_t)c * n_m + k];
  if (threadIdx.x == 0)
    fam::chain_init<T, FAM>(*s_k, scal + (size_t)c * NS, nq + (size_t)c * n_m, n_m, dmq,
                            FAM == fam::PSPLINE ? spl + (size_t)c * fam::SPL_COEFS : nullptr);
}

__host__ __device__ __forceinline__ size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Shared memory of the forward: det (2K), nq (n_m), the chain, the pieces' pairs and s_sel.
template <typename T> size_t fwd_smem(int K, int n_m, const Work& w) {
  return align16((2 * (size_t)K + n_m) * sizeof(T)) + align16(sizeof(fam::Chain<T>))
         + (2 * (size_t)w.per_block + 2) * sizeof(T);
}

// Shared memory of the backward: the bins (the detector's on ROUTE_SHARED, the q-norm table's and n_spl
// of the spline table's), the detector rows held there, nq, the chain, the accumulators' reduction and
// the block's sums.
template <typename T> size_t bwd_smem(int K, int n_m, int n_spl, int threads, bool global_bins) {
  const size_t k_sh = global_bins ? 0 : (size_t)K;
  return (2 * k_sh + n_m + n_spl) * 2 * sizeof(unsigned long long) + align16((2 * k_sh + n_m) * sizeof(T))
         + align16(sizeof(fam::Chain<T>)) + ((size_t)NACC * threads + NACC) * sizeof(T);
}

template <typename T, int FAM, bool PER_CHAIN>
__global__ void __launch_bounds__(32 * WARPS)
families_fwd_kernel(const T* __restrict__ det, const T* __restrict__ nq, const T* __restrict__ spl,
                    const T* __restrict__ scal, const T* __restrict__ qry, T* __restrict__ lse_ev,
                    T* __restrict__ lse_sel, int K, int n_m, T v0, T dv, T dmq, Work w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_det = reinterpret_cast<T*>(smem);
  T* s_nq = s_det + 2 * K;
  fam::Chain<T>* s_k = reinterpret_cast<fam::Chain<T>*>(smem + align16((2 * (size_t)K + n_m) * sizeof(T)));
  T* s_pm = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(s_k) + align16(sizeof(fam::Chain<T>)));
  T* s_ps = s_pm + w.per_block;
  T* s_sel = s_ps + w.per_block;
  const int rank = (int)cg::this_cluster().block_rank();
  const int c = blockIdx.y;
  const T* __restrict__ qc = PER_CHAIN ? qry + (size_t)c * w.N * 4 : qry;  // this chain's rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  load_chain<T, FAM>(det, nq, spl, scal, K, K, n_m, dmq, c, s_det, s_nq, s_k);
  __syncthreads();
  const fam::Chain<T>& k = *s_k;

  const int p0 = rank * w.per_block;
  const int p1 = min(p0 + w.per_block, w.p_total);
  for (int p = p0 + warp; p < p1; p += nwarps) {
    int row0, row1, seg;
    piece_rows(w, p, row0, row1, seg);
    T o[R_FWD];
#pragma unroll
    for (int j = 0; j < R_FWD; ++j) {
      const int n = row0 + lane + 32 * j;
      o[j] = T(-INFINITY);
      if (n < row1) {
        T a, q, l, lp;
        load_row(qc, n, a, q, l, lp);
        fam::Row<T, FAM> r;
        r.eval(k, a, q, l, lp, s_det, K, v0, dv, s_nq, n_m, dmq);
        o[j] = r.out;
      }
    }
    piece_pair<Ieee<T>>(o, lane, s_pm, s_ps, p - p0);
  }
  lse_epilogue<Ieee<T>>(w, s_pm, s_ps, s_sel, p0, p1, c, lse_ev, lse_sel);
}

template <typename T, int FAM, bool PER_CHAIN, bool GLOBAL_BINS>
__global__ void __launch_bounds__(32 * WARPS)
families_bwd_kernel(const T* __restrict__ det, const T* __restrict__ nq, const T* __restrict__ spl,
                    const T* __restrict__ scal, const T* __restrict__ qry, const T* __restrict__ lse_ev,
                    const T* __restrict__ lse_sel, const T* __restrict__ g_ev, int g_ev_s0, int g_ev_s1,
                    const T* __restrict__ g_sel, int g_sel_s0, T* __restrict__ d_det, T* __restrict__ d_nq,
                    T* __restrict__ d_spl, T* __restrict__ d_scal, unsigned long long* __restrict__ det_bins, int K,
                    int n_m, T v0, T dv, T dmq, Work w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int n_spl = spl_coefs(FAM);
  const int k_sh = GLOBAL_BINS ? 0 : K;  // detector rows (table and bins) in shared memory
  const int nt_sh = 2 * k_sh + n_m;      // table entries in shared memory: the detector's, the q-norm table's
  const int nb_sh = nt_sh + n_spl;       // bins in shared memory: those tables', then the spline table's
  BinsT<T> bins;
  bins.hi = reinterpret_cast<unsigned long long*>(smem);
  bins.lo = bins.hi + nb_sh;
  T* s_det = reinterpret_cast<T*>(bins.lo + nb_sh);
  T* s_nq = s_det + 2 * k_sh;
  fam::Chain<T>* s_k = reinterpret_cast<fam::Chain<T>*>(reinterpret_cast<unsigned char*>(s_det)
                                                        + align16((size_t)nt_sh * sizeof(T)));
  T* s_red = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(s_k) + align16(sizeof(fam::Chain<T>)));
  T* s_acc = s_red + NACC * blockDim.x;  // (NACC,) the block's sums
  bins.lim = T(FX_RANGE) / T(max(w.N, 1));
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const T* __restrict__ qc = PER_CHAIN ? qry + (size_t)c * w.N * 4 : qry;
  const T* tab = GLOBAL_BINS ? det + (size_t)c * 2 * K : s_det;
  BinsT<T> dbins = bins;  // the detector's bins
  if (GLOBAL_BINS) {
    dbins.hi = det_bins + (size_t)c * 4 * K;
    dbins.lo = dbins.hi + 2 * K;
  }
  BinsT<T> nbins = bins;  // the q-norm table's bins, after the detector's in shared memory
  nbins.hi += 2 * k_sh;
  nbins.lo += 2 * k_sh;
  BinsT<T> sbins = nbins;  // the spline table's, after the q-norm table's
  sbins.hi += n_m;
  sbins.lo += n_m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  load_chain<T, FAM>(det, nq, spl, scal, K, k_sh, n_m, dmq, c, s_det, s_nq, s_k);
  for (int i = threadIdx.x; i < nb_sh; i += blockDim.x) {
    bins.hi[i] = 0ull;
    bins.lo[i] = 0ull;
  }
  __syncthreads();
  const fam::Chain<T>& k = *s_k;

  T acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = T(0);

  const int p0 = rank * w.per_block;
  const int p1 = min(p0 + w.per_block, w.p_total);
  for (int p = p0 + warp; p < p1; p += nwarps) {
    int row0, row1, seg;
    piece_rows(w, p, row0, row1, seg);
    T g_seg, l_seg;
    if (seg < w.nobs) {
      g_seg = g_ev[(size_t)c * g_ev_s0 + (size_t)seg * g_ev_s1];
      l_seg = lse_ev[(size_t)c * w.nobs + seg];
    } else {
      g_seg = g_sel[(size_t)c * g_sel_s0];
      l_seg = lse_sel[c];
    }
#pragma unroll
    for (int j = 0; j < R_BWD; ++j) {
      const int n = row0 + lane + 32 * j;
      if (n < row1 && g_seg != T(0)) {
        T a, q, l, lp;
        load_row(qc, n, a, q, l, lp);
        fam::Row<T, FAM> r;
        r.eval(k, a, q, l, lp, tab, K, v0, dv, s_nq, n_m, dmq);
        // a -inf row has cotangent exactly 0 (and every row of an all-dead segment is one)
        const T g = r.out == T(-INFINITY) ? T(0) : g_seg * fam::Fn<T>::exp(r.out - l_seg);
        if (g != T(0)) {
          fam::RowAdd<T> add;
          r.grad(k, g, s_nq, n_m, dmq, acc, add);
          fx_add(dbins, 2 * add.det_lo, add.dz0);
          fx_add(dbins, 2 * add.det_lo + 2, add.dz1);
          fx_add(dbins, 2 * add.det_lo + 1, add.dj0);
          fx_add(dbins, 2 * add.det_lo + 3, add.dj1);
          fx_add(nbins, add.nq_lo, add.n0);
          fx_add(nbins, add.nq_lo + 1, add.n1);
          if (FAM == fam::PSPLINE && add.spl.lo >= 0)
            for (int j = 0; j < 4; ++j) fx_add(sbins, 4 * add.spl.lo + j, add.spl.c[j]);
        }
      }
    }
  }

  // the block's accumulators: once through shared memory, one warp per slot, lanes in order
#pragma unroll
  for (int i = 0; i < NACC; ++i) s_red[i * blockDim.x + threadIdx.x] = acc[i];
  __syncthreads();
  for (int i = warp; i < NACC; i += nwarps) {
    T v = T(0);
    for (int t = lane; t < (int)blockDim.x; t += 32) v += s_red[i * blockDim.x + t];
    v = warp_sum(v);
    if (lane == 0) s_acc[i] = v;
  }

  // the chain's sums over the cluster in rank order, the pivot's backward, the sites' cotangents (on
  // ROUTE_GLOBAL the fence orders this thread's atomics before the cluster's barrier)
  if (GLOBAL_BINS) __threadfence();
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    T tot[NACC];
    for (int i = 0; i < NACC; ++i) {
      T v = T(0);
      for (int r = 0; r < CLUSTER; ++r) v += cluster.map_shared_rank(s_acc, r)[i];
      tot[i] = v;
    }
    int lo;
    T na, nb;
    fam::SplAdd<T> sa;
    fam::pivot_grad<T, FAM>(k, s_nq, n_m, dmq, tot, lo, na, nb, sa);
    fx_add(nbins, lo, na);
    fx_add(nbins, lo + 1, nb);
    if (FAM == fam::PSPLINE && sa.lo >= 0)
      for (int j = 0; j < 4; ++j) fx_add(sbins, 4 * sa.lo + j, sa.c[j]);
    T d[NS];
    fam::finalize<T, FAM>(k, tot, d);
    for (int i = 0; i < NS; ++i) d_scal[(size_t)c * NS + i] = d[i];
  }
  cluster.sync();

  // each block converts an eighth of the chain's bins, summed over the cluster in rank order
  const int nb = 2 * K + n_m + n_spl;
  for (int i = rank * blockDim.x + threadIdx.x; i < nb; i += CLUSTER * blockDim.x) {
    unsigned long long hi = 0ull, lo = 0ull, bad = 0ull;
    if (GLOBAL_BINS && i < 2 * K) {
      const unsigned long long l = __ldcg(&dbins.lo[i]);
      hi = __ldcg(&dbins.hi[i]);
      lo = l & ~FX_MARK;
      bad = l & FX_MARK;
    } else {
      const int j = i < 2 * K ? i : i - 2 * K + 2 * k_sh;
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) {
        const unsigned long long l = cluster.map_shared_rank(bins.lo, r)[j];
        hi += cluster.map_shared_rank(bins.hi, r)[j];
        lo += l & ~FX_MARK;
        bad |= l & FX_MARK;
      }
    }
    const T v = fx_value<T>(hi, lo, bad);
    if (i < 2 * K) d_det[(size_t)c * 2 * K + i] = v;
    else if (i < 2 * K + n_m) d_nq[(size_t)c * n_m + (i - 2 * K)] = v;
    else d_spl[(size_t)c * n_spl + (i - 2 * K - n_m)] = v;
  }
  cluster.sync();  // no block leaves while its shared memory may still be read
}

bool bad_shape(int family, int dsize, int C, int K, int n_m, int N, int qry_cs, int nobs, int nsamp) {
  return (family != fam::PLPEAK && family != fam::BROKENPL && family != fam::PSPLINE) || (dsize != 4 && dsize != 8)
         || C < 0 || C > 65535 || K < 2 || n_m < 2 || N < 0 || (qry_cs != 0 && qry_cs != N) || nobs < 0 || (nobs > 0 && nsamp < 1)
         || (long long)nobs * nsamp > N;
}

// The backward's route at this family, shape and type: ROUTE_SHARED while its bins and tables fit in a
// block's shared memory, else ROUTE_GLOBAL while the forward at the same shape fits; else ERR_SMEM.
template <typename T> int bwd_route(int family, int K, int n_m, int N, int nobs, int nsamp, int& route) {
  const Work wb = make_work(N, nobs, nsamp, R_BWD);
  const int threads = pick_threads(wb, WARPS);
  const int n_spl = spl_coefs(family);
  const size_t shared = bwd_smem<T>(K, n_m, n_spl, threads, false);
  route = ROUTE_SHARED;
  if (shared <= 48 * 1024) return 0;
  size_t most = 0;
  const cudaError_t err = smem_optin(most);
  if (err != cudaSuccess) return (int)err;
  if (shared <= most) return 0;
  route = ROUTE_GLOBAL;
  const Work wf = make_work(N, nobs, nsamp, R_FWD);
  return fwd_smem<T>(K, n_m, wf) <= most && bwd_smem<T>(K, n_m, n_spl, threads, true) <= most ? 0 : ERR_SMEM;
}

template <typename T, int FAM>
int fwd(const T* det, const T* nq, const T* spl, const T* scal, const T* qry, T* lse_ev, T* lse_sel, int C, int K,
        int n_m, int N, int qry_cs, int nobs, int nsamp, double v0, double dv, double dmq, void* stream) {
  static SmemAllowed allowed[2];
  const Work w = make_work(N, nobs, nsamp, R_FWD);
  const auto kernel = qry_cs ? &families_fwd_kernel<T, FAM, true> : &families_fwd_kernel<T, FAM, false>;
  return launch(kernel, allowed[qry_cs != 0], C, pick_threads(w, WARPS), fwd_smem<T>(K, n_m, w), stream, det, nq,
                spl, scal, qry, lse_ev, lse_sel, K, n_m, (T)v0, (T)dv, (T)dmq, w);
}

template <typename T, int FAM>
int bwd(const T* det, const T* nq, const T* spl, const T* scal, const T* qry, const T* lse_ev, const T* lse_sel,
        const T* g_ev, int g_ev_s0, int g_ev_s1, const T* g_sel, int g_sel_s0, T* d_det, T* d_nq, T* d_spl,
        T* d_scal, unsigned long long* det_bins, int C, int K, int n_m, int N, int qry_cs, int nobs, int nsamp,
        double v0, double dv, double dmq, void* stream) {
  static SmemAllowed allowed[2][2];  // [route][query layout]
  int route = ROUTE_SHARED;
  const int rc = bwd_route<T>(FAM, K, n_m, N, nobs, nsamp, route);
  if (rc != 0) return rc;
  const bool global = route == ROUTE_GLOBAL;
  if (global) {
    if (det_bins == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaMemsetAsync(det_bins, 0, (size_t)C * 4 * K * sizeof(unsigned long long),
                                            (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = global ? (qry_cs ? &families_bwd_kernel<T, FAM, true, true> : &families_bwd_kernel<T, FAM, false, true>)
                             : (qry_cs ? &families_bwd_kernel<T, FAM, true, false> : &families_bwd_kernel<T, FAM, false, false>);
  const Work w = make_work(N, nobs, nsamp, R_BWD);
  const int threads = pick_threads(w, WARPS);
  return launch(kernel, allowed[global][qry_cs != 0], C, threads, bwd_smem<T>(K, n_m, spl_coefs(FAM), threads, global),
                stream, det, nq, spl, scal, qry, lse_ev, lse_sel, g_ev, g_ev_s0, g_ev_s1, g_sel, g_sel_s0, d_det, d_nq,
                d_spl, d_scal, det_bins, K, n_m, (T)v0, (T)dv, (T)dmq, w);
}

template <typename T>
int fwd_of(int family, const void* det, const void* nq, const void* spl, const void* scal, const void* qry,
           void* lse_ev, void* lse_sel, int C, int K, int n_m, int N, int qry_cs, int nobs, int nsamp, double v0,
           double dv, double dmq, void* stream) {
  const auto f = family == fam::PLPEAK ? &fwd<T, fam::PLPEAK>
                 : family == fam::BROKENPL ? &fwd<T, fam::BROKENPL> : &fwd<T, fam::PSPLINE>;
  return f((const T*)det, (const T*)nq, (const T*)spl, (const T*)scal, (const T*)qry, (T*)lse_ev, (T*)lse_sel, C, K,
           n_m, N, qry_cs, nobs, nsamp, v0, dv, dmq, stream);
}

template <typename T>
int bwd_of(int family, const void* det, const void* nq, const void* spl, const void* scal, const void* qry,
           const void* lse_ev, const void* lse_sel, const void* g_ev, int g_ev_s0, int g_ev_s1, const void* g_sel,
           int g_sel_s0, void* d_det, void* d_nq, void* d_spl, void* d_scal, unsigned long long* det_bins, int C, int K,
           int n_m, int N, int qry_cs, int nobs, int nsamp, double v0, double dv, double dmq, void* stream) {
  const auto f = family == fam::PLPEAK ? &bwd<T, fam::PLPEAK>
                 : family == fam::BROKENPL ? &bwd<T, fam::BROKENPL> : &bwd<T, fam::PSPLINE>;
  return f((const T*)det, (const T*)nq, (const T*)spl, (const T*)scal, (const T*)qry, (const T*)lse_ev,
           (const T*)lse_sel, (const T*)g_ev, g_ev_s0, g_ev_s1, (const T*)g_sel, g_sel_s0, (T*)d_det, (T*)d_nq,
           (T*)d_spl, (T*)d_scal, det_bins, C, K, n_m, N, qry_cs, nobs, nsamp, v0, dv, dmq, stream);
}

// POWER LAW + SPLINE reads its spline table and writes its cotangent: neither pointer may be null
bool missing_spline(int family, const void* p) { return family == fam::PSPLINE && p == nullptr; }

}  // namespace

extern "C" int families_fwd(int family, int dsize, const void* det, const void* nq, const void* spl, const void* scal,
                            const void* qry, void* lse_ev, void* lse_sel, int C, int K, int n_m, int N, int qry_cs,
                            int nobs, int nsamp, double v0, double dv, double dmq, void* stream) {
  if (bad_shape(family, dsize, C, K, n_m, N, qry_cs, nobs, nsamp) || missing_spline(family, spl))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const auto f = dsize == 4 ? &fwd_of<float> : &fwd_of<double>;
  return f(family, det, nq, spl, scal, qry, lse_ev, lse_sel, C, K, n_m, N, qry_cs, nobs, nsamp, v0, dv, dmq, stream);
}

extern "C" int families_bwd(int family, int dsize, const void* det, const void* nq, const void* spl, const void* scal,
                            const void* qry, const void* lse_ev, const void* lse_sel, const void* g_ev, int g_ev_s0,
                            int g_ev_s1, const void* g_sel, int g_sel_s0, void* d_det, void* d_nq, void* d_spl,
                            void* d_scal, unsigned long long* det_bins, int C, int K, int n_m, int N, int qry_cs,
                            int nobs, int nsamp, double v0, double dv, double dmq, void* stream) {
  if (bad_shape(family, dsize, C, K, n_m, N, qry_cs, nobs, nsamp) || N >= FX_MAX_N || missing_spline(family, spl)
      || missing_spline(family, d_spl))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const auto f = dsize == 4 ? &bwd_of<float> : &bwd_of<double>;
  return f(family, det, nq, spl, scal, qry, lse_ev, lse_sel, g_ev, g_ev_s0, g_ev_s1, g_sel, g_sel_s0, d_det, d_nq,
           d_spl, d_scal, det_bins, C, K, n_m, N, qry_cs, nobs, nsamp, v0, dv, dmq, stream);
}

// The route the backward of this family, shape and type takes on the current device, into *route
// (ROUTE_SHARED 0, ROUTE_GLOBAL 1, which needs a (C, 2, 2K) int64 det_bins).  Returns 0, a CUDA error, or
// ERR_SMEM.
extern "C" int families_bwd_route(int family, int dsize, int K, int n_m, int N, int nobs, int nsamp, int* route) {
  if (bad_shape(family, dsize, 1, K, n_m, N, 0, nobs, nsamp) || N >= FX_MAX_N) return (int)cudaErrorInvalidValue;
  return dsize == 4 ? bwd_route<float>(family, K, n_m, N, nobs, nsamp, *route)
                    : bwd_route<double>(family, K, n_m, N, nobs, nsamp, *route);
}
