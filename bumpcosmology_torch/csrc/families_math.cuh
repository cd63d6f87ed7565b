// Kernel F's arithmetic: one row of a q-normalised mass family's joint log-weight, its pivot and
// the hand-derived chain rule of both, for one chain.  Included by csrc/families.cu; written as
// __host__ __device__ functions of the scalar type T (float or double) and the family, so that
// the same code can be compiled for the host and held against PyTorch's autograd of the eager
// twin (models/plpeak.py, models/brokenpl.py, models/pspline.py,
// inference/likelihoods.py::_cosmo_frame_logwts_fused).
//
// Per query row (a = m1_det, q, log dL, log pdraw) of chain c:
//   z, log_jac = lerp of the detector table at (log dL - v0) / dv;  m1 = a / (1 + z)
//   out = ((((((log p(m1) + beta_q log q) + log S(q m1)) - log N_q(m1)) + log dN/dV(z)) + log_norm)
//          - 2 log1p z) + log_jac) - log pdraw
// with log N_q a lerp of the (C, n_m) q-norm table on the uniform grid 2 + k dm, and
//   log_norm = -((((((log p(MREF) + beta_q log QREF) + log S(QREF MREF)) - log N_q(MREF))
//                  + (shape(0) - shape(0))) + 0) + log MREF)
// the pivot, the same density at (MREF, QREF, ZREF) with no frame terms.
//   POWER-LAW+PEAK  log p(m) = (logaddexp(((log1p(-lam_peak) - alpha log m) - lpn(alpha, mmin, mmax))
//                                         - 25 relu(m - mmax),
//                                         ((log lam_peak - 0.5 u^2) - log sigma_m) - log sqrt(2 pi))
//                               + log S(m)) - 25 relu(m - 190),   u = (m - mu_m) / sigma_m
//   BROKEN POWER LAW log p(m) = (((m < mbreak ? -alpha1 log m : -alpha2 log m + (alpha2 - alpha1) log mbreak)
//                                 - logaddexp(lpn(alpha1, mmin, mbreak),
//                                             (alpha2 - alpha1) log mbreak + lpn(alpha2, mbreak, mmax)))
//                                + log S(m)) - 25 relu(m - mmax)) - 25 relu(m - 200),
//                    mbreak = mmin + bfrac (mmax - mmin)
//   POWER LAW + SPLINE log p(m) = ((((-alpha log m) - 25 relu(m - mmax)) + log S(m)) + f(log m)) - 25 relu(m - 190),
//                    f on interval i of the knots log 2 + i h (h = log(50) / 19), t = pos - i, pos = (log m - log 2) / h:
//                    c0 + t (c1 + t (c2 + t c3)) from the chain's (19, 4) coefficient table; 0 outside [2, 100] Msun
//   log S(x + mmin): the Planck taper of models/plpeak.py::log_planck_taper with its clamps, foot and
//   top; shape(z) = lam log1p z - softplus(kappa log((1 + z) / (1 + zp))).
// Every operation is the eager twin's, in its order and with its constants rounded once to T;
// csrc/families.cu is built with -fmad=false, so nothing is contracted into a fused multiply-add.
//
// The backward takes a row's cotangent g and adds g times the row's partial derivatives with
// respect to a chain's per-chain quantities into NACC accumulators (the family's intermediates,
// below), and returns the cotangents of the four detector-table entries and the two q-norm-table
// entries it read, and for POWER LAW + SPLINE the cotangents g (1, t, t^2, t^3) of the four
// coefficients of the interval it read (SplAdd).  finalize() turns the accumulated sums, the pivot's included, into the
// cotangents of the sites.  Where the eager code picks a subgradient, the same one is picked here:
// torch.maximum / minimum split a tie in halves, clamp passes its bounds, clamp_min(v, 0) passes 0,
// abs has slope 0 at 0, torch.where sends nothing to the branch it did not take.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define FAM_HD __host__ __device__ __forceinline__
#else
#define FAM_HD inline
#endif

namespace fam {

enum Family { PLPEAK = 0, BROKENPL = 1, PSPLINE = 2 };

// the sites a chain gives, in the order of ops/cuda_families.py::SLOTS
enum Slot { BQ = 0, MMIN, MMAX, DELTA, LAMZ, KAPPA, ZP, P0, P1, P2, P3, NS };
// P0..P3: POWER-LAW+PEAK alpha, lam_peak, mu_m, sigma_m; BROKEN POWER LAW alpha1, alpha2, bfrac, (unused);
// POWER LAW + SPLINE alpha, (unused) x 3

// accumulated cotangents: g times a row's partial derivative with respect to ...
enum Acc {
  A_BQ = 0,   // beta_q
  A_MMIN,     // mmin, through both tapers
  A_MMAX,     // mmax, through the walls
  A_DM,       // the taper's width max(delta_m, 1e-6)
  A_LAMZ,     // lam (redshift)
  A_KAPPA,    // kappa
  A_ZP,       // zp
  A_SUMG,     // log_norm: the data rows' cotangents summed (the pivot's own cotangent is minus this)
  A_F0,       // PLPEAK: log1p(-lam_peak) (and minus lpn)   BROKENPL: alpha1 (lower branch, times -log m)
  A_F1,       // PLPEAK: alpha (times -log m)               BROKENPL: alpha2 (upper branch, times -log m)
              // PSPLINE: alpha (times -log m)
  A_F2,       // PLPEAK: log lam_peak                        BROKENPL: (alpha2 - alpha1) log mbreak
  A_F3,       // PLPEAK: mu_m                                BROKENPL: the rows' cotangents (the norm's)
  A_F4,       // PLPEAK: sigma_m (times sigma_m)
  NACC
};

constexpr double MREF = 30.0;    // models/mass.py::MREF
constexpr double QREF = 1.0;     // models/plpeak.py::QREF
constexpr double LOG_MREF = 3.4011973816621555;
constexpr double M_TAB_LO = 2.0;  // the q-norm table's first mass
constexpr double WALL = 25.0;     // WALL_SLOPE
constexpr double FOOT = 4.0;      // FOOT_SLOPE
constexpr double X_C = 0.10961179679779243;  // (10 - sqrt 68) / 16
constexpr double TOP_PLPEAK = 190.0;  // M_TAB_HI - 10
constexpr double TOP_BROKENPL = 200.0;  // M_TAB_HI
constexpr double LOG_SQRT_2PI = 0.9189385332046727;
// the spline of POWER LAW + SPLINE (models/pspline.py): knots log 2 + i h, i < SPL_KNOTS, on [2, 100] Msun
constexpr int SPL_KNOTS = 20;
constexpr int SPL_COEFS = (SPL_KNOTS - 1) * 4;  // a chain's (19, 4) coefficient table
constexpr double SPL_M_LO = 2.0, SPL_M_HI = 100.0;
constexpr double SPL_X0 = 0.6931471805599453;   // log 2
constexpr double SPL_H = 0.20589594765411295;   // log(100 / 2) / 19

template <typename T> struct Fn;
template <> struct Fn<float> {
  static FAM_HD float exp(float x) { return expf(x); }
  static FAM_HD float log(float x) { return logf(x); }
  static FAM_HD float log1p(float x) { return log1pf(x); }
  static FAM_HD float expm1(float x) { return expm1f(x); }
  static FAM_HD float floor(float x) { return floorf(x); }
  static FAM_HD float abs(float x) { return fabsf(x); }
  static FAM_HD float max(float a, float b) { return fmaxf(a, b); }
  static FAM_HD float min(float a, float b) { return fminf(a, b); }
};
template <> struct Fn<double> {
  static FAM_HD double exp(double x) { return ::exp(x); }
  static FAM_HD double log(double x) { return ::log(x); }
  static FAM_HD double log1p(double x) { return ::log1p(x); }
  static FAM_HD double expm1(double x) { return ::expm1(x); }
  static FAM_HD double floor(double x) { return ::floor(x); }
  static FAM_HD double abs(double x) { return fabs(x); }
  static FAM_HD double max(double a, double b) { return fmax(a, b); }
  static FAM_HD double min(double a, double b) { return fmin(a, b); }
};

// d max(a, b) / d a and d min(a, b) / d a, as torch.maximum / minimum's backward: half at a tie
template <typename T> FAM_HD T dmax(T a, T b) { return a > b ? T(1) : (a == b ? T(0.5) : T(0)); }
template <typename T> FAM_HD T dmin(T a, T b) { return a < b ? T(1) : (a == b ? T(0.5) : T(0)); }

// torch.logaddexp's value; its derivative in its first argument is 1 / (1 + exp(b - a))
template <typename T> FAM_HD T logaddexp(T a, T b) {
  if (a == b && (a == T(INFINITY) || a == T(-INFINITY))) return a;
  return Fn<T>::max(a, b) + Fn<T>::log1p(Fn<T>::exp(-Fn<T>::abs(a - b)));
}
template <typename T> FAM_HD T dlogaddexp(T a, T b) { return T(1) / (T(1) + Fn<T>::exp(b - a)); }

// ops/special.py::softplus, clamp_min(y, 0) + log1p(exp(-|y|)), and its autograd derivative
template <typename T> FAM_HD T softplus(T y) {
  return Fn<T>::max(y, T(0)) + Fn<T>::log1p(Fn<T>::exp(-Fn<T>::abs(y)));
}
template <typename T> FAM_HD T dsoftplus(T y) {
  const T e = Fn<T>::exp(-Fn<T>::abs(y));
  const T sgn = y > T(0) ? T(1) : (y < T(0) ? T(-1) : T(0));
  return (y >= T(0) ? T(1) : T(0)) - sgn * (e / (T(1) + e));
}

// _interp_unit_gather's bracket: lo = clip(floor(pos), 0, n - 2), t = clip(pos - lo, 0, 1); the
// lerp's slope reaches pos where pos - lo lies in [0, 1] (clamp's backward passes its bounds)
template <typename T> struct Bracket {
  int lo;
  T t;
  bool slope;
};
template <typename T> FAM_HD Bracket<T> bracket(T pos, int n) {
  T lo = Fn<T>::floor(pos);
  lo = lo != lo ? T(0) : lo;  // a NaN position takes lo = 0, as nan_to_num
  lo = Fn<T>::min(Fn<T>::max(lo, T(0)), T(n - 2));
  const T traw = pos - lo;
  Bracket<T> b;
  b.lo = (int)lo;
  b.t = Fn<T>::min(Fn<T>::max(traw, T(0)), T(1));
  b.slope = traw >= T(0) && traw <= T(1);
  return b;
}

// log_planck_taper at m = x + mmin and its derivatives in x and in the width dm = max(delta_m, 1e-6)
template <typename T> struct Taper {
  T val, dx, ddm;
};
template <typename T, bool GRAD> FAM_HD Taper<T> taper(T x, T dm) {
  const T xlo = T(X_C) * dm, xhi = T(0.98) * dm;
  const T inner = Fn<T>::max(x, xlo);
  const T xin = Fn<T>::min(inner, xhi);
  const T f_raw = dm / xin + dm / (xin - dm);
  const T f = Fn<T>::min(Fn<T>::max(f_raw, T(-80)), T(80));
  const T mid = -logaddexp(f, T(0));
  const T r = Fn<T>::max(xlo - x, T(0));
  const bool top = x >= dm;
  Taper<T> out;
  out.val = top ? T(0) : mid - T(FOOT) * r;
  out.dx = T(0);
  out.ddm = T(0);
  if (GRAD && !top) {
    const T dmid_df = (f_raw >= T(-80) && f_raw <= T(80)) ? -dlogaddexp(f, T(0)) : T(0);
    const T xm = xin - dm;
    const T dmid_dxin = dmid_df * (-(dm / (xin * xin)) - dm / (xm * xm));
    const T dxin_dinner = dmin(inner, xhi);
    const T dr = T(FOOT) * dmax(xlo - x, T(0));
    const T d_inner = dmid_dxin * dxin_dinner;
    const T d_xlo = d_inner * (T(1) - dmax(x, xlo)) - dr;
    const T d_xhi = dmid_dxin * (T(1) - dxin_dinner);
    out.dx = d_inner * dmax(x, xlo) + dr;
    out.ddm = dmid_df * (T(1) / xin + T(1) / xm + dm / (xm * xm)) + T(X_C) * d_xlo + T(0.98) * d_xhi;
  }
  return out;
}

// _log_pl_norm_inv(alpha, lo, hi) = log ∫_lo^hi m^-alpha dm through alpha = 1, and its derivatives
template <typename T> struct Lpn {
  T val, d_alpha, d_lo, d_hi;
};
template <typename T> FAM_HD Lpn<T> log_pl_norm_inv(T alpha, T lo, T hi) {
  const T t = T(1) - alpha;
  const T u = hi / lo;
  const T L = Fn<T>::log(u);
  const T x = t * L;
  const bool small = Fn<T>::abs(x) < T(1e-12);
  const T xs = small ? T(1) : x;
  const T em = Fn<T>::expm1(xs);
  const T ratio = small ? T(1) + T(0.5) * x : em / xs;
  const T log_lo = Fn<T>::log(lo);
  Lpn<T> r;
  r.val = (t * log_lo + Fn<T>::log(L)) + Fn<T>::log(ratio);
  const T dlr = (small ? T(0.5) : (em + T(1)) / xs - em / (xs * xs)) / ratio;  // d log ratio / d x
  const T d_L = T(1) / L + dlr * t;
  r.d_alpha = -(log_lo + dlr * L);
  r.d_lo = t / lo - d_L * (hi / (lo * lo)) / u;
  r.d_hi = d_L / (u * lo);
  return r;
}

// What a chain's rows share: its sites and what is computed once from them.
template <typename T> struct Chain {
  T s[NS];
  T spl[SPL_COEFS];     // PSPLINE: the coefficient table (unset for the other families)
  T dm;                 // the taper's width, max(delta_m, 1e-6)
  T l1m, llam, lpn, lsig;  // PLPEAK: log1p(-lam_peak), log lam_peak, lpn(alpha, mmin, mmax), log sigma_m
  T mbreak, kterm, ln;     // BROKENPL: the break, (alpha2 - alpha1) log mbreak, the norm's logaddexp
  T opzp, lr0, sp0, dsp0, shape0;  // the rate at z = 0: 1 + zp, log(1 / (1 + zp)), its softplus and slope
  T log_norm;           // the pivot
};

// What a row's backward sends to the spline's coefficient table: the cotangents of the four
// coefficients of interval lo (lo < 0: none, a mass outside the knots or another family).
template <typename T> struct SplAdd {
  int lo;
  T c[4];
};

// f(log m) of the chain's spline (models/pspline.py::log_spline): the interval's cubic in t by
// Horner's rule, 0 outside [SPL_M_LO, SPL_M_HI]; with GRAD df/dm into d_m and g (1, t, t^2, t^3) into sa.
template <typename T, bool GRAD> FAM_HD T spline(const T* coef, T m, T logm, T g, T& d_m, SplAdd<T>& sa) {
  const Bracket<T> b = bracket((logm - T(SPL_X0)) / T(SPL_H), SPL_KNOTS);
  const T* c = coef + 4 * b.lo;
  const T t = b.t;
  const T c3 = c[3];
  const T bb = c[2] + t * c3;
  const T aa = c[1] + t * bb;
  const T f = c[0] + t * aa;
  d_m = T(0);
  if (!(m >= T(SPL_M_LO) && m <= T(SPL_M_HI))) return T(0);
  if (GRAD) {
    if (b.slope) d_m = ((aa + t * (bb + t * c3)) / T(SPL_H)) / m;
    const T gt = g * t, gtt = gt * t;
    sa.lo = b.lo;
    sa.c[0] = g;
    sa.c[1] = gt;
    sa.c[2] = gtt;
    sa.c[3] = gtt * t;
  }
  return f;
}

// log p(m) of the family, and with GRAD its derivative in m, g times its partials into acc (and
// for PSPLINE the spline's table cotangents into sa, whose lo the caller sets to -1)
template <typename T, int FAM, bool GRAD>
FAM_HD T log_pm(const Chain<T>& k, T m, T g, T* acc, T& d_m, SplAdd<T>& sa) {
  const T logm = Fn<T>::log(m);
  const T mmax = k.s[MMAX];
  const T rmax = Fn<T>::max(m - mmax, T(0));
  const Taper<T> tp = taper<T, GRAD>(m - k.s[MMIN], k.dm);
  T out;
  if (FAM == PLPEAK) {
    const T alpha = k.s[P0], sigma = k.s[P3];
    const T lpl = ((k.l1m - alpha * logm) - k.lpn) - T(WALL) * rmax;
    const T u = (m - k.s[P2]) / sigma;
    const T lpk = ((k.llam - T(0.5) * (u * u)) - k.lsig) - T(LOG_SQRT_2PI);
    const T top = Fn<T>::max(m - T(TOP_PLPEAK), T(0));
    out = (logaddexp(lpl, lpk) + tp.val) - T(WALL) * top;
    if (GRAD) {
      const T wa = dlogaddexp(lpl, lpk), wb = dlogaddexp(lpk, lpl);
      const T dr = T(WALL) * dmax(m - mmax, T(0));
      acc[A_F0] += g * wa;
      acc[A_F1] += g * (wa * logm);
      acc[A_MMAX] += g * (wa * dr);
      acc[A_F2] += g * wb;
      acc[A_F3] += g * (wb * (u / sigma));
      acc[A_F4] += g * (wb * (u * u));
      d_m = (wa * (-(alpha / m) - dr) + wb * -(u / sigma)) + tp.dx - T(WALL) * dmax(m - T(TOP_PLPEAK), T(0));
    }
  } else if (FAM == PSPLINE) {
    const T alpha = k.s[P0];
    T d_f;
    const T f = spline<T, GRAD>(k.spl, m, logm, g, d_f, sa);
    const T top = Fn<T>::max(m - T(TOP_PLPEAK), T(0));
    out = ((((-alpha * logm) - T(WALL) * rmax) + tp.val) + f) - T(WALL) * top;
    if (GRAD) {
      const T dr = T(WALL) * dmax(m - mmax, T(0));
      acc[A_F1] += g * logm;
      acc[A_MMAX] += g * dr;
      d_m = (((-(alpha / m) - dr) + tp.dx) + d_f) - T(WALL) * dmax(m - T(TOP_PLPEAK), T(0));
    }
  } else {
    const bool hi = !(m < k.mbreak);
    const T a1 = k.s[P0], a2 = k.s[P1];
    const T branch = hi ? -a2 * logm + k.kterm : -a1 * logm;
    const T top = Fn<T>::max(m - T(TOP_BROKENPL), T(0));
    out = (((branch - k.ln) + tp.val) - T(WALL) * rmax) - T(WALL) * top;
    if (GRAD) {
      const T dr = T(WALL) * dmax(m - mmax, T(0));
      const T gl = g * logm;
      acc[A_F0] += hi ? T(0) : gl;
      acc[A_F1] += hi ? gl : T(0);
      acc[A_F2] += hi ? g : T(0);
      acc[A_F3] += g;
      acc[A_MMAX] += g * dr;
      d_m = ((-(hi ? a2 : a1) / m + tp.dx) - dr) - T(WALL) * dmax(m - T(TOP_BROKENPL), T(0));
    }
  }
  if (GRAD) {
    acc[A_MMIN] -= g * tp.dx;
    acc[A_DM] += g * tp.ddm;
  }
  return out;
}

// log N_q(m) from the chain's q-norm table (n_m entries on 2 + k dmq), as interp_unit_spaced reads it
template <typename T> struct Nq {
  Bracket<T> br;
  T n0, n1, val;
};
template <typename T> FAM_HD Nq<T> read_nq(const T* nq, int n_m, T dmq, T m) {
  Nq<T> r;
  r.br = bracket((m - T(M_TAB_LO)) / dmq, n_m);
  r.n0 = nq[r.br.lo];
  r.n1 = nq[r.br.lo + 1];
  r.val = r.n0 + r.br.t * (r.n1 - r.n0);
  return r;
}

// The pivot's density: everything of a row's but the frame, at (MREF, QREF, ZREF), with log_norm 0.
template <typename T, int FAM, bool GRAD>
FAM_HD T pivot_density(const Chain<T>& k, const T* nq, int n_m, T dmq, T g, T* acc, int& nq_lo, T& nq_a, T& nq_b,
                       SplAdd<T>& sa) {
  const T m = T(MREF), q = T(QREF);
  T d_m = T(0);
  sa.lo = -1;
  const T lp = log_pm<T, FAM, GRAD>(k, m, g, acc, d_m, sa);
  const Taper<T> t2 = taper<T, GRAD>(q * m - k.s[MMIN], k.dm);
  const Nq<T> n = read_nq(nq, n_m, dmq, m);
  if (GRAD) {
    acc[A_BQ] += g * Fn<T>::log(q);
    acc[A_MMIN] -= g * t2.dx;
    acc[A_DM] += g * t2.ddm;
    nq_lo = n.br.lo;
    nq_a = -(g - n.br.t * g);
    nq_b = -(n.br.t * g);
  }
  return ((((lp + k.s[BQ] * Fn<T>::log(q)) + t2.val) - n.val) + (k.shape0 - k.shape0)) + T(0);
}

// Fills in a chain's constants from its sites s (NS of them), its q-norm table and (PSPLINE) its
// spline's coefficient table spl, the pivot last.
template <typename T, int FAM>
FAM_HD void chain_init(Chain<T>& k, const T* s, const T* nq, int n_m, T dmq, const T* spl) {
  for (int i = 0; i < NS; ++i) k.s[i] = s[i];
  if (FAM == PSPLINE)
    for (int i = 0; i < SPL_COEFS; ++i) k.spl[i] = spl[i];
  k.dm = Fn<T>::max(s[DELTA], T(1e-6));
  if (FAM == PLPEAK) {
    k.l1m = Fn<T>::log1p(-s[P1]);
    k.llam = Fn<T>::log(s[P1]);
    k.lpn = log_pl_norm_inv(s[P0], s[MMIN], s[MMAX]).val;
    k.lsig = Fn<T>::log(s[P3]);
    k.mbreak = k.kterm = k.ln = T(0);
  } else if (FAM == PSPLINE) {
    k.l1m = k.llam = k.lpn = k.lsig = T(0);
    k.mbreak = k.kterm = k.ln = T(0);
  } else {
    const T a1 = s[P0], a2 = s[P1];
    k.mbreak = s[MMIN] + s[P2] * (s[MMAX] - s[MMIN]);
    const T lmb = Fn<T>::log(k.mbreak);
    k.kterm = (a2 - a1) * lmb;
    const T i1 = log_pl_norm_inv(a1, s[MMIN], k.mbreak).val;
    const T i2 = (a2 - a1) * lmb + log_pl_norm_inv(a2, k.mbreak, s[MMAX]).val;
    k.ln = logaddexp(i1, i2);
    k.l1m = k.llam = k.lpn = k.lsig = T(0);
  }
  k.opzp = T(1) + s[ZP];
  k.lr0 = Fn<T>::log(T(1) / k.opzp);
  const T y0 = s[KAPPA] * k.lr0;
  k.sp0 = softplus(y0);
  k.dsp0 = dsoftplus(y0);
  k.shape0 = s[LAMZ] * Fn<T>::log1p(T(0)) - k.sp0;
  T unused[NACC];
  int lo;
  T a, b;
  SplAdd<T> sa;
  k.log_norm = -(pivot_density<T, FAM, false>(k, nq, n_m, dmq, T(0), unused, lo, a, b, sa) + T(LOG_MREF));
}

// What a row's backward adds to the tables' cotangents: the detector's entries lo and lo + 1 (z and
// log_jac), the q-norm table's, and (PSPLINE) the spline's four coefficients; nothing where lo < 0.
template <typename T> struct RowAdd {
  int det_lo;
  T dz0, dz1, dj0, dj1;
  int nq_lo;
  T n0, n1;
  SplAdd<T> spl;
};

// One row: its detector read, mass, rate and frame.  eval() is the forward; grad() the chain rule
// of the same row with cotangent g.
template <typename T, int FAM> struct Row {
  Bracket<T> bz;
  T z0, z1, z, m1, q, l1pz;
  T out;

  FAM_HD void eval(const Chain<T>& k, T a, T qv, T log_dl, T log_pdraw, const T* det, int K, T v0, T dv,
                   const T* nq, int n_m, T dmq) {
    q = qv;
    bz = bracket((log_dl - v0) / dv, K);
    z0 = det[2 * bz.lo];
    z1 = det[2 * bz.lo + 2];
    const T j0 = det[2 * bz.lo + 1], j1 = det[2 * bz.lo + 3];
    z = z0 + bz.t * (z1 - z0);
    const T lj = j0 + bz.t * (j1 - j0);
    m1 = a / (T(1) + z);
    l1pz = Fn<T>::log1p(z);
    T unused[NACC], d_m;
    SplAdd<T> sa;
    const T lp = log_pm<T, FAM, false>(k, m1, T(0), unused, d_m, sa);
    const T t2 = taper<T, false>(q * m1 - k.s[MMIN], k.dm).val;
    const T lnq = read_nq(nq, n_m, dmq, m1).val;
    const T y = k.s[KAPPA] * Fn<T>::log((T(1) + z) / k.opzp);
    const T dndv = (k.s[LAMZ] * l1pz - softplus(y)) - k.shape0;
    const T dens = ((((lp + k.s[BQ] * Fn<T>::log(q)) + t2) - lnq) + dndv) + k.log_norm;
    out = ((dens - T(2) * l1pz) + lj) - log_pdraw;
  }

  FAM_HD void grad(const Chain<T>& k, T g, const T* nq, int n_m, T dmq, T* acc, RowAdd<T>& add) const {
    T d_m1 = T(0);
    add.spl.lo = -1;
    log_pm<T, FAM, true>(k, m1, g, acc, d_m1, add.spl);
    const Taper<T> t2 = taper<T, true>(q * m1 - k.s[MMIN], k.dm);
    const Nq<T> n = read_nq(nq, n_m, dmq, m1);
    acc[A_BQ] += g * Fn<T>::log(q);
    acc[A_MMIN] -= g * t2.dx;
    acc[A_DM] += g * t2.ddm;
    acc[A_SUMG] += g;
    d_m1 = d_m1 + q * t2.dx;
    if (n.br.slope) d_m1 = d_m1 - (n.n1 - n.n0) / dmq;
    add.nq_lo = n.br.lo;
    add.n0 = -(g - n.br.t * g);
    add.n1 = -(n.br.t * g);
    // the rate: shape(z) - shape(0)
    const T opz = T(1) + z;
    const T u = opz / k.opzp;
    const T lr = Fn<T>::log(u);
    const T kappa = k.s[KAPPA];
    const T dsp = dsoftplus(kappa * lr);
    acc[A_LAMZ] += g * l1pz;
    acc[A_KAPPA] += g * (-(dsp * lr) + k.dsp0 * k.lr0);
    acc[A_ZP] += g * ((kappa * (dsp - k.dsp0)) / k.opzp);
    // z: through m1 = a / (1 + z), the rate (d log u / d z = 1 / (1 + z)) and the frame's -2 log1p z
    const T dz = d_m1 * -(m1 / opz) + ((k.s[LAMZ] - dsp * kappa) - T(2)) / opz;
    const T gz = g * dz;
    add.det_lo = bz.lo;
    add.dz0 = gz - bz.t * gz;
    add.dz1 = bz.t * gz;
    add.dj0 = g - bz.t * g;
    add.dj1 = bz.t * g;
  }
};

// The pivot's backward: its cotangent is minus the data rows' sum (log_norm enters each row once);
// adds into acc and returns the q-norm table's two entries in (nq_lo, nq_a, nq_b) and (PSPLINE) the
// spline's in sa.
template <typename T, int FAM>
FAM_HD void pivot_grad(const Chain<T>& k, const T* nq, int n_m, T dmq, T* acc, int& nq_lo, T& nq_a, T& nq_b,
                       SplAdd<T>& sa) {
  pivot_density<T, FAM, true>(k, nq, n_m, dmq, -acc[A_SUMG], acc, nq_lo, nq_a, nq_b, sa);
}

// The sites' cotangents d (NS) from the chain's accumulated sums, the pivot's included.
template <typename T, int FAM> FAM_HD void finalize(const Chain<T>& k, const T* acc, T* d) {
  const T* s = k.s;
  for (int i = 0; i < NS; ++i) d[i] = T(0);
  d[BQ] = acc[A_BQ];
  d[LAMZ] = acc[A_LAMZ];
  d[KAPPA] = acc[A_KAPPA];
  d[ZP] = acc[A_ZP];
  d[DELTA] = acc[A_DM] * dmax(s[DELTA], T(1e-6));
  if (FAM == PLPEAK) {
    const Lpn<T> n = log_pl_norm_inv(s[P0], s[MMIN], s[MMAX]);
    const T pl = acc[A_F0], sigma = s[P3];
    d[P0] = -acc[A_F1] - pl * n.d_alpha;
    d[MMIN] = acc[A_MMIN] - pl * n.d_lo;
    d[MMAX] = acc[A_MMAX] - pl * n.d_hi;
    d[P1] = -(pl / (T(1) - s[P1])) + acc[A_F2] / s[P1];
    d[P2] = acc[A_F3];
    d[P3] = (acc[A_F4] - acc[A_F2]) / sigma;
  } else if (FAM == PSPLINE) {
    d[P0] = -acc[A_F1];
    d[MMIN] = acc[A_MMIN];
    d[MMAX] = acc[A_MMAX];
  } else {
    const T a1 = s[P0], a2 = s[P1], bfrac = s[P2], mb = k.mbreak;
    const T lmb = Fn<T>::log(mb);
    const Lpn<T> n1 = log_pl_norm_inv(a1, s[MMIN], mb);
    const Lpn<T> n2 = log_pl_norm_inv(a2, mb, s[MMAX]);
    const T i1 = n1.val, i2 = (a2 - a1) * lmb + n2.val;
    const T g_ln = -acc[A_F3];  // every row, the pivot's included, subtracts the norm
    const T g1 = g_ln * dlogaddexp(i1, i2), g2 = g_ln * dlogaddexp(i2, i1);
    const T gk = acc[A_F2] + g2;  // (alpha2 - alpha1) log mbreak: the upper branch's and i2's
    const T d_mb = gk * ((a2 - a1) / mb) + g1 * n1.d_hi + g2 * n2.d_lo;
    d[P0] = (-acc[A_F0] - gk * lmb) + g1 * n1.d_alpha;
    d[P1] = (-acc[A_F1] + gk * lmb) + g2 * n2.d_alpha;
    d[P2] = d_mb * (s[MMAX] - s[MMIN]);
    d[MMIN] = (acc[A_MMIN] + g1 * n1.d_lo) + d_mb * (T(1) - bfrac);
    d[MMAX] = (acc[A_MMAX] + g2 * n2.d_hi) + d_mb * bfrac;
  }
}

}  // namespace fam
