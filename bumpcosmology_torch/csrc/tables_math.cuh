// Kernel T's arithmetic: one chain's flat-wCDM cosmology table and the log(dL)-keyed detector table
// read from it, and the hand-derived chain rule of both.  Included by csrc/tables.cu; written as
// __host__ __device__ functions of the scalar type T (float or double), so that the same code can be
// compiled for the host and held against PyTorch's autograd of the eager twin
// (models/cosmology.py::build_cosmology, build_detector_table).
//
// Per chain (h, Om, w), on n knots u_i = linspace(0, log1p zmax, n)_i and K nodes v_k = linspace(v0, v1, K)_k:
//   z_i = expm1 u_i,  opz_i = z_i + 1
//   inv_e_i = 1 / sqrt(((Om opz) opz) opz + (1 - Om) pow(opz, (w + 1) 3))       models/cosmology.py::efunc
//   dh = (1 / h) H,  seg_j = ((z_{j+1} - z_j) 0.5) (inv_e_j + inv_e_{j+1}),  I_i = sum_{j < i} seg_j
//   dc_i = dh I_i,  dl_i = dc_i opz_i,  ddl_i = dc_i + (dh opz_i) inv_e_i,  dvc_i = (((dc_i 4pi) dc_i) dh) inv_e_i
//   x_k = exp v_k;  z_k = interp(x_k, dl, z): lo = clamp(searchsorted(dl, x_k, right), 1, n - 1) - 1,
//         t = clamp(denom > 0 ? (x_k - dl_lo) / denom : 0, 0, 1),  z_k = z_lo + t (z_hi - z_lo)
//   (dvc_k, ddl_k) at log1p z_k on the knots' uniform grid (ops/interp.py::unit_bracket: lo2 = clamp(floor(pos)
//         with NaN as 0, 0, n - 2), t2 = clamp(pos - lo2, 0, 1), pos = log1p(z_k) (1 / du))
//   out_k = [z_k, clamp_min(log dvc_k - log ddl_k, -1e4)]
// Every operation is the eager twin's on the card, in its order and with its constants rounded once to
// T: a Python scalar divisor is a product by its reciprocal (PyTorch's CUDA division by a scalar), 1 / x
// is a reciprocal, clamp propagates NaN.  csrc/tables.cu is built with -fmad=false, so nothing is
// contracted into a fused multiply-add.  Only the prefix sum's order differs from torch.cumsum's.
//
// The backward takes the cotangents (gz_k, gl_k) of a node's two columns and returns those of the six
// knot entries it read (dl at lo and lo + 1; dvc and ddl at lo2 and lo2 + 1); a knot then takes the
// cotangents of its dl, dvc and ddl to those of dc, inv_e and dh, and (after the suffix sum of the
// prefix sum's cotangents) of inv_e to Om, 1 - Om and the exponent.  Where the eager code picks a
// subgradient, the same one is picked: clamp passes its bounds, clamp_min passes at its bound, where
// sends nothing to the branch it did not take, and a bracket index carries no gradient.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define TAB_HD __host__ __device__ __forceinline__
#else
#define TAB_HD inline
#endif

namespace tab {

constexpr double HUBBLE = 2.99792458;          // models/cosmology.py::HUBBLE_DISTANCE_H, c / (100 km/s/Mpc) in Gpc
constexpr double FOUR_PI = 12.566370614359172;  // 4.0 * math.pi, as Python rounds it
constexpr double LOG_JAC_FLOOR = -1e4;          // build_detector_table's clamp_min

template <typename T> struct Fn;
template <> struct Fn<float> {
  static TAB_HD float exp(float x) { return expf(x); }
  static TAB_HD float log(float x) { return logf(x); }
  static TAB_HD float log1p(float x) { return log1pf(x); }
  static TAB_HD float expm1(float x) { return expm1f(x); }
  static TAB_HD float pow(float a, float b) { return powf(a, b); }
  static TAB_HD float sqrt(float x) { return sqrtf(x); }
  static TAB_HD float floor(float x) { return floorf(x); }
};
template <> struct Fn<double> {
  static TAB_HD double exp(double x) { return ::exp(x); }
  static TAB_HD double log(double x) { return ::log(x); }
  static TAB_HD double log1p(double x) { return ::log1p(x); }
  static TAB_HD double expm1(double x) { return ::expm1(x); }
  static TAB_HD double pow(double a, double b) { return ::pow(a, b); }
  static TAB_HD double sqrt(double x) { return ::sqrt(x); }
  static TAB_HD double floor(double x) { return ::floor(x); }
};

// torch.clamp(x, lo, hi): NaN stays NaN; its backward passes lo <= x <= hi, bounds included
template <typename T> TAB_HD T clamp(T x, T lo, T hi) { return x != x ? x : (x < lo ? lo : (x > hi ? hi : x)); }
template <typename T> TAB_HD bool passes(T x, T lo, T hi) { return x >= lo && x <= hi; }

// torch.linspace(start, end, n)[i] as PyTorch's CUDA kernel computes it, step = (end - start) / (n - 1) in T
template <typename T> TAB_HD T linspace_at(T start, T end, T step, int n, int i) {
  return i < n / 2 ? start + step * (T)i : end - step * (T)(n - 1 - i);
}

// torch.searchsorted(a, v, right=True) over a[0, n): the first index whose entry is above v; a NaN entry
// counts as not above (PyTorch's upper bound), so the result is monotone in v for any a
template <typename T> TAB_HD int upper_bound(const T* a, int n, T v) {
  int s = 0, e = n;
  while (s < e) {
    const int m = s + ((e - s) >> 1);
    if (!(a[m] > v)) s = m + 1;
    else e = m;
  }
  return s;
}

// A chain's constants: Om, 1 - Om, the exponent (w + 1) 3, 1 / h and the Hubble distance (1 / h) H
template <typename T> struct Chain {
  T om, omm, e, rh, dh;
};
template <typename T> TAB_HD Chain<T> chain_init(T h, T om, T w) {
  Chain<T> k;
  k.om = om;
  k.omm = T(1) - om;
  k.e = (w + T(1)) * T(3);
  k.rh = T(1) / h;
  k.dh = k.rh * T(HUBBLE);
  return k;
}

// A knot at u: z, 1 + z, pow(1 + z, e), E and 1 / E
template <typename T> struct Knot {
  T z, opz, p, e, ie;
};
template <typename T> TAB_HD Knot<T> knot(const Chain<T>& k, T u) {
  Knot<T> q;
  q.z = Fn<T>::expm1(u);
  q.opz = q.z + T(1);
  const T a = ((k.om * q.opz) * q.opz) * q.opz;
  q.p = Fn<T>::pow(q.opz, k.e);
  q.e = Fn<T>::sqrt(a + k.omm * q.p);
  q.ie = T(1) / q.e;
  return q;
}

// cumtrapz's segment between two knots
template <typename T> TAB_HD T segment(const Knot<T>& a, const Knot<T>& b) {
  return ((b.z - a.z) * T(0.5)) * (a.ie + b.ie);
}

// A knot's table entries from its prefix sum I
template <typename T> struct Entries {
  T dl, ddl, dvc;
};
template <typename T> TAB_HD Entries<T> entries(const Chain<T>& k, const Knot<T>& q, T integral) {
  const T dc = k.dh * integral;
  Entries<T> r;
  r.dl = dc * q.opz;
  r.ddl = dc + (k.dh * q.opz) * q.ie;
  r.dvc = (((dc * T(FOUR_PI)) * dc) * k.dh) * q.ie;
  return r;
}

// A detector node at x = exp v: the bracket of x among the knots' dl and z (z_at_dl), then dvc and ddl at
// log1p z (dvc_and_ddl_at_z) and the log-Jacobian.  zlo, zhi are the knot redshifts at lo and lo + 1.
template <typename T> struct Node {
  int lo, lo2;
  bool p;
  T num, den, traw, t, dz, zk;   // interp: x - dl_lo, denom (or 1), t before and after its clamp, z_hi - z_lo, z
  T tr2, t2, dv, dd, dvck, ddlk;  // the lookup: t2 before and after its clamp, the bracket's differences, values
  T ljr, lj;                     // log dvc - log ddl, and after clamp_min
};

// the bracket of x in dl[0, n): lo in [0, n - 2]
template <typename T> TAB_HD int dl_bracket(const T* dl, int n, T x) {
  int j = upper_bound(dl, n, x);
  j = j < 1 ? 1 : (j > n - 1 ? n - 1 : j);
  return j - 1;
}

// z at x on the bracket lo of dl, then the lookup bracket lo2 of log1p z on the knots' uniform grid
template <typename T> TAB_HD void node_z(Node<T>& r, T x, const T* dl, int lo, T zlo, T zhi, T inv_du, int n) {
  r.lo = lo;
  const T xlo = dl[lo], xhi = dl[lo + 1];
  const T denom = xhi - xlo;
  r.p = denom > T(0);
  r.num = x - xlo;
  r.den = r.p ? denom : T(1);
  r.traw = r.p ? r.num / r.den : T(0);
  r.t = clamp(r.traw, T(0), T(1));
  r.dz = zhi - zlo;
  r.zk = zlo + r.t * r.dz;
  const T pos = Fn<T>::log1p(r.zk) * inv_du;
  T lo2 = Fn<T>::floor(pos);
  lo2 = lo2 != lo2 ? T(0) : lo2;  // nan_to_num
  lo2 = clamp(lo2, T(0), T(n - 2));
  r.lo2 = (int)lo2;
  r.tr2 = pos - lo2;
  r.t2 = clamp(r.tr2, T(0), T(1));
}

// the lookup's values from dvc and ddl at lo2 and lo2 + 1, and the log-Jacobian
template <typename T> TAB_HD void node_jac(Node<T>& r, T v0, T v1, T d0, T d1) {
  r.dv = v1 - v0;
  r.dd = d1 - d0;
  r.dvck = v0 + r.t2 * r.dv;
  r.ddlk = d0 + r.t2 * r.dd;
  r.ljr = Fn<T>::log(r.dvck) - Fn<T>::log(r.ddlk);
  r.lj = clamp(r.ljr, T(LOG_JAC_FLOOR), T(INFINITY));
}

// A node's cotangents on the knots' entries, from (gz, gl) on its two columns
template <typename T> struct NodeGrad {
  T dl0, dl1;    // dl at lo, lo + 1
  T dvc0, dvc1;  // dvc at lo2, lo2 + 1
  T ddl0, ddl1;  // ddl at lo2, lo2 + 1
};
template <typename T> TAB_HD NodeGrad<T> node_grad(const Node<T>& r, T gz, T gl, T inv_du) {
  NodeGrad<T> d;
  // log_jac = clamp_min(log dvc - log ddl, -1e4)
  const T graw = r.ljr >= T(LOG_JAC_FLOOR) ? gl : T(0);
  const T gv = graw / r.dvck;
  const T gd = (-graw) / r.ddlk;
  // f = f_lo + t2 (f_hi - f_lo), both columns
  const T av = gv * r.t2, ad = gd * r.t2;
  d.dvc0 = gv + (-av);
  d.dvc1 = av;
  d.ddl0 = gd + (-ad);
  d.ddl1 = ad;
  const T gt2 = gv * r.dv + gd * r.dd;
  const T gpos = passes(r.tr2, T(0), T(1)) ? gt2 : T(0);
  const T gzl = (gpos * inv_du) / (r.zk + T(1));  // (x - 0) / du, then log1p
  // z = z_lo + t (z_hi - z_lo), t = clamp(where(p, num / den, 0), 0, 1)
  const T gt = (gz + gzl) * r.dz;
  const T ga = r.p && passes(r.traw, T(0), T(1)) ? gt : T(0);
  const T gnum = ga / r.den;
  const T gden = r.p ? (-ga) * ((r.num / r.den) / r.den) : T(0);
  d.dl0 = (-gnum) + (-gden);
  d.dl1 = gden;
  return d;
}

// A knot's cotangents from those of its dl, dvc and ddl: of the prefix sum I (times dh), of inv_e (its
// terms outside the prefix sum) and of dh
template <typename T> struct KnotGrad {
  T gi, gie, gdh;
};
template <typename T> TAB_HD KnotGrad<T> knot_grad(const Chain<T>& k, const Knot<T>& q, T integral, T gdl, T gdvc,
                                                   T gddl) {
  const T dc = k.dh * integral;
  const T a1 = dc * T(FOUR_PI), a2 = a1 * dc, a3 = a2 * k.dh, m = k.dh * q.opz;
  // dvc = a3 inv_e, a3 = a2 dh, a2 = a1 dc, a1 = dc 4pi
  const T ga3 = gdvc * q.ie;
  const T ga2 = ga3 * k.dh;
  const T ga1 = ga2 * dc;
  // ddl = dc + m inv_e, m = dh opz
  const T gm = gddl * q.ie;
  // dl = dc opz
  const T gdc = ((gdl * q.opz + gddl) + ga2 * a1) + ga1 * T(FOUR_PI);
  KnotGrad<T> r;
  r.gi = gdc * k.dh;
  r.gie = gdvc * a3 + gddl * m;
  r.gdh = (ga3 * a2 + gm * q.opz) + gdc * integral;
  return r;
}

// A segment's cotangent on each of its two inv_e, from the suffix sum gseg of the prefix sum's cotangents
template <typename T> TAB_HD T segment_grad(const Knot<T>& a, const Knot<T>& b, T gseg) {
  return gseg * ((b.z - a.z) * T(0.5));
}

// A knot's cotangents of Om (through its cube), of 1 - Om and of the exponent, from that of its inv_e
template <typename T> struct EGrad {
  T gom, gomm, ge;
};
template <typename T> TAB_HD EGrad<T> efunc_grad(const Chain<T>& k, const Knot<T>& q, T gie) {
  const T ge2 = ((-gie) * (q.ie * q.ie)) / (q.e * T(2));  // reciprocal, then sqrt
  EGrad<T> r;
  r.gom = ((ge2 * q.opz) * q.opz) * q.opz;
  r.gomm = ge2 * q.p;
  r.ge = (ge2 * k.omm) * (q.p * Fn<T>::log(q.opz));
  return r;
}

// The sites' cotangents (h, Om, w) from the chain's sums over the knots
template <typename T> TAB_HD void site_grad(const Chain<T>& k, T sdh, T som, T somm, T se, T* out) {
  out[0] = (-(sdh * T(HUBBLE))) * (k.rh * k.rh);
  out[1] = som + (-somm);
  out[2] = se * T(3);
}

}  // namespace tab
