"""The yardstick: the card's peaks and the work one batched value+grad of
each mass family's joint potential needs, counted from shapes.

The bump: a frozen copy of ``chip_smoke.py`` (lines 261-302 and 391-401 at
commit fb8d8bd): the H100 SXM peaks of NVIDIA's data sheet and the FP32
operations per unit of work, tallied there from ``csrc/bump.cu`` and
``csrc/logwts.cu`` (each exp/log/log1p one operation).  The counts are of
the work these inputs need, whatever implements it: kernel A fills and
log-trapezoids a ``(G, G)`` grid per chain, kernel B weighs every
chain-query against the per-chain tables and reduces each event's and the
selection's rows by log-sum-exp.

POWER-LAW+PEAK and BROKEN POWER LAW: tallied by the same convention from
``bumpcosmology_torch/models/plpeak.py`` and ``models/brokenpl.py`` as they
stand at commit bc9de79, on the fused route of ``inference/likelihoods.py``
(below, :data:`FAMILY_QUERY_OPS`).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9  # the H100 SXM's boost clock, used where nvidia-smi cannot be read

OPS_A_FWD_PER_CELL = 9
OPS_A_BWD_PER_CELL = 16
SFU_A_PER_CELL = 1
OPS_B_FWD_PER_QUERY = 97
OPS_B_BWD_PER_QUERY = 185
OPS_B_LSE_FWD_EXTRA = 4
OPS_B_LSE_BWD_EXTRA = 3


# The other families' joint potential: plain PyTorch through autograd, no
# kernel.  (term, forward, backward) FP32 operations a chain-query.  The
# backward takes every forward value as saved and recomputes none; it
# counts the cotangents that the sites and the tables need, with one add a
# query for each per-chain site that a term's cotangent reaches (the sum
# over the queries).  The Planck taper at one mass (plpeak.py:115-123) is
# 22 forward: x (1), its clamp (2), f (4), f's clamp (2), -softplus(f)
# (7), the foot (4), the where (2); and 24 backward: the where (1), the
# foot into x and into x_lo (3), the softplus (3), f's clamp (1), df/dx_in
# (5), df/d(delta_m) summed (6), x's clamp into x and its bounds (3), x
# into the mass and into mmin (2).  A logaddexp is 6 forward (max, min,
# subtract, exp, log1p, add) and 5 backward (its two weights and
# products).  As for the bump, the per-chain scalars (a site's log, the
# power law's norm) and the cosmology and detector tables, which every
# family builds alike, are not counted.
SHARED_QUERY_OPS = (
    # likelihoods.py:372, interp.py:104-129: the detector table's (z, log_jac) at log dL, one bracket
    # (8) and two lerps (6); backward, each lerp into its two table rows (1 - t, two products, two
    # adds: 5 a column)
    ("detector", 14, 10),
    # likelihoods.py:374: m1 = m1_det / (1 + z); backward, -m1 / (1 + z) into z
    ("m1", 2, 3),
    # likelihoods.py:375-376: -2 log1p(z) + log_jac - log pdraw (log1p shared with the rate);
    # backward, -2 / (1 + z) into z
    ("frame", 5, 3),
    # likelihoods.py:431: the segment log-sum-exps, as kernel B's lse epilogue (+4, +3)
    ("lse", 4, 3),
    # redshift.py:21-32: lam log1p(z) - softplus(kappa log((1 + z)/(1 + zp))) less its value at zref
    # (a per-chain value): 12; backward, into z (7), lam (2), kappa (3) and zp (2)
    ("rate", 12, 14),
    # plpeak.py:164-171: the sum of the intensity's six terms; backward, log_norm summed
    ("sum", 5, 1),
    # plpeak.py:166: beta_q log q; backward, into beta_q summed
    ("pairing", 2, 2),
    # plpeak.py:167: the taper at q m1 (1 + 22); backward, the taper's 24 and q into m1
    ("taper_q_m1", 23, 25),
    # plpeak.py:163, interp.py:115-120: N_q(m1) from the (C, n_m) table, a bracket (8) and a lerp (3);
    # backward, into the table's two rows (5) and through t into m1 (4)
    ("nq", 11, 9),
)
FAMILY_QUERY_OPS = {
    # plpeak.py:138-156: the power law (3; backward 6), the wall at mmax (4; 4), the peak (5; 7),
    # their logaddexp (6; 5), the taper at m1 and its add (23; 24), the wall at M_TAB_HI - 10 (4; 3)
    "plpeak": SHARED_QUERY_OPS + (("mass", 45, 49),),
    # brokenpl.py:79-100: log m1, the two branches and the where (6; backward, the taken branch into
    # m1 and its slope, and the per-chain constants: 6), - log_norm (1), the taper at m1 and its add
    # (23; 24), the walls at mmax and M_TAB_HI (8; 7), the where's select (0; 1)
    "brokenpl": SHARED_QUERY_OPS + (("mass", 38, 38),),
}
# plpeak.py:212-216: the pivot evaluates the intensity once a chain at (MREF, QREF, ZREF)
PIVOT_TERMS = ("rate", "sum", "pairing", "taper_q_m1", "nq", "mass")
# plpeak.py:56: the q-normalisation table's mass ratios (its masses are the configuration's n_grid)
N_Q = 128
# plpeak.py:206-209, a cell of the (n_m, n_q) integrand: (beta_q + 1) u (1), exp(u) m1 (1), the
# taper (22), their add (1) and the floor (1); backward, the floor (1), into beta_q summed (2) and
# the taper (24 less the mass's add: 23)
OPS_NQ_FWD_PER_CELL = 26
OPS_NQ_BWD_PER_CELL = 26
# integrate.py:37-42, a segment of log_trapz: logaddexp (6), log(dx/2) (1), the log-sum-exp (4);
# backward, the log-sum-exp (3), the logaddexp (5), the two cotangents' add into the cells (1)
OPS_NQ_FWD_PER_SEGMENT = 11
OPS_NQ_BWD_PER_SEGMENT = 9


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time in seconds: the larger of bytes over the HBM rate and
    FP32 operations over the FP32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def leapfrog_ops(chains: int, n_grid: int, queries: int, family: str = "bump") -> float:
    """FP32 operations of one batched value+grad of ``chains`` chains of
    ``family``'s joint potential.  The bump: kernel A forward and backward
    over ``n_grid``² cells a chain, kernel B's ``lse`` forward and backward
    over ``queries`` rows a chain.  Another family: its ``queries`` rows a
    chain (:data:`FAMILY_QUERY_OPS`), its q-normalisation table of
    ``n_grid`` masses by :data:`N_Q` mass ratios and its pivot a chain."""
    if family == "bump":
        a = n_grid * n_grid * (OPS_A_FWD_PER_CELL + OPS_A_BWD_PER_CELL)
        b = queries * (OPS_B_FWD_PER_QUERY + OPS_B_LSE_FWD_EXTRA + OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA)
        return float(chains) * (a + b)
    per_query = sum(f + b for _, f, b in FAMILY_QUERY_OPS[family])
    pivot = sum(f + b for term, f, b in FAMILY_QUERY_OPS[family] if term in PIVOT_TERMS)
    grid = n_grid * N_Q * (OPS_NQ_FWD_PER_CELL + OPS_NQ_BWD_PER_CELL) + n_grid * (N_Q - 1) * (
        OPS_NQ_FWD_PER_SEGMENT + OPS_NQ_BWD_PER_SEGMENT)
    return float(chains) * (queries * per_query + grid + pivot)


def a_bump_bound_s(chains: int, n_grid: int, clock_hz: float = H100_MAX_SM_CLOCK_HZ) -> float:
    """Kernel A's forward plus backward bound for ``chains`` chains: each the
    largest of bytes, FP32 operations and one special-function result per
    cell at 16 a clock per SM (``bound_a`` of ``chip_smoke.py``)."""
    cells = chains * n_grid * n_grid
    sfu = cells * SFU_A_PER_CELL / (SFU_PER_CLOCK_PER_SM * H100_SMS * clock_hz)
    fwd = max(bound_s(chains * 5 * 4 + chains * n_grid * 4, cells * OPS_A_FWD_PER_CELL), sfu)
    bwd = max(bound_s(chains * 5 * 4 * 2 + 2 * chains * n_grid * 4, cells * OPS_A_BWD_PER_CELL), sfu)
    return fwd + bwd


def b_lse_bwd_bound_s(chains: int, queries: int, n_z: int, n_grid: int, nobs: int, per_chain: bool) -> float:
    """Kernel B's ``lse`` backward bound for ``chains`` chains: the query
    rows (16 bytes each, once, or once a chain for per-chain tables), the
    tables and their cotangents, the segment log-sum-exps and their
    cotangents; 185 + 3 operations a chain-query."""
    table_bytes = chains * (n_z * 8 + n_grid * 4 + 15 * 4)
    seg_bytes = chains * (nobs + 1) * 4
    query_bytes = (chains if per_chain else 1) * queries * 16
    return bound_s(query_bytes + 2 * table_bytes + 2 * seg_bytes,
                   chains * queries * (OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA))
