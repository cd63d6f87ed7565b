"""The work of kernel F's POWER LAW + SPLINE backward (``families_bwd_kernel``
with the family code 2; its arithmetic ``bumpcosmology_torch/csrc/
families_math.cuh``), counted from the cell's shapes, for the per-layer
metric ``f_pspline_bwd_roofline``.

The convention is ``counts.py``'s: each add, multiply, divide, compare,
select, min or max is one FP32 operation, and so is each exp, log or log1p.
The backward recomputes a row's forward (``Row::eval``) before its chain
rule (``Row::grad``), so a row counts both.  The fixed-point table
cotangents (``csrc/rows.cuh::fx_add``: a float64 multiply, round, floor and
subtract, two 64-bit integer atomics) are not FP32 work and are left out,
as are a chain's constants, its pivot and its finalisation (a few hundred
operations a chain against tens of thousands of rows).  Leaving work out
can only lower the bound, so the share stays below 100 %.

Each term is tallied beside its lines of ``families_math.cuh`` as the file
stands with POWER LAW + SPLINE in it.
"""
from __future__ import annotations

from cardbench.counts import bound_s

# bracket(), lines 146-156: floor, the NaN test and select, max, min, the fraction, max, min, two compares
BRACKET = 10
# taper() forward, lines 163-172: two products (163), max, min (164-165), f (4, 166), its clamp (2, 167),
# -logaddexp(f, 0) (max, subtract, abs, negate, exp, log1p, add, negate: 8, 168), the foot (2, 169),
# the top's compare (170) and the value (3, 172)
TAPER_FWD = 24
# taper() backward, lines 175-185: dmid/df (8), xm (1), dmid/dxin (7), dxin/dinner (3), dr (5),
# d_inner (1), d_xlo (6), d_xhi (2), dx (5), ddm (11)
TAPER_BWD = 49
# spline() forward, lines 235-243: the position (2) and its bracket, Horner's rule (6), the two compares
SPLINE_FWD = 2 + BRACKET + 6 + 2
# spline() backward, lines 245-251: df/dm (6) and g t, g t^2, g t^3 (3)
SPLINE_BWD = 9
# log_pm() of POWER LAW + SPLINE forward, lines 260-263 and 283-288: log m, the wall's relu (2), the taper
# at m - mmin (1 + 24), the spline, the top wall's relu (2) and the sum (8)
LOG_PM_FWD = 1 + 2 + 1 + TAPER_FWD + SPLINE_FWD + 2 + 8
# log_pm() backward, lines 263, 286 and 289-293, 312-314: the taper's and the spline's chain rules, dr (5),
# two accumulators (4), d_m (11), the taper's two accumulators (4)
LOG_PM_BWD = TAPER_BWD + SPLINE_BWD + 5 + 4 + 11 + 4
# read_nq(), lines 326-329: the position (2) and its bracket, the lerp (3)
READ_NQ = 2 + BRACKET + 3

ROW_FWD = (
    ("detector position and bracket", "414", 2 + BRACKET),
    ("z and log_jac lerps", "418-419", 6),
    ("m1 = a / (1 + z)", "420", 2),
    ("log1p z", "421", 1),
    ("log p(m1)", "424", LOG_PM_FWD),
    ("the taper at q m1", "425", 2 + TAPER_FWD),
    ("N_q(m1)", "426", READ_NQ),
    ("the rate's softplus argument", "427", 4),
    ("the rate", "428", 9),
    ("the density's sum", "429", 7),
    ("the frame", "430", 4),
)
ROW_BWD = (
    ("log p(m1) again, with its chain rule", "436", LOG_PM_FWD + LOG_PM_BWD),
    ("the taper at q m1 again, with its chain rule", "437", 2 + TAPER_FWD + TAPER_BWD),
    ("N_q(m1) again", "438", READ_NQ),
    ("four accumulators", "439-442", 8),
    ("dm1 from the taper and N_q", "443-444", 5),
    ("the q-norm table's two cotangents", "446-447", 5),
    ("the rate's slope", "449-453", 14),
    ("three rate accumulators", "454-456", 13),
    ("dz and g dz", "458-459", 9),
    ("the detector table's four cotangents", "461-464", 6),
)
# families.cu, the backward's loop: the row's cotangent g_seg exp(out - lse_seg) and its tests
ROW_COTANGENT = 4


def row_bwd_ops() -> int:
    """FP32 operations of one row in the backward: the forward recomputed,
    the row's cotangent and its chain rule."""
    return sum(n for _, _, n in ROW_FWD) + ROW_COTANGENT + sum(n for _, _, n in ROW_BWD)


def f_pspline_bwd_bound_s(chains: int, queries: int, n_z: int, n_grid: int, nobs: int, per_chain: bool) -> float:
    """The least time of one backward launch for ``chains`` chains of
    ``queries`` rows: the query rows (16 bytes each, once, or once a chain
    for per-chain tables), each chain's tables read and their cotangents
    written (the detector's ``2 n_z``, the q-norm table's ``n_grid``, the
    spline's 76, the 11 sites), its segment log-sum-exps and their
    cotangents read, in float32; the rows' FP32 operations."""
    table_words = 2 * n_z + n_grid + 76 + 11
    n_bytes = (chains if per_chain else 1) * queries * 16 + chains * 4 * (2 * table_words + 2 * (nobs + 1))
    return bound_s(n_bytes, chains * queries * row_bwd_ops())
