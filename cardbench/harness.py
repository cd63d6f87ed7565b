"""The benchmark's core: find a cell's files by name, drive the port's public
entry in a closed loop, cut the measured window out of its batched
value+grads, read the per-layer metrics and judge the outputs against the
plain reference.

What belongs to one configuration, traffic mix or per-layer metric lives in
a file of its own under this directory, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model, the catalog, the adapted state and
  their sizes (the keys the harness reads are listed below);
* ``traffic/<mix>.json``: ``fit``'s settings, the value+grads that belong
  to its own warm-up, and the sizes of the checked samples and of the
  profiled stretch;
* ``metrics/<metric>.py``: ``read(run)`` returns the metric or ``None``;
* ``limits/<workload>.json``: the limit of each number that ``correct``
  compares.

A configuration's keys that the harness reads: ``family``, the port's mass
model, a key of ``likelihoods.MASS_FAMILIES`` (``bump`` where it is absent);
``reference``, the module under ``reference/`` that recomputes the family's
joint potential (its contract is in ``reference/__init__.py``);
``catalog`` and ``warmup_state``, files under this directory, each with its
``<key>_sha256``; ``events``, ``pe_samples`` and ``injections``, the cut of
the catalog; ``n_grid`` (the bump's mass grid, another family's q-norm
table's mass axis), ``n_z``, ``dl_margin``, ``chains`` and ``dense_mass``.
Its other keys (``source``, ``assumed``, ...) are for the reader.

The window.  The harness hands the entry the configuration's
:class:`ModelSpec` with its log-likelihood wrapped (:class:`Tap`): every
batched value+grad calls it once, so the wrapper counts and timestamps each
one (host clock) and sees its positions, its sites, its log-likelihood and,
on the way back, the log-likelihood's gradient by the sites.  The first
``calls_before_window`` calls are the entry's own warm-up (set-up); the
window opens, with the device synchronised, at the next one.  It closes at
the first value+grad made ``seconds`` after it opened, with the device
synchronised; the harness then stops the entry by raising
:class:`WindowClosed` from that call.  The files of the port are not edited
and none of its names is replaced.
"""
from __future__ import annotations

import contextlib
import hashlib
import importlib
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO_DIR = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "bumpcosmology_tpu")
NUMBERS = ("value_gap", "grad_gap", "leapfrog_gap")  # what ``correct`` compares, each with its limit
MOVE = 2.0 ** -16  # the relative move of the reference's inputs that shows a row to be ambiguous
AMBIGUOUS = 0.25  # ... where it moves the reference by more than this share of the limit


class WindowClosed(Exception):
    """Raised from the value+grad that closes the window, to stop the entry."""


# ------------------------------------------------------------------ files by name

def load_manifest(path: Optional[Path] = None) -> dict:
    with open(path or REPO_DIR / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(manifest: dict, workload: str):
    """(cell, its configuration's entry) of ``workload``; raises ``KeyError``."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def load_config(entry: dict, root: Path = REPO_DIR) -> dict:
    with open(root / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def limits_of(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "limits" / f"{workload}.json") as f:
        return json.load(f)


def data_path(config: dict, key: str, bench_dir: Path = BENCH_DIR) -> Path:
    """A data file of the configuration, after checking its sha256."""
    path = bench_dir / config[key]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != config[key + "_sha256"]:
        raise ValueError(f"{path}: sha256 {digest} is not the configuration's {config[key + '_sha256']}")
    return path


def forbidden_loaded(modules=None) -> List[str]:
    """The loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


# ------------------------------------------------------------------ statistics

def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) by linear interpolation between
    order statistics (``statistics.quantiles``' inclusive method)."""
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def quartile_spread(values) -> float:
    """(third quartile − first quartile) / median, the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


# ------------------------------------------------------------------ the window

class Window:
    """The measured window, cut from the entry's batched value+grads.

    ``enter(chains)`` is called at the start of every value+grad and returns
    its index in the window, or ``None`` for the first ``calls_before``
    calls (the entry's warm-up) and after the close; ``leave(index)`` once
    its gradient is back (after a synchronise when ``span_sync``).  In a
    traced run the profiler covers ``stretch_n`` value+grads from
    ``stretch_at`` of the window on; ``start_trace``/``stop_trace`` are
    called with the device synchronised, and the stretch (the profiler's
    start, its recording and its stop) does not count towards the window's
    ``seconds``.
    """

    def __init__(self, seconds: float, calls_before: int = 0, clock: Callable[[], float] = time.perf_counter,
                 sync: Callable[[], None] = lambda: None, span_sync: bool = False, stretch_at: float = 0.0,
                 stretch_n: int = 0, start_trace: Optional[Callable] = None, stop_trace: Optional[Callable] = None):
        self.seconds, self.calls_before, self.clock, self.sync = seconds, calls_before, clock, sync
        self.span_sync, self.stretch_at, self.stretch_n = span_sync, stretch_at, stretch_n
        self.start_trace, self.stop_trace = start_trace, stop_trace
        self.calls = 0
        self.open_t: Optional[float] = None
        self.close_t: Optional[float] = None
        self.entries: List[float] = []
        self.exits: Dict[int, float] = {}
        self.chains: List[int] = []
        self.stretch_first: Optional[int] = None
        self.stretch_stop: Optional[int] = None
        self.stretch_t: Optional[tuple] = None
        self.paused = 0.0  # the profiled stretch's wall time, which the window's length leaves out

    @property
    def in_stretch(self) -> bool:
        return self.stretch_first is not None and self.stretch_stop is None

    def enter(self, chains: int) -> Optional[int]:
        self.calls += 1
        if self.calls <= self.calls_before or self.close_t is not None:
            return None
        now = self.clock()
        if self.open_t is None:
            self.sync()
            now = self.open_t = self.clock()
        elif not self.in_stretch and now - self.open_t - self.paused >= self.seconds:
            self.sync()
            self.close_t = self.clock()
            raise WindowClosed()
        if self.stretch_n and self.stretch_first is None and now - self.open_t >= self.stretch_at * self.seconds:
            self.sync()
            t0 = self.clock()
            self.start_trace()
            self.stretch_first = len(self.entries)
            now = self.clock()
            self.stretch_t = (t0, None)
        elif self.in_stretch and len(self.entries) - self.stretch_first >= self.stretch_n:
            self.sync()
            self.stretch_stop = len(self.entries)
            self.stretch_t = (self.stretch_t[0], self.clock())
            self.stop_trace()
            now = self.clock()
            self.paused = now - self.stretch_t[0]
        self.entries.append(now)
        self.chains.append(chains)
        return len(self.entries) - 1

    def leave(self, index: int) -> None:
        if self.span_sync:
            self.sync()
        self.exits[index] = self.clock()

    # --- what the window measured
    @property
    def count(self) -> int:
        return len(self.entries)

    def intervals(self) -> List[float]:
        """Seconds from each value+grad's start to the next's (the last's to
        the close): they sum to the window's length."""
        ends = self.entries[1:] + [self.close_t]
        return [b - a for a, b in zip(self.entries, ends)]

    def outside_stretch(self) -> List[int]:
        """Indices of the intervals that neither the profiler's start and
        stop nor its recording touched."""
        n = self.count
        if self.stretch_first is None:
            return list(range(n))
        lo, hi = self.stretch_first - 1, self.stretch_stop if self.stretch_stop is not None else n
        return [i for i in range(n) if not lo <= i <= hi - 1]

    def leapfrog_ms(self) -> float:
        return 1e3 * (self.close_t - self.open_t) / self.count

    def leapfrog_ms_p95(self) -> float:
        return 1e3 * percentile(self.intervals(), 95.0)


class Record:
    """What the wrapper saw of one value+grad of the window: its index, the
    positions ``theta`` ``(C, dim)``, the sites, the log-likelihood and its
    gradient by the sites (references, no copies)."""

    __slots__ = ("index", "theta", "sites", "ll", "upstream", "grads")

    def __init__(self, index: int, theta, sites):
        self.index, self.theta, self.sites = index, theta, sites
        self.ll = self.upstream = self.grads = None


class Recorder:
    """Every value+grad's positions, and the whole :class:`Record` of a
    sample of them drawn from the seed (reservoir sampling) and of the
    last one."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng = size, random.Random(seed)
        self.kept: List[Record] = []
        self.last: Optional[Record] = None
        self.thetas: List = []

    def offer(self, rec: Record) -> None:
        seen = len(self.thetas)
        self.thetas.append(rec.theta)
        if seen < self.size:
            self.kept.append(rec)
        else:
            j = self.rng.randrange(seen + 1)
            if j < self.size:
                self.kept[j] = rec
        self.last = rec

    def items(self) -> List[Record]:
        out = {r.index: r for r in self.kept}
        if self.last is not None:
            out[self.last.index] = self.last
        return [out[k] for k in sorted(out)]


def _leaf(t):
    """The leaf tensor that ``t`` was computed from (the positions the
    value+grad differentiates by), detached."""
    if t.grad_fn is None:
        return t.detach()
    todo = [t.grad_fn]
    while todo:
        fn = todo.pop()
        var = getattr(fn, "variable", None)
        if var is not None:
            return var.detach()
        todo.extend(f for f, _ in fn.next_functions if f is not None)
    raise RuntimeError("the sites do not lead back to a leaf: the value+grad's positions cannot be read")


class Tap:
    """The harness's seam: :meth:`wrap` returns the log-likelihood that the
    spec handed to the entry carries.  Each call of it is one batched
    value+grad: the wrapper enters it in the :class:`Window`, offers its
    :class:`Record` to the :class:`Recorder`, and passes the sites through
    an identity whose backward records the gradient by the sites and
    leaves the span."""

    def __init__(self, window: Window, recorder: Recorder, trace=None):
        self.window, self.recorder, self.trace = window, recorder, trace

    def wrap(self, loglike: Callable) -> Callable:
        import torch

        tap = self

        class Through(torch.autograd.Function):
            @staticmethod
            def forward(ctx, rec, *xs):
                ctx.rec = rec
                ctx.set_materialize_grads(False)
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *grads):
                tap.back(ctx.rec, grads)
                return (None,) + grads

        class Out(torch.autograd.Function):  # the gradient that reaches the log-likelihood (-1 for U)
            @staticmethod
            def forward(ctx, rec, ll):
                ctx.rec = rec
                return ll.view_as(ll)

            @staticmethod
            def backward(ctx, grad):
                ctx.rec.upstream = grad.detach()
                return None, grad

        def tapped(sites):
            names = list(sites)
            index = self.window.enter(int(sites[names[0]].shape[0]))
            if index is None:
                return loglike(sites)
            rec = Record(index, _leaf(sites[names[0]]), {k: v.detach() for k, v in sites.items()})
            self.recorder.offer(rec)
            through = Through.apply(rec, *(sites[k] for k in names))
            with self._span("cardbench.loglike"):
                ll = loglike(dict(zip(names, through)))
            rec.ll = ll.detach()
            return Out.apply(rec, ll)

        return tapped

    def back(self, rec: Record, grads) -> None:
        """The gradient by the sites is back: keep d ll / d site (the
        gradient that reached each site over the one that reached ll)."""
        names = list(rec.sites)
        rec.grads = {k: (None if g is None else g.detach() / rec.upstream) for k, g in zip(names, grads)}
        with self._span("cardbench.grad_done"):
            self.window.leave(rec.index)

    def _span(self, name):
        if self.trace is None or not self.window.in_stretch:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


# ------------------------------------------------------------------ inputs

def read_catalog(path: Path) -> Dict[str, object]:
    """The catalog's numpy columns, as stored (events float32, injections float64)."""
    import numpy as np

    with np.load(path) as d:
        return {k: np.asarray(d[k]) for k in d.files}


def program_data(raw: dict, device):
    """The program's catalog from the raw columns, every one cast to
    float32 (``benchdata.load_pop_cosmo_data``'s reading of the same file)."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import EventData, PopCosmoData, SelectionData

    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in raw.items()}
    return PopCosmoData(events=EventData(t["ev_a"], t["ev_q"], t["ev_c"], t["ev_lp"]),
                        selection=SelectionData(t["sel_a"], t["sel_q"], t["sel_c"], t["sel_lp"], t["sel_ln"]))


def cut_catalog(raw: dict, nobs: int, nsamp: int, nsel: int) -> dict:
    """The first ``nobs`` events, ``nsamp`` samples each, and the first
    ``nsel`` injections, the number drawn scaled by the share kept."""
    import numpy as np

    n_inj = raw["sel_a"].shape[0]
    out = {k: v[:nobs, :nsamp] for k, v in raw.items() if k.startswith("ev_")}
    out.update({k: v[:nsel] for k, v in raw.items() if k.startswith("sel_") and k != "sel_ln"})
    out["sel_ln"] = np.asarray(float(raw["sel_ln"]) + math.log(nsel / n_inj))
    return out


class Cell:
    """One configuration under one traffic mix, set up once a process: the
    catalog on the device, the joint spec of its mass family and the adapted
    state (an unknown family raises before anything is read); :meth:`run`
    drives the entry once from a seed with the spec's log-likelihood
    wrapped."""

    def __init__(self, config: dict, traffic: dict, device, bench_dir: Path = BENCH_DIR):
        import numpy as np
        import torch

        from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES
        from bumpcosmology_torch.utils.checkpoint import load_warmup

        self.family = config.get("family", "bump")
        if self.family not in MASS_FAMILIES:
            raise ValueError(f"the configuration's family {self.family!r} is none of the port's mass families "
                             f"{sorted(MASS_FAMILIES)}")
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.reference = importlib.import_module(f"cardbench.reference.{config['reference']}")
        self.nobs, self.nsamp, self.nsel = config["events"], config["pe_samples"], config["injections"]
        self.queries = self.nobs * self.nsamp + self.nsel
        self.chains = config["chains"]
        self.raw = cut_catalog(read_catalog(data_path(config, "catalog", bench_dir)), self.nobs, self.nsamp,
                               self.nsel)
        warm_path = data_path(config, "warmup_state", bench_dir)
        with np.load(warm_path) as d:  # the adapted step sizes and mass matrices, for the reference's side
            self.eps = np.asarray(d["eps"][: self.chains], dtype=np.float64)
            self.cov = np.asarray(d["cov"][: self.chains], dtype=np.float64)
        self.spec = MASS_FAMILIES[self.family].cosmo_spec(program_data(self.raw, self.device),
                                                          n_grid=config["n_grid"], n_z=config["n_z"],
                                                          device=self.device)
        warm = load_warmup(warm_path, device=self.device)
        self.warm = _take_chains(warm, self.chains)
        self._ref_inputs = {}

    def free_program(self) -> None:
        """Drop the program's state (its spec and the adapted state on the
        device): the reference runs after it."""
        self.spec = self.warm = None

    def shapes(self) -> dict:
        return dict(family=self.family, n_grid=self.config["n_grid"], n_z=self.config["n_z"],
                    queries=self.queries, nobs=self.nobs, per_chain=False)

    def run(self, seed: int, tap: Tap) -> None:
        """Drive the entry from ``seed`` with the spec's log-likelihood
        wrapped by ``tap``; the :class:`Window` stops it."""
        from bumpcosmology_torch.inference.nuts import NutsConfig
        from bumpcosmology_torch.inference.sampler import fit

        t = self.traffic
        spec = self.spec._replace(loglike=tap.wrap(self.spec.loglike))
        fit(spec, seed=seed, num_warmup=0, num_samples=t["num_samples"], num_chains=self.chains,
            cfg=NutsConfig(max_depth=t["max_depth"], dense_mass=self.config["dense_mass"]),
            warmup_state=self.warm, sampler=t["sampler"], verbose=False, device=self.device)

    def reference_inputs(self, dtype, device):
        """(catalog, dL bounds) for the reference, from the raw columns."""
        import numpy as np

        if dtype not in self._ref_inputs:
            ref, r = self.reference, self.raw
            ev = {k: r["ev_" + k][None] for k in ("a", "q", "c", "lp")}
            sel = {k: r["sel_" + k][None] for k in ("a", "q", "c", "lp")}
            bounds = ref.dl_bounds(r["ev_c"], r["sel_c"], self.config["dl_margin"])
            self._ref_inputs[dtype] = (ref.catalogs(ev, sel, np.asarray([float(r["sel_ln"])]), dtype, device),
                                       bounds)
        return self._ref_inputs[dtype]


def _take_chains(warm, n: int):
    from bumpcosmology_torch.inference.nuts import ChainState, WarmupResult

    return WarmupResult(ChainState(*(x[:n] for x in warm.state)), warm.eps[:n], warm.cov[:n], warm.chol_cov[:n])


# ------------------------------------------------------------------ correctness

def judge(cell: Cell, recorder: Recorder, chains: List[int], device, limits: dict, seed: int,
          control: bool = False) -> dict:
    """The numbers that ``correct`` compares (see :func:`potential_gaps` and
    :func:`leapfrog_gaps`).  With ``control`` the reference's
    lower-precision control is judged in the program's place."""
    out = potential_gaps(cell, recorder.items(), device, limits, control)
    out.update(leapfrog_gaps(cell, recorder.thetas, chains, device, seed, control))
    return out


def potential_gaps(cell: Cell, items: List[Record], device, limits: dict, control: bool = False) -> dict:
    """The program's log-likelihood and its gradient against the float64
    reference's, at the sites of the sampled value+grads, every row.

    ``value_gap``: the largest |ll − ll_ref| / (1 + |ll_ref|).
    ``grad_gap``: the largest, over rows, of the row's largest gap of the
    gradient in posterior units (by the sites, times d site / d theta and
    the adapted posterior scale of each coordinate), over the larger of 1
    and the row's own largest such reference gradient.  A value that is not
    finite on either side makes the gap infinite.

    A row is ambiguous, and not judged, where moving every site and catalog
    row of the reference up and down by ``MOVE`` of itself (above float32's
    rounding of the program's intermediates) bends its value or its
    gradient by more than
    ``AMBIGUOUS`` of the limit: the second difference cancels the smooth
    response and keeps the jumps, such as a PE sample at the model's hard
    cut at 5 Msun alive on one side of float32's rounding and dead on the
    other, or a query at an interpolation knot taking the other one-sided
    derivative.  Which rows are ambiguous depends on the reference alone."""
    import torch

    ref, f64 = cell.reference, torch.float64
    n_grid, n_z = cell.config["n_grid"], cell.config["n_z"]
    sigma = torch.as_tensor(cell.cov, device=device).diagonal(dim1=1, dim2=2).mean(0).sqrt()
    cat, bounds = cell.reference_inputs(f64, device)
    cat32 = cell.reference_inputs(torch.float32, device)[0] if control else None
    up, down = (lambda x: x * (1.0 + MOVE)), (lambda x: x * (1.0 - MOVE))
    vgap, ggap, amb = [], [], []
    for rec in items:
        s64 = {k: rec.sites[k].to(device=device, dtype=f64) for k in ref.NAMES}
        ll_r, g_r = ref.loglike_and_site_grad(s64, cat, n_grid, n_z, bounds)
        ll_u, g_u = ref.loglike_and_site_grad(s64, cat, n_grid, n_z, bounds, move=up)
        ll_d, g_d = ref.loglike_and_site_grad(s64, cat, n_grid, n_z, bounds, move=down)
        if control:
            s32 = {k: v.float() for k, v in s64.items()}
            ll_p, g_p = ref.loglike_and_site_grad(s32, cat32, n_grid, n_z, bounds, ref.round_tf32)
            ll_p, g_p = ll_p.to(f64), g_p.to(f64)
        else:
            ll_p = rec.ll.to(device=device, dtype=f64)
            grads = rec.grads or {}  # none where the gradient never came back
            g_p = torch.stack([torch.full_like(ll_p, math.nan if rec.grads is None else 0.0) if grads.get(k) is None
                               else grads[k].to(device=device, dtype=f64) for k in ref.NAMES], dim=1)
        scale = ref.site_jacobian(s64).abs() * sigma
        w_r, w_p = g_r * scale, g_p * scale
        den = w_r.abs().amax(1).clamp_min(1.0)
        rel = 1.0 + ll_r.abs()
        v = ((ll_p - ll_r).abs() / rel).nan_to_num(nan=math.inf)
        v = torch.where(torch.isfinite(ll_p) & torch.isfinite(ll_r), v, math.inf)
        g = ((w_p - w_r).abs().amax(1) / den).nan_to_num(nan=math.inf)
        bend_v = (ll_u + ll_d - 2.0 * ll_r).abs() / rel
        bend_g = ((g_u + g_d - 2.0 * g_r) * scale).abs().amax(1) / den
        amb.append((bend_v > AMBIGUOUS * limits["value_gap"]) | (bend_g > AMBIGUOUS * limits["grad_gap"]))
        vgap.append(v)
        ggap.append(g)
    vgap, ggap, amb = torch.cat(vgap), torch.cat(ggap), torch.cat(amb)
    judged = ~amb
    return {"value_gap": float(vgap[judged].max()) if bool(judged.any()) else 0.0,
            "grad_gap": float(ggap[judged].max()) if bool(judged.any()) else 0.0,
            "value_gap_all_rows": float(vgap.max()), "grad_gap_all_rows": float(ggap.max()),
            "rows": int(vgap.numel()), "rows_ambiguous": int(amb.sum()),
            "ambiguous_gaps": [[float(a), float(b)] for a, b in zip(vgap[amb][:5], ggap[amb][:5])]}


def leapfrog_gaps(cell: Cell, thetas: List, chains: List[int], device, seed: int, control: bool = False) -> dict:
    """The integrator against the leapfrog's plain identity
    theta[k+1] − 2 theta[k] + theta[k−1] = −eps² M⁻¹ dU_ref/dtheta(theta[k]),
    with each chain's step size eps and inverse mass matrix M⁻¹ from the
    cell's adapted state, at a sample (drawn from ``seed``) of the window's
    value+grads k whose neighbours both hold every chain (the rows are then
    the chains in order).  A row's gap is |L⁻¹ r| / (eps² |Lᵀ g_ref|), r the
    identity's residual and L the Cholesky factor of M⁻¹ (the residual in
    the posterior's own units, over the step it should make).

    ``leapfrog_gap``: the largest, over chains, of the chain's median gap.
    A median because a triple that straddles the start of a subtree that
    turns back, or of a trajectory, breaks the identity by design (some
    tens of the leapfrogs of a trajectory of hundreds); a chain whose
    integrator is wrong in most of its leapfrogs reads high.

    The control is the plain leapfrog, put in the program's place and run in
    TF32: from the program's theta[k−1] and theta[k] it makes theta[k+1]
    with every stage rounded to TF32's 10 mantissa bits and the TF32
    reference's gradient."""
    import torch

    ref, f64 = cell.reference, torch.float64
    n_grid, n_z = cell.config["n_grid"], cell.config["n_z"]
    c = cell.chains
    full = [k for k in range(1, len(thetas) - 1) if chains[k - 1] == chains[k] == chains[k + 1] == c]
    take = sorted(random.Random(seed).sample(full, min(cell.traffic["leapfrog_sample"], len(full))))
    if not take:
        return {"leapfrog_gap": math.inf, "leapfrog_triples": 0}
    cat, bounds = cell.reference_inputs(f64, device)
    cat32 = cell.reference_inputs(torch.float32, device)[0] if control else None
    per = max(1, cell.traffic["check_block"] // c)
    eps = torch.as_tensor(cell.eps, device=device).repeat(per)[:, None]
    cov = torch.as_tensor(cell.cov, device=device).repeat(per, 1, 1)
    chol = torch.linalg.cholesky(cov)
    gaps = []
    for lo in range(0, len(take), per):
        block = take[lo:lo + per]
        n = len(block) * c
        e, m, lf = eps[:n], cov[:n], chol[:n]
        prev, th, nxt = (torch.cat([thetas[k + d] for k in block]).to(device=device, dtype=f64) for d in (-1, 0, 1))
        _, g = ref.value_and_grad(th, cat, n_grid, n_z, bounds)
        if control:
            _, g_c = ref.value_and_grad(th.float(), cat32, n_grid, n_z, bounds, ref.round_tf32)
            p_prev = torch.cholesky_solve((th - prev)[..., None], lf)[..., 0] / e
            t32 = lambda x: ref.round_tf32(x).to(f64)  # noqa: E731
            p = t32(t32(p_prev) - t32(e * g_c.to(f64)))
            nxt = t32(th + t32(e * t32((m @ p[..., None])[..., 0])))
        r = nxt - 2.0 * th + prev + e * e * (m @ g[..., None])[..., 0]
        white_r = torch.linalg.solve_triangular(lf, r[..., None], upper=False)[..., 0]
        white_g = (lf.mT @ g[..., None])[..., 0]
        gaps.append((white_r.norm(dim=1) / (e[:, 0] ** 2 * white_g.norm(dim=1))).reshape(len(block), c))
    per_chain = torch.cat(gaps).nan_to_num(nan=math.inf).median(dim=0).values
    return {"leapfrog_gap": float(per_chain.max()), "leapfrog_triples": len(take)}


# ------------------------------------------------------------------ the trace

class Trace:
    """The profiler over the stretch, and what it recorded."""

    START = "cardbench.loglike"
    DONE = "cardbench.grad_done"
    STRETCH = "cardbench.stretch"

    def __init__(self):
        self.prof = None
        self.stretch_rf = None

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    @classmethod
    def warm_up(cls, device) -> None:
        """One short profile in set-up: the profiler's first start (CUPTI's
        initialisation) takes seconds."""
        import torch
        from torch.profiler import profile

        with profile(activities=cls._activities()):
            (torch.ones(8, device=device) * 2.0).sum().item()

    def start(self):
        from torch.profiler import profile, record_function

        self.prof = profile(activities=self._activities())
        self.prof.start()
        self.stretch_rf = record_function(self.STRETCH)
        self.stretch_rf.__enter__()

    def stop(self):
        self.stretch_rf.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> dict:
        """Device activities, the log-likelihood's spans (each from its
        call to its gradient's return by the sites) and the host's ops
        inside the stretch, from the Chrome trace (written to and removed
        from the temporary directory)."""
        import bisect

        fd, path = tempfile.mkstemp(suffix=".json", prefix="cardbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)
        finally:
            os.remove(path)
        evs = raw["traceEvents"] if isinstance(raw, dict) else raw
        marks = {}
        for e in evs:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation":
                marks.setdefault(e.get("name"), []).append(e)
        stretch = marks.get(self.STRETCH)
        if not stretch:
            return {}
        t0 = float(stretch[0]["ts"])
        t1 = t0 + float(stretch[0]["dur"])
        device = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in evs
                        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                        and t0 <= float(e["ts"]) <= t1)
        starts = sorted(float(e["ts"]) for e in marks.get(self.START, ()))
        dones = sorted(float(e["ts"]) for e in marks.get(self.DONE, ()))
        spans = []
        for s in starts:
            j = bisect.bisect_left(dones, s)
            if j < len(dones):
                spans.append((s, dones[j]))
        host_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"]) for e in evs
                          if e.get("ph") == "X" and e.get("cat") == "cpu_op" and t0 <= float(e["ts"]) <= t1)
        busy, end = 0.0, -math.inf
        for s, e, _ in device:  # the union of the device's intervals
            if e > end:
                busy += e - max(s, end)
                end = e
        return dict(t0=t0, t1=t1, device=device, spans=spans, host_ops=host_ops, busy_s=busy * 1e-6,
                    window_s=(t1 - t0) * 1e-6)


def breakdown(tr: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by where the host was (in the log-likelihood's span,
    or in the sampler and the priors outside it) and the innermost host op
    running at the gap's middle."""
    import bisect

    by_name: Dict[str, float] = {}
    for s, e, name in tr["device"]:
        name = name if len(name) <= 100 else name[:97] + "..."
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_, end = [], tr["t0"]
    for s, e, _ in tr["device"]:
        if s > end:
            gaps_.append((end, s))
        end = max(end, e)
    if tr["t1"] > end:
        gaps_.append((end, tr["t1"]))
    gaps_.sort(key=lambda g: g[0] - g[1])
    starts = [sp[0] for sp in tr["spans"]]
    host_starts = [h[0] for h in tr["host_ops"]]
    idle = []
    for a, b in gaps_[:10]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        where = "loglike" if i >= 0 and tr["spans"][i][1] >= mid else "sampler_and_priors"
        j = bisect.bisect_right(host_starts, mid) - 1
        op = ""
        while j >= 0 and j >= bisect.bisect_right(host_starts, mid) - 64:
            if tr["host_ops"][j][1] >= mid:
                op = tr["host_ops"][j][2]
                break
            j -= 1
        idle.append([f"{where}: {op}" if op else where, (b - a) * 1e-6])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": idle}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def max_sm_clock_hz(default: float) -> float:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return default


# ------------------------------------------------------------------ one run

class Run:
    """What a per-layer reader reads: the window, the profiled stretch's
    trace (``{}`` in an untraced run), the cell's shapes and the yardstick."""

    def __init__(self, window: Window, trace: dict, shapes: dict, clock_hz: float):
        from cardbench import counts

        self.window, self.trace, self.shapes, self.clock_hz, self.counts = window, trace, shapes, clock_hz, counts

    def stretch_chains(self) -> List[int]:
        """Chains of each value+grad the profiler recorded."""
        w = self.window
        return w.chains[w.stretch_first:w.stretch_stop]

    def device_time_s(self, *fragments: str) -> float:
        """Device seconds in the stretch of the kernels whose name holds one of ``fragments``."""
        return sum(e - s for s, e, name in self.trace.get("device", ()) if any(f in name for f in fragments)) * 1e-6


def per_layer_metrics(manifest: dict, workload: str) -> List[dict]:
    return [m for m in manifest["per_layer"] if workload in m.get("workloads", [workload])]


def measure(cell: Cell, seed: int, seconds: float, trace: bool, sync: Callable[[], None]):
    """Drive the cell's entry from ``seed`` through one window: returns the
    :class:`Window`, the :class:`Recorder` and the :class:`Trace`
    (``None`` untraced)."""
    traffic = cell.traffic
    tr = Trace() if trace else None
    stretch = traffic["trace_stretch"]
    window = Window(seconds, calls_before=traffic["calls_before_window"], sync=sync,
                    span_sync=trace,
                    stretch_at=stretch["after_share"] if trace else 0.0,
                    stretch_n=stretch["value_and_grads"] if trace else 0,
                    start_trace=tr.start if trace else None, stop_trace=tr.stop if trace else None)
    recorder = Recorder(traffic["check_sample"], seed)
    if trace:
        Trace.warm_up(cell.device)
    try:
        cell.run(seed, Tap(window, recorder, tr))
    except WindowClosed:
        pass
    return window, recorder, tr


def run_benchmark(manifest: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
                  t_start: float, bench_dir: Path = BENCH_DIR, root: Path = REPO_DIR, log=None):
    """One run of one cell: set up, measure, read, judge.  Returns (exit
    code, result dict or ``None``, the check lines)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell_entry, config_entry = cell_of(manifest, workload)
    config = load_config(config_entry, root)
    traffic = load_traffic(cell_entry["traffic"], bench_dir)
    limits = limits_of(workload, bench_dir)
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    seed = int(seed) % (1 << 63)
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()

    cell = Cell(config, traffic, device, bench_dir)
    window, recorder, tr = measure(cell, seed, seconds, trace, sync)
    if window.close_t is None:
        log(f"the entry returned before the window closed ({window.count} value+grads in it)")
        return 3, None, []
    setup_s = window.open_t - t_start
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_loaded()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")
        return 4, None, []

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name() if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if on_card:
        device_info["power_limit"] = power_limit()
    breakdown_ = None
    if trace:
        trace_data = tr.read() if tr.prof is not None else {}
        from cardbench import counts

        run = Run(window, trace_data, cell.shapes(), max_sm_clock_hz(counts.H100_MAX_SM_CLOCK_HZ) if on_card
                  else counts.H100_MAX_SM_CLOCK_HZ)
        metrics = {}
        for m in per_layer_metrics(manifest, workload):
            value = load_reader(m["name"], bench_dir)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace_data:
            device_info["busy_s"] = trace_data["busy_s"]
            device_info["window_s"] = trace_data["window_s"]
            breakdown_ = breakdown(trace_data)
        log(f"traced stretch: {len(run.stretch_chains())} value+grads of {window.count} in the window")
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"},
                   "leapfrog_ms": {"value": window.leapfrog_ms(), "unit": "ms"},
                   "leapfrog_ms_p95": {"value": window.leapfrog_ms_p95(), "unit": "ms"}}
        names = {m["name"] for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])}
        metrics = {k: v for k, v in metrics.items() if k in names}
    log(f"window: {window.count} batched value+grads, {window.close_t - window.open_t:.3f} s; "
        f"set-up {setup_s:.3f} s; {device_info.get('power_limit', '')}")

    cell.free_program()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gaps_ = judge(cell, recorder, window.chains, device, limits, seed)
    log(f"reference: {gaps_['rows']} rows of {len(recorder.items())} value+grads ({gaps_['rows_ambiguous']} "
        f"ambiguous), {gaps_['leapfrog_triples']} leapfrog triples, in {time.perf_counter() - t0:.2f} s")
    if gaps_["ambiguous_gaps"]:
        log(f"ambiguous rows, [value gap, gradient gap]: {gaps_['ambiguous_gaps']}")
    checks = {name: {"value": gaps_[name], "limit": limits[name]} for name in NUMBERS}
    correct = gaps_["rows"] > gaps_["rows_ambiguous"] and all(c["value"] <= c["limit"] for c in checks.values())
    failed = 0 if correct else window.count  # the window's value+grads are judged together
    lines = [f"check {name} {c['value']!r} limit {c['limit']!r}" for name, c in checks.items()]
    result = {"correct": bool(correct), "attempted": window.count, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown_ is not None:
        result["breakdown"] = breakdown_
    result["checks"] = checks
    return 0, result, lines
