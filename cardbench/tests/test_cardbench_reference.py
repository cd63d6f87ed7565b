"""The frozen plain reference against the port's plain route, at a tiny
size in float64 on the CPU, value and gradient by the positions and by the
sites.  This file may import both; the reference itself imports nothing of
the port."""
import math
import subprocess
import sys

import numpy as np
import torch

from cardbench.harness import REPO_DIR, cut_catalog, read_catalog
from cardbench.reference import bump_joint as ref

N_GRID, N_Z = 32, 64
CATALOG = REPO_DIR / "cardbench" / "data" / "flagship_catalog.npz"


def port_data(raw):
    from bumpcosmology_torch.inference.likelihoods import EventData, PopCosmoData, SelectionData

    t = {k: torch.as_tensor(np.asarray(v), dtype=torch.float64) for k, v in raw.items()}
    return PopCosmoData(EventData(t["ev_a"], t["ev_q"], t["ev_c"], t["ev_lp"]),
                        SelectionData(t["sel_a"], t["sel_q"], t["sel_c"], t["sel_lp"], t["sel_ln"]))


def positions(n, seed=3):
    from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS
    from bumpcosmology_torch.inference.model import ModelSpec, prior_sample

    spec = ModelSpec(priors=dict(POP_COSMO_PRIORS), loglike=None, device=torch.device("cpu"))
    return prior_sample(spec, torch.Generator().manual_seed(seed), (n,)).double()


def close(a, b, tol):
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert float(((a - b).abs() / (1.0 + b.abs())).max()) < tol


def test_reference_matches_the_ports_plain_route_on_a_shared_catalog():
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad

    raw = cut_catalog(read_catalog(CATALOG), 5, 24, 400)
    spec = pop_cosmo_model_spec(port_data(raw), n_grid=N_GRID, n_z=N_Z, device="cpu", plain=True)
    theta = positions(6)
    u_port, g_port = value_and_grad(make_potential(spec), theta)
    ev = {k: raw["ev_" + k][None] for k in ("a", "q", "c", "lp")}
    sel = {k: raw["sel_" + k][None] for k in ("a", "q", "c", "lp")}
    cat = ref.catalogs(ev, sel, [float(raw["sel_ln"])], torch.float64, "cpu")
    bounds = ref.dl_bounds(raw["ev_c"], raw["sel_c"], 0.05)
    u_ref, g_ref = ref.value_and_grad(theta, cat, N_GRID, N_Z, bounds)
    # the port's Uniform prior density is a float32 constant (torch.where of two Python floats): 3.8e-8 nats
    close(u_ref, u_port, 1e-8)
    close(g_ref, g_port, 1e-8)


def test_the_gradient_by_the_sites_and_the_sites_jacobian():
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import constrain

    raw = cut_catalog(read_catalog(CATALOG), 4, 16, 300)
    spec = pop_cosmo_model_spec(port_data(raw), n_grid=N_GRID, n_z=N_Z, device="cpu", plain=True)
    theta = positions(5, seed=9).requires_grad_(True)
    sites = constrain(spec, theta)
    ll_port = spec.loglike(sites)
    g_port = torch.autograd.grad(ll_port.sum(), [sites[k] for k in ref.NAMES], allow_unused=True)
    ev = {k: raw["ev_" + k][None] for k in ("a", "q", "c", "lp")}
    sel = {k: raw["sel_" + k][None] for k in ("a", "q", "c", "lp")}
    cat = ref.catalogs(ev, sel, [float(raw["sel_ln"])], torch.float64, "cpu")
    bounds = ref.dl_bounds(raw["ev_c"], raw["sel_c"], 0.05)
    s64 = {k: v.detach() for k, v in sites.items()}
    ll_ref, g_ref = ref.loglike_and_site_grad(s64, cat, N_GRID, N_Z, bounds)
    close(ll_ref, ll_port.detach(), 1e-8)
    for i, g in enumerate(g_port):
        close(g_ref[:, i], torch.zeros_like(ll_ref) if g is None else g, 1e-8)
    # d site / d theta: the reference's from the sites, the port's by autograd of its own transforms
    jac_port = torch.stack([torch.autograd.grad(sites[k].sum(), theta, retain_graph=True)[0][:, i]
                            for i, k in enumerate(ref.NAMES)], dim=1)
    close(ref.site_jacobian(s64), jac_port, 1e-10)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0, -math.inf, math.nan], dtype=torch.float64)
    r = ref.round_tf32(x)
    assert r[1] == 1.0 + 2.0 ** -10 and r[2] == -3.0 and r[3] == -math.inf and torch.isnan(r[4])
    assert abs(float(r[0]) - 1.0) in (0.0, 2.0 ** -10)
    y = torch.randn(1000, dtype=torch.float32)
    assert float(((ref.round_tf32(y) - y).abs() / y.abs()).max()) <= 2.0 ** -11


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import cardbench.reference.bump_joint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('bumpcosmology_torch', 'bumpcosmology_tpu', 'jax', 'jaxlib', 'flax')]; print(bad)") % str(REPO_DIR)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
