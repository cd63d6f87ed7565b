"""Plain references of the joint potentials, one module a mass family, named
by a configuration's ``reference`` key (``bump_joint`` for the bump).

A reference module imports ``torch``, ``numpy``, ``math``, ``typing`` and
``__future__`` alone: neither JAX, nor the JAX package, nor anything of the
port, and it takes nothing that the program made (no weights, tables or
states).  Every function runs in the dtype of its positions or sites
(float64 for the reference, float32 for the control), with the gradient
by autograd, on rows that each carry their own position and catalog.
``cat`` is what :func:`catalogs` returns, ``bounds`` what :func:`dl_bounds`
returns; ``rnd`` rounds every tensor that crosses a stage (the identity for
the reference, :func:`round_tf32` for the control); ``move`` scales the
sites and catalog rows alone, before ``rnd`` (the harness's test of an
ambiguous row).  What the harness calls:

``NAMES``
    The family's sites in the order of its priors: a tuple of ``str``.
``catalogs(ev, sel, log_ndraw, dtype, device)``
    The detector-frame catalogs from numpy columns ``a, q, c, lp`` (events
    ``(R, nobs, nsamp)``, injections ``(R, nsel)``) and ``log_ndraw``
    ``(R,)``.
``dl_bounds(ev_dl, sel_dl, margin) -> (lo, hi)``
    The luminosity distances the detector table spans, as floats.
``value_and_grad(theta, cat, n_grid, n_z, bounds, rnd=identity) -> (u, du/dtheta)``
    The potential (negative log posterior) of unconstrained positions
    ``theta`` ``(R, len(NAMES))`` and its gradient, detached.
``loglike_and_site_grad(sites, cat, n_grid, n_z, bounds, rnd=identity, move=identity) -> (ll, dll/dsites)``
    The log-likelihood ``(R,)`` of the sites (a dict of ``(R,)`` tensors)
    and its gradient by them ``(R, len(NAMES))`` in ``NAMES``' order,
    detached.
``site_jacobian(sites) -> (R, len(NAMES))``
    d site / d theta of every site, from the constrained values.
``round_tf32(x)``
    ``x`` in float32 rounded to TF32's 10 mantissa bits, the gradient
    passed through.
"""
