"""Replaying the port's draws through the JAX package, for the tests of the
families that seed their own inner fits (bisecting, x-means, g-means,
``sweep_k``, ``gap_statistic``), of the soft and balanced families'
restarts and sweeps (each fit's seeding, through ``resolve_fit_inputs``)
and of the pairwise families (:func:`replay_pairwise`).

The port draws from a :class:`torch.Generator` and the reference from
``jax.random`` keys, so their k-means++ starts and samples differ.  A test
records what the port drew — each inner fit's starting centroids, each
silhouette sample, each gap reference set — by wrapping the port's names
with pytest's ``monkeypatch``, then hands the same values to the reference
by wrapping its names the same way, so both packages run the same fits.
Nothing in either package is edited.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def record_fit_lloyd(monkeypatch, module, inits):
    """Wrap ``module.fit_lloyd`` (the port's) so each call runs from an
    explicit init: the one the caller gave, or the seeding the call would
    have drawn from its generator (the same draws, in the same order).
    Each start is appended to ``inits``."""
    from kmeans_tpu_torch.device import as_tensor, resolve_device
    from kmeans_tpu_torch.models.init import resolve_fit_inputs

    real = module.fit_lloyd

    def fit_lloyd(x, k, *, generator=None, config=None, init=None,
                  weights=None, device=None, **kw):
        if init is None or isinstance(init, str):
            dev = resolve_device(device)
            xx = as_tensor(x, dev)
            w = None if weights is None else as_tensor(weights, dev,
                                                       torch.float32)
            _, _, init = resolve_fit_inputs(xx, k, generator, config, init,
                                            w)
        inits.append(_np(init).astype(np.float32))
        return real(x, k, generator=generator, config=config, init=init,
                    weights=weights, device=device, **kw)

    monkeypatch.setattr(module, "fit_lloyd", fit_lloyd)


def replay_fit_lloyd(monkeypatch, module, inits):
    """Wrap ``module.fit_lloyd`` (the reference's) so its calls start, in
    order, from the port's recorded ``inits``; returns a function that
    says how many were used."""
    import jax.numpy as jnp

    real = module.fit_lloyd
    used = [0]

    def fit_lloyd(x, k, *, key=None, config=None, init=None, weights=None,
                  **kw):
        c0 = inits[used[0]]
        used[0] += 1
        assert c0.shape[0] == k, (c0.shape, k)
        return real(x, k, key=key, config=config, init=jnp.asarray(c0),
                    weights=weights, **kw)

    monkeypatch.setattr(module, "fit_lloyd", fit_lloyd)
    return lambda: used[0]


def record_calls(monkeypatch, module, name, out):
    """Wrap ``module.<name>`` so each result is appended to ``out``."""
    real = getattr(module, name)

    def wrapped(*a, **kw):
        r = real(*a, **kw)
        out.append(_np(r))
        return r

    monkeypatch.setattr(module, name, wrapped)


def replay_jax_random(monkeypatch, name, values):
    """Wrap ``jax.random.<name>`` so its calls return ``values`` in order
    (the port's draws: silhouette samples for ``choice``, gap reference
    sets for ``uniform``)."""
    import jax
    import jax.numpy as jnp

    it = iter(list(values))

    def draw(key, *a, **kw):
        return jnp.asarray(next(it))

    monkeypatch.setattr(jax.random, name, draw)


def record_fit_inputs(monkeypatch, module, inits):
    """Wrap ``module.resolve_fit_inputs`` (the port's, as a family module
    imported it) so each start it resolves is appended to ``inits``: the
    soft and balanced families' seeding, one call a fit."""
    real = module.resolve_fit_inputs

    def resolve(*a, **kw):
        cfg, gen, c0 = real(*a, **kw)
        inits.append(_np(c0).astype(np.float32))
        return cfg, gen, c0

    monkeypatch.setattr(module, "resolve_fit_inputs", resolve)


def replay_fit_inputs(monkeypatch, module, inits):
    """Wrap ``module.resolve_fit_inputs`` (the reference's) so its calls
    start, in order, from the port's recorded ``inits``; returns a
    function that says how many were used."""
    import jax.numpy as jnp

    real = module.resolve_fit_inputs
    used = [0]

    def resolve(x, k, key, config, init, weights):
        c0 = inits[used[0]]
        used[0] += 1
        assert c0.shape[0] == k, (c0.shape, k)
        return real(x, k, key, config, jnp.asarray(c0), weights)

    monkeypatch.setattr(module, "resolve_fit_inputs", resolve)
    return lambda: used[0]


def replay_pairwise(monkeypatch, family, run_port):
    """Run ``run_port`` with the port's draws of a pairwise family recorded
    (k-medoids' starting indices, kernel k-means' starting labels, or the
    spectral embedding and its k-means start), then have the reference's
    fits start from them, call for call; returns ``run_port()``.  The
    spectral embedding is replayed whole: it is unique only up to a
    rotation, and a start is a start only in its own basis."""
    import jax.numpy as jnp

    import kmeans_tpu.models.kernel as ref_kernel
    import kmeans_tpu.models.medoids as ref_medoids
    import kmeans_tpu.models.spectral as ref_spectral
    import kmeans_tpu_torch.models.kernel as port_kernel
    import kmeans_tpu_torch.models.medoids as port_medoids
    import kmeans_tpu_torch.models.spectral as port_spectral

    name, port_mod, ref_mod = {
        "kmedoids": ("resolve_medoid_init", port_medoids, ref_medoids),
        "kernel": ("_resolve_labels0", port_kernel, ref_kernel),
        "spectral": ("spectral_embedding", port_spectral, ref_spectral),
    }[family]
    drawn, inits = [], []
    with monkeypatch.context() as m:
        record_calls(m, port_mod, name, drawn)
        if family == "spectral":
            record_fit_lloyd(m, port_spectral, inits)
        out = run_port()
    it = iter(drawn)
    monkeypatch.setattr(ref_mod, name, lambda *a, **kw: jnp.asarray(next(it)))
    if family == "spectral":
        replay_fit_lloyd(monkeypatch, ref_spectral, inits)
    return out
