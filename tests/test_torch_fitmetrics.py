"""The fit's metric families (C2) on the port's registry, against the JAX
package's, on the CPU.

The same explicit-init fits run in each package: a hamerly fit, a yinyang
fit, the adaptive ``update="auto"`` loop (``AUTO_MIN_ROWS`` lowered in both
packages so it engages at test size) and an Anderson fit.  Each package's
registry must then read the same deltas of
``kmeans_tpu_sweep_recompute_rows_total{update}`` and
``kmeans_tpu_accel_steps_total{outcome}`` (a before / after read, since the
registries are process-wide) and the same
``kmeans_tpu_sweep_group_filter_fraction``, set by the last yinyang-flavour
fit.  The data are integer-valued blobs, so both packages carry the same
centroids and count the same rows exactly.  Dense and delta fits stamp
nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import kmeans_tpu
import kmeans_tpu.ops.yinyang as ref_yy
from kmeans_tpu import obs as ref_obs
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu_torch import KMeansConfig, fit_lloyd, fit_lloyd_accelerated
from kmeans_tpu_torch import obs as port_obs
from kmeans_tpu_torch.ops import yinyang as Y

CPU = "cpu"
UPDATES = ("hamerly", "yinyang", "adaptive")
OUTCOMES = ("accepted", "rejected", "fallback")
RECOMPUTE = "kmeans_tpu_sweep_recompute_rows_total"
FILTER = "kmeans_tpu_sweep_group_filter_fraction"
ACCEL = "kmeans_tpu_accel_steps_total"


@pytest.fixture
def counting():
    """Both registries record (the reference's only while enabled)."""
    was = ref_obs.enabled(), port_obs.enabled()
    ref_obs.enable()
    port_obs.enable()
    yield
    if not was[0]:
        ref_obs.disable()
    if not was[1]:
        port_obs.disable()


def _read(obs):
    reg = obs.REGISTRY
    out = {("rows", u): reg.get(RECOMPUTE).value(update=u) for u in UPDATES}
    out.update({("accel", o): reg.get(ACCEL).value(outcome=o)
                for o in OUTCOMES})
    return out


def _blobs(seed, n, d, k, scale=4.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 3.0
    x = np.round((centres[rng.integers(0, k, n)]
                  + rng.normal(size=(n, d))) * scale).astype(np.float32)
    return x, x[rng.integers(0, n, k)].copy()


def _anderson_problem(n=800, d=8, k=6, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 6.0
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k - 1)]
    pick.append(int(np.flatnonzero(lab == 0)[1]))
    return x, x[pick].copy()


def test_fit_families_read_the_same_in_both_registries(counting,
                                                       monkeypatch):
    for mod in (Y, ref_yy):
        monkeypatch.setattr(mod, "AUTO_MIN_ROWS", 256)
    fits = []
    for seed, update in ((20, "hamerly"), (21, "yinyang"), (22, "auto")):
        x, c0 = _blobs(seed, 3000, 16, 12)
        fits.append((x, c0, update))
    before = _read(ref_obs), _read(port_obs)
    filters = []
    for x, c0, update in fits:
        k = c0.shape[0]
        kw = dict(init=c0, max_iter=40, tol=-1.0)
        _, pd = fit_lloyd(x, k, device=CPU, diag=True,
                          config=KMeansConfig(k=k, update=update), **kw)
        _, rd = kmeans_tpu.fit_lloyd(
            jnp.asarray(x), k, init=jnp.asarray(c0), max_iter=40, tol=-1.0,
            config=RefConfig(k=k, update=update), diag=True)
        assert pd == rd
        filters.append((ref_obs.REGISTRY.get(FILTER).value(),
                        port_obs.REGISTRY.get(FILTER).value()))
    xa, ca = _anderson_problem()
    fit_lloyd_accelerated(xa, 6, init=ca, device=CPU, tol=1e-4,
                          accel="anderson")
    kmeans_tpu.fit_lloyd_accelerated(jnp.asarray(xa), 6,
                                     init=jnp.asarray(ca), tol=1e-4,
                                     accel="anderson")
    after = _read(ref_obs), _read(port_obs)
    ref_delta = {key: after[0][key] - before[0][key] for key in after[0]}
    port_delta = {key: after[1][key] - before[1][key] for key in after[1]}
    assert port_delta == ref_delta
    assert all(ref_delta[("rows", u)] > 0 for u in UPDATES), ref_delta
    assert ref_delta[("accel", "accepted")] >= 1
    # The yinyang and adaptive fits each set the gauge, alike.
    assert filters[1][0] == filters[1][1] and 0.0 < filters[1][1] < 1.0
    assert filters[2][0] == filters[2][1]


def test_dense_and_delta_fits_stamp_nothing(counting):
    x, c0 = _blobs(23, 1000, 8, 6)
    before = _read(port_obs), port_obs.REGISTRY.get(FILTER).value()
    for update in ("matmul", "delta"):
        fit_lloyd(x, 6, init=c0, max_iter=10, device=CPU,
                  config=KMeansConfig(k=6, update=update))
    assert (_read(port_obs), port_obs.REGISTRY.get(FILTER).value()) == before


def test_fit_families_carry_the_references_help_and_labels():
    for name in (RECOMPUTE, FILTER, ACCEL):
        assert port_obs.REGISTRY.describe()[name] == \
            ref_obs.REGISTRY.describe()[name], name
    text = port_obs.REGISTRY.expose()
    for o in OUTCOMES:      # created at import, before any fit
        assert f'{ACCEL}{{outcome="{o}"}}' in text
