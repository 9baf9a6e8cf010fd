"""The port's PCA / whitening against the JAX package's, on the CPU.

Mirrors ``tests/test_preprocess.py``.  Neither package fixes the sign of
an eigenvector, and ``torch.linalg.eigh`` may return the opposite sign of
``jnp.linalg.eigh`` for the same one, so components are compared up to a
per-row sign (COMP_ATOL, 1e-4: both covariances are f32 sums in other
orders, and an eigenvector moves by that over its eigengap) and
projections up to the same signs (PROJ_ATOL, 1e-3 of the data's scale).
Means agree to 1e-5 relative and explained variances to VAR_RTOL (1e-4).
The raw-pixel case (mean 120, std 5) holds the pilot mean: without it the
f32 second moment would cancel catastrophically.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.data import pca_fit as ref_pca_fit
from kmeans_tpu.data import pca_fit_stream as ref_pca_fit_stream
from kmeans_tpu.data import pca_inverse_transform as ref_inverse
from kmeans_tpu.data import pca_transform as ref_transform
from kmeans_tpu.data.preprocess import PCAState as RefPCAState
from kmeans_tpu_torch.convert import pca_from_numpy, pca_to_numpy
from kmeans_tpu_torch.data import (pca_fit, pca_fit_stream,
                                   pca_inverse_transform, pca_transform)

CPU = "cpu"
COMP_ATOL = 1e-4
PROJ_ATOL = 1e-3
VAR_RTOL = 1e-4


def _data(seed, n=1500, d=12, mean=0.0, std=1.0):
    """Rows with a decaying spectrum (well-separated eigenvalues) around
    ``mean``."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0]
    scales = std * 2.0 ** -np.arange(d, dtype=np.float64) * 8
    z = rng.normal(size=(n, d)) * scales
    return (mean + z @ basis.T).astype(np.float32)


def _signs(got, want):
    """Per-component signs that align ``got``'s rows with ``want``'s."""
    s = np.sign((np.asarray(got) * np.asarray(want)).sum(axis=1))
    assert (s != 0).all()
    return s


def _same_fit(got, want):
    want_c = np.asarray(want.components)
    s = _signs(got.components.numpy(), want_c)
    np.testing.assert_allclose(got.components.numpy() * s[:, None], want_c,
                               atol=COMP_ATOL)
    np.testing.assert_allclose(got.explained_variance.numpy(),
                               np.asarray(want.explained_variance),
                               rtol=VAR_RTOL)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-5, atol=1e-5 * max(
                                   1.0, float(np.abs(want.mean).max())))
    assert got.whiten == want.whiten
    return s


@pytest.mark.parametrize("case", ["plain", "whiten", "pixels", "bf16"])
def test_pca_fit_and_transform_match_the_reference(case):
    x = _data(0, mean=120.0, std=5.0) if case == "pixels" else _data(0)
    kw = dict(whiten=case in ("whiten", "pixels"), chunk_size=256)
    if case == "bf16":
        kw["compute_dtype"] = "bfloat16"
    want = ref_pca_fit(jnp.asarray(x), 5, **kw)
    got = pca_fit(x, 5, device=CPU, **kw)
    s = _same_fit(got, want)
    z_w = np.asarray(ref_transform(want, jnp.asarray(x), chunk_size=300))
    z_g = pca_transform(got, x, chunk_size=300).numpy()
    scale = float(np.abs(z_w).max())
    np.testing.assert_allclose(z_g * s, z_w, atol=PROJ_ATOL * scale)
    if kw["whiten"]:
        np.testing.assert_allclose(z_g.var(axis=0), 1.0, rtol=1e-2)
    back_w = np.asarray(ref_inverse(want, jnp.asarray(z_w)))
    back_g = pca_inverse_transform(got, z_g).numpy()
    np.testing.assert_allclose(back_g, back_w, rtol=1e-4,
                               atol=PROJ_ATOL * float(np.abs(x).max()))


def test_rank_deficient_whitening_zeroes_unsupported_components():
    """Components beyond the data's rank have eigenvalues at eigh's noise
    floor: whitening zeroes them (no 1e6 amplification), as the
    reference's cutoff does."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(400, 3)) @ rng.normal(size=(3, 8))).astype(
        np.float32)
    want = ref_pca_fit(jnp.asarray(x), 6, whiten=True)
    got = pca_fit(x, 6, whiten=True, device=CPU)
    z_w = np.asarray(ref_transform(want, jnp.asarray(x)))
    z_g = pca_transform(got, x).numpy()
    np.testing.assert_array_equal(z_g[:, 3:] == 0, z_w[:, 3:] == 0)
    assert (z_g[:, 3:] == 0).all()
    s = _signs(got.components.numpy()[:3], np.asarray(want.components)[:3])
    np.testing.assert_allclose(z_g[:, :3] * s, z_w[:, :3], atol=1e-3)


def test_pca_fit_stream_matches_the_reference(tmp_path):
    x = _data(2, n=3000, mean=50.0)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    data = np.load(path, mmap_mode="r")
    want = ref_pca_fit_stream(data, 4, whiten=True, chunk_size=700)
    got = pca_fit_stream(data, 4, whiten=True, chunk_size=700, device=CPU)
    _same_fit(got, want)
    # And the streamed fit is the in-memory one.
    one = pca_fit(x, 4, whiten=True, chunk_size=700, device=CPU)
    np.testing.assert_allclose(np.abs(got.components.numpy()),
                               np.abs(one.components.numpy()),
                               atol=COMP_ATOL)


def test_a_reference_fit_carried_across_projects_the_same():
    """``convert.pca_from_numpy`` carries a reference fit: the port's
    projection is the reference's, no sign in question; ``pca_to_numpy``
    carries it back."""
    x = _data(3)
    want = ref_pca_fit(jnp.asarray(x), 4, whiten=True)
    st = pca_from_numpy(want, device=CPU)
    np.testing.assert_allclose(
        pca_transform(st, x).numpy(),
        np.asarray(ref_transform(want, jnp.asarray(x))), rtol=1e-5,
        atol=1e-5)
    back = RefPCAState(**pca_to_numpy(st))
    np.testing.assert_array_equal(np.asarray(back.components),
                                  np.asarray(want.components))
    assert back.whiten is True


def test_component_count_errors_match_the_reference(tmp_path):
    x = _data(4, n=20, d=6)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    data = np.load(path, mmap_mode="r")
    for m in (0, 7):
        for ref, port in ((lambda: ref_pca_fit(jnp.asarray(x), m),
                           lambda: pca_fit(x, m, device=CPU)),
                          (lambda: ref_pca_fit_stream(data, m),
                           lambda: pca_fit_stream(data, m, device=CPU))):
            with pytest.raises(ValueError) as want:
                ref()
            with pytest.raises(ValueError) as got:
                port()
            assert str(got.value) == str(want.value)
    assert isinstance(pca_fit(x, 2, device=CPU).mean, torch.Tensor)
