"""The port's spectral clustering (``kmeans_tpu_torch.models.spectral``) and
``make_rings`` / ``make_moons`` against the JAX package's, on the CPU.

The embedding is unique only up to a rotation of its top eigenspace (the
signs ``eigh`` picks, and any turn inside a near-degenerate eigenvalue
pair, as on rings), so embeddings are compared by their projector U Uᵀ
(PROJ_ATOL, 1e-5, on entries of order 1; RINGS_ATOL, 1e-4, on rings,
whose 256-landmark pseudo-inverse carries f32 rounding of that order into
the cross-ring entries) and labels up to a permutation
(adjusted Rand index 1).  The final k-means is held exactly by carrying
the reference's embedding into the port (``convert.spectral_from_numpy``)
and running both packages' ``fit_lloyd`` from one init.  The landmark draw
and the k-means seeding are the port's, replayed through the reference
(``tests/torch_replay.py``).  The rings and moons are numpy's draws, fed to
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.data import make_moons as ref_make_moons
from kmeans_tpu.models import fit_lloyd as ref_fit_lloyd
from kmeans_tpu.models import spectral as ref_spectral
from kmeans_tpu_torch import convert
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.data import make_moons, make_rings
from kmeans_tpu_torch.metrics import adjusted_rand_index
from kmeans_tpu_torch.models import fit_lloyd
from kmeans_tpu_torch.models import spectral as port_spectral

PROJ_ATOL = 1e-5
RINGS_ATOL = 1e-4
CPU = "cpu"


def _rings(n_per, radii=(1.0, 4.0), noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    parts, labels = [], []
    for i, r in enumerate(radii):
        t = rng.uniform(0.0, 2.0 * np.pi, n_per)
        parts.append(np.stack([r * np.cos(t), r * np.sin(t)], 1)
                     + noise * rng.normal(size=(n_per, 2)))
        labels.append(np.full(n_per, i))
    return (np.concatenate(parts).astype(np.float32),
            np.concatenate(labels).astype(np.int32))


def _blobs(seed, n, d, k, std=0.5, spread=4.0):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, size=n)
    return ((centres[lab] + std * rng.normal(size=(n, d))).astype(
        np.float32), lab.astype(np.int32))


XR, YR = _rings(150)
XB, YB = _blobs(1, 400, 6, 4)
LB = XB[::11][:32].copy()


def _proj(u):
    u = np.asarray(u, np.float64)
    return u @ u.T


def _ari(a, b):
    return float(adjusted_rand_index(np.asarray(a), np.asarray(b),
                                     device=CPU))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_embedding_matches_the_reference_up_to_rotation(dtype):
    """From the same landmarks: the projector of the (n, k) embedding;
    every row has norm 1.  bf16 rounds the rows in the K(x, L) tiles (the
    landmarks stay f32), as the reference does."""
    got = port_spectral.spectral_embedding(
        XB, 4, landmarks=LB, chunk_size=128, compute_dtype=dtype,
        device=CPU).numpy()
    want = np.asarray(ref_spectral.spectral_embedding(
        jnp.asarray(XB), 4, landmarks=jnp.asarray(LB), chunk_size=128,
        compute_dtype=dtype))
    assert got.shape == (400, 4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(_proj(got), _proj(want), atol=PROJ_ATOL)


def test_embedding_of_rings_is_a_rotation_of_the_references(monkeypatch):
    """Rings: the top two eigenvalues nearly tie, so the two packages'
    eigenvectors may turn inside that plane; the projector agrees.  The
    default landmark draw is the port's, replayed through
    ``jax.random.choice``."""
    from torch_replay import replay_jax_random

    idx = torch.randperm(300, generator=torch.Generator().manual_seed(0))
    got = port_spectral.spectral_embedding(XR, 2, gamma=2.0, device=CPU)
    replay_jax_random(monkeypatch, "choice", [idx[:256].numpy()])
    want = ref_spectral.spectral_embedding(jnp.asarray(XR), 2, gamma=2.0)
    np.testing.assert_allclose(_proj(got.numpy()), _proj(want),
                               atol=RINGS_ATOL)


def test_rings_are_cut_and_the_final_fit_is_the_references():
    """``fit_spectral`` separates rings Lloyd cannot (the reference's bar:
    ARI above 0.99); the reference's embedding carried into the port gives
    the same ``fit_lloyd`` from one init, labels and inertia."""
    st = port_spectral.fit_spectral(XR, 2, gamma=2.0, device=CPU,
                                    config=KMeansConfig(k=2, seed=0))
    assert _ari(st.labels, YR) > 0.99
    assert _ari(fit_lloyd(XR, 2, device=CPU).labels, YR) < 0.5
    ref = ref_spectral.fit_spectral(jnp.asarray(XR), 2, gamma=2.0,
                                    key=jax.random.key(0))
    carried = convert.spectral_from_numpy(ref._asdict(), device=CPU)
    np.testing.assert_array_equal(carried.embedding.numpy(),
                                  np.asarray(ref.embedding))
    c0 = np.asarray(ref.embedding)[[0, 150]]
    got = fit_lloyd(carried.embedding, 2, init=c0, device=CPU)
    want = ref_fit_lloyd(ref.embedding, 2, init=jnp.asarray(c0))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(float(got.inertia), float(want.inertia),
                               rtol=1e-5)


def test_estimator_replays_the_ports_draws(monkeypatch):
    """``SpectralClustering``: the port's landmark rows and k-means start
    (drawn from a generator derived from the seed, the reference's
    ``fold_in(key, 1)``) replayed through the reference, the start turned
    into the reference's basis (the orthogonal Procrustes map between the
    two embeddings): the same partition and embedding."""
    from torch_replay import (record_fit_lloyd, replay_fit_lloyd,
                              replay_jax_random)

    inits = []
    record_fit_lloyd(monkeypatch, port_spectral, inits)
    est = port_spectral.SpectralClustering(n_clusters=4, n_landmarks=40,
                                           seed=3, chunk_size=128,
                                           device=CPU).fit(XB)
    assert len(inits) == 1
    idx = torch.randperm(400, generator=torch.Generator().manual_seed(3))
    replay_jax_random(monkeypatch, "choice", [idx[:40].numpy()] * 2)
    u_ref = np.asarray(ref_spectral.spectral_embedding(
        jnp.asarray(XB), 4, n_landmarks=40, chunk_size=128), np.float64)
    a, _, bt = np.linalg.svd(est.embedding_.numpy().astype(np.float64).T
                             @ u_ref)
    turned = [(c0 @ (a @ bt)).astype(np.float32) for c0 in inits]
    used = replay_fit_lloyd(monkeypatch, ref_spectral, turned)
    ref = ref_spectral.SpectralClustering(n_clusters=4, n_landmarks=40,
                                          seed=3, chunk_size=128).fit(
        jnp.asarray(XB))
    assert used() == 1
    assert _ari(est.labels_, ref.labels_) == 1.0
    assert _ari(est.labels_, YB) == 1.0
    np.testing.assert_allclose(_proj(est.embedding_.numpy()),
                               _proj(ref.embedding_), atol=PROJ_ATOL)


def test_explicit_landmarks_leave_the_seeding_as_it_was():
    """The k-means seeding draws from its own generator: explicit
    landmarks (the drawn ones, passed in) give the same fit."""
    cfg = KMeansConfig(k=4, seed=3, chunk_size=128)
    a = port_spectral.fit_spectral(XB, 4, n_landmarks=40, config=cfg,
                                   device=CPU)
    idx = torch.randperm(400, generator=torch.Generator().manual_seed(3))
    b = port_spectral.fit_spectral(XB, 4, landmarks=XB[idx[:40].numpy()],
                                   config=cfg, device=CPU)
    np.testing.assert_array_equal(a.labels.numpy(), b.labels.numpy())
    np.testing.assert_array_equal(a.embedding.numpy(), b.embedding.numpy())


def test_moons_are_cut():
    """The reference's moons case: γ = 20, its bar ARI above 0.95."""
    x, y = make_moons(1, 200, noise=0.04, device=CPU)
    st = port_spectral.fit_spectral(x, 2, gamma=20.0, device=CPU,
                                    config=KMeansConfig(k=2, seed=0))
    assert _ari(st.labels, y) > 0.95


def test_rings_and_moons_generators():
    """The port's generators: the reference's shapes, dtypes and label
    layout (one label per ring, the moons 0 then 1), points on their
    radii within the noise, drawn on the given device from a seed or a
    generator; the draws are torch's, not ``jax.random``'s."""
    x, y = make_rings(5, 300, radii=(1.0, 6.0), noise=0.05, device=CPU)
    assert x.shape == (600, 2) and x.dtype == torch.float32
    assert y.dtype == torch.int32
    np.testing.assert_array_equal(y.numpy(), np.repeat([0, 1], 300))
    r = torch.linalg.norm(x, dim=1).numpy()
    assert np.all(np.abs(r[:300] - 1.0) < 0.3)
    assert np.all(np.abs(r[300:] - 6.0) < 0.3)
    x2, _ = make_rings(torch.Generator().manual_seed(5), 300, device=CPU)
    np.testing.assert_array_equal(x.numpy(), x2.numpy())
    xm, ym = make_moons(5, 100, dtype="bfloat16", device=CPU)
    assert xm.shape == (200, 2) and xm.dtype == torch.bfloat16
    np.testing.assert_array_equal(ym.numpy(), np.repeat([0, 1], 100))
    ref_x, ref_y = ref_make_moons(jax.random.key(5), 100)
    assert np.asarray(ref_x).shape == tuple(xm.shape)
    np.testing.assert_array_equal(np.asarray(ref_y), ym.numpy())
    if not torch.cuda.is_available():
        # The default device is the card: without one the generator
        # raises instead of drawing on the CPU.
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_rings(0, 10)


@pytest.mark.parametrize("case", ["landmark shape", "too few landmarks",
                                  "too few drawn"])
def test_guards_raise_the_references_errors(case):
    kw = {"landmark shape": dict(landmarks=LB[:, :5].copy()),
          "too few landmarks": dict(landmarks=LB[:3].copy()),
          "too few drawn": dict(n_landmarks=2)}[case]
    ref_kw = {n: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for n, v in kw.items()}
    with pytest.raises(ValueError) as got:
        port_spectral.spectral_embedding(XB, 4, device=CPU, **kw)
    with pytest.raises(ValueError) as want:
        ref_spectral.spectral_embedding(jnp.asarray(XB), 4, **ref_kw)
    assert str(got.value) == str(want.value)
