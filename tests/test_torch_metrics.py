"""The port's cluster-quality metrics against the JAX package's, on the CPU.

Mirrors ``tests/test_metrics.py``.  Every metric of ``kmeans_tpu.metrics``
runs on the same numpy inputs through both packages (the port with
``device="cpu"``).  The geometry metrics sum f32 terms in other orders —
both packages multiply silhouette's distance tiles by a one-hot matrix, but
the two matmuls and the other sums by label add in their own orders — so
they agree to ``RTOL`` = 1e-5 (``BF16_RTOL`` = 1e-4 for the bf16 product,
whose f32 accumulation order differs too); the contingency metrics count
exactly and agree to 1e-6.  One row's silhouette agrees to ``ROW_ATOL``
= 1e-4 (the test says why).  A sampled silhouette evaluates the rows the
port drew, replayed through the reference's ``jax.random.choice``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu import metrics as ref
from kmeans_tpu_torch import metrics as port
from torch_replay import record_calls, replay_jax_random

CPU = "cpu"
RTOL = 1e-5
BF16_RTOL = 1e-4
EXACT = 1e-6
ROW_ATOL = 1e-4


def _blobs(seed, n=600, d=6, k=4, std=0.6):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * 4
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)
    c = np.stack([x[lab == j].mean(0) for j in range(k)]).astype(np.float32)
    return x, lab.astype(np.int32), c


def _f(v):
    return float(v.item() if isinstance(v, torch.Tensor) else v)


@pytest.mark.parametrize("compute_dtype,rtol", [(None, RTOL),
                                                ("bfloat16", BF16_RTOL)])
@pytest.mark.parametrize("chunk", [64, 2048])
def test_silhouette_matches_the_reference(compute_dtype, rtol, chunk):
    x, lab, _ = _blobs(0)
    want = ref.silhouette_score(x, lab, k=4, chunk_size=chunk,
                                compute_dtype=compute_dtype)
    got = port.silhouette_score(x, lab, k=4, chunk_size=chunk,
                                compute_dtype=compute_dtype, device=CPU)
    np.testing.assert_allclose(_f(got), float(want), rtol=rtol)


def test_silhouette_samples_with_singletons_and_empty_clusters():
    """A singleton cluster scores 0, an empty one is skipped for b, and
    k above the labels' range leaves empty clusters: per row, as the
    reference's."""
    x, lab, _ = _blobs(1, n=300)
    lab = lab.copy()
    lab[0] = 5                         # a singleton; cluster 4 is empty
    valid = np.ones(300, bool)
    want = ref._silhouette_samples(
        jnp.asarray(x), jnp.asarray(lab), jnp.asarray(x), jnp.asarray(lab),
        jnp.asarray(valid), k=7, chunk_size=128, compute_dtype=None)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lab)
    got = port._silhouette_samples(xt, lt, xt, lt, torch.from_numpy(valid),
                                   k=7, chunk_size=128, compute_dtype=None)
    # A row's distance to itself is the square root of the rounding of
    # ‖x‖² − 2·x·x + ‖x‖² (up to ≈ 4e-3 at these norms), which the two
    # packages round differently; over its cluster's ≈ 70 members it moves
    # a row's s by up to ≈ 6e-5, so rows agree to ROW_ATOL (their mean to
    # RTOL, above).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ROW_ATOL)
    assert got[0].item() == 0.0


def test_sampled_silhouette_replays_the_ports_rows(monkeypatch):
    """``sample_size`` evaluates a uniform sample against every row: the
    port's draw (a ``torch.Generator``) handed to the reference gives its
    score."""
    x, lab, _ = _blobs(2, n=900)
    drawn = []
    record_calls(monkeypatch, port, "sample_rows", drawn)
    gen = torch.Generator().manual_seed(7)
    got = port.silhouette_score(x, lab, sample_size=200, generator=gen,
                                device=CPU)
    assert len(drawn) == 1 and len(np.unique(drawn[0])) == 200
    replay_jax_random(monkeypatch, "choice", drawn)
    want = ref.silhouette_score(x, lab, sample_size=200)
    np.testing.assert_allclose(_f(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("empty", [False, True])
def test_dispersion_scores_match_the_reference(empty):
    x, lab, c = _blobs(3, n=700, k=5)
    if empty:
        lab = np.where(lab == 2, 1, lab).astype(np.int32)   # cluster 2 empty
    want = ref.dispersion_scores(x, lab, c, chunk_size=256)
    got = port.dispersion_scores(x, lab, c, chunk_size=256, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f(g), float(w), rtol=RTOL)
    np.testing.assert_allclose(
        _f(port.davies_bouldin_score(x, lab, c, device=CPU)),
        float(ref.davies_bouldin_score(x, lab, c)), rtol=RTOL)
    np.testing.assert_allclose(
        _f(port.calinski_harabasz_score(x, lab, c, device=CPU)),
        float(ref.calinski_harabasz_score(x, lab, c)), rtol=RTOL)


def _label_pairs():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 5, 800)
    b = np.where(rng.random(800) < 0.7, a, rng.integers(0, 4, 800))
    neg = a.copy()
    neg[::9] = -1                   # trimmed-family outliers on one side
    return {
        "noisy": (a, b),
        "identical": (a, a),
        "relabelled": (a, (a + 2) % 5),
        "one cluster": (np.zeros(50, int), np.arange(50) % 3),
        "outliers": (neg, b),
    }


PAIRS = _label_pairs()


@pytest.mark.parametrize("name", list(PAIRS))
def test_contingency_metrics_match_the_reference(name):
    a, b = PAIRS[name]
    for fn in ("adjusted_rand_index", "normalized_mutual_info",
               "fowlkes_mallows_index"):
        want = float(getattr(ref, fn)(a, b))
        got = _f(getattr(port, fn)(a, b, device=CPU))
        np.testing.assert_allclose(got, want, rtol=EXACT, atol=EXACT,
                                   err_msg=fn)
    want = ref.homogeneity_completeness_v(a, b)
    got = port.homogeneity_completeness_v(a, b, device=CPU)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(_f(got[key]), float(want[key]),
                                   rtol=EXACT, atol=EXACT, err_msg=key)


@pytest.mark.parametrize("case", ["plain", "outliers", "empty"])
def test_dunn_index_matches_the_reference(case):
    x, lab, c = _blobs(5, n=500, k=4)
    lab = lab.copy()
    if case == "outliers":
        lab[::11] = -1
    if case == "empty":
        lab = np.where(lab == 3, 0, lab).astype(np.int32)
        c[3] = c[0] + 1e-3            # a stale centroid beside a live one
    want = ref.dunn_index(x, lab, c, chunk_size=128)
    got = port.dunn_index(x, lab, c, chunk_size=128, device=CPU)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_metrics_run_on_the_card_unless_asked_for_the_cpu():
    """Every metric defaults to the card: without one it raises, never
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, lab, c = _blobs(6, n=50)
    calls = [
        lambda: port.silhouette_score(x, lab),
        lambda: port.dispersion_scores(x, lab, c),
        lambda: port.adjusted_rand_index(lab, lab),
        lambda: port.normalized_mutual_info(lab, lab),
        lambda: port.homogeneity_completeness_v(lab, lab),
        lambda: port.fowlkes_mallows_index(lab, lab),
        lambda: port.dunn_index(x, lab, c),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
