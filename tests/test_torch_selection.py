"""The port's model selection against the JAX package's, on the CPU.

Mirrors ``tests/test_selection.py``.  ``sweep_k`` and ``gap_statistic`` fit
k-means for every k, seeded from the port's :class:`torch.Generator`; each
test records what the port drew (every fit's starting centroids, every
silhouette sample, every gap reference set) and replays it through the
reference (``tests/torch_replay.py``), so both packages fit and score the
same things.  Rows must have the same keys, k, ``n_iter`` and
``converged``; inertia agrees to RTOL (1e-5) and 1e-6 of Σ‖x‖² (the
rounding of each row's expanded distance), silhouette, Davies–Bouldin and
Calinski–Harabasz to ``SCORE_RTOL`` (1e-4: taken at centroids that agree
to 1e-5, which DB's centroid distances amplify), and the gap rows' logs to
1e-5 absolute.  The soft families' sweeps (GMM rows with ``bic`` /
``aic``) replay the port's starts through ``resolve_fit_inputs``.  The
``suggest_*`` rules are host arithmetic and must pick the same k.  The
pairwise families' sweeps replay the port's starting medoids, starting
labels or spectral embedding and start (``torch_replay.replay_pairwise``).
"""

import numpy as np
import pytest

import kmeans_tpu.models as ref_models
from kmeans_tpu.models import gap_statistic as ref_gap
from kmeans_tpu.models import suggest_k as ref_suggest_k
from kmeans_tpu.models import suggest_k_gap as ref_suggest_k_gap
from kmeans_tpu.models import sweep_k as ref_sweep_k
import kmeans_tpu_torch.models as port_models
from kmeans_tpu_torch import metrics as port_metrics
from kmeans_tpu_torch.models import (gap_statistic, suggest_k, suggest_k_gap,
                                     sweep_k)
from kmeans_tpu_torch.models import selection as port_selection
from torch_replay import (record_calls, record_fit_lloyd, replay_fit_lloyd,
                          replay_jax_random)

CPU = "cpu"
RTOL = 1e-5
INERTIA_ATOL_REL = 1e-6
LOG_ATOL = 1e-5
#: A row's scores are taken at its fit's centroids, which agree to RTOL;
#: above the blob count two centroids split one blob, and Davies–Bouldin
#: divides by their distance, which amplifies that tenfold here.
SCORE_RTOL = 1e-4


def _blobs(seed, n=900, d=5, k=4, std=0.5):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-8, 8, size=(k, d))
    lab = rng.integers(0, k, size=n)
    return (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


def _rows_close(got, want, x):
    assert [list(r) for r in got] == [list(r) for r in want]
    atol = INERTIA_ATOL_REL * float((np.asarray(x, np.float64) ** 2).sum())
    for g, w in zip(got, want):
        for key in ("k", "n_iter", "converged"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(g["inertia"], w["inertia"], rtol=RTOL,
                                   atol=atol)
        for key in ("silhouette", "davies_bouldin", "calinski_harabasz"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=SCORE_RTOL,
                                           err_msg=f"{key} at k={w['k']}")


@pytest.mark.parametrize("sample", [10_000, 300])
def test_sweep_k_matches_the_reference(monkeypatch, sample):
    """Every row of the sweep, k = 1..6: the fits from the port's starts,
    the silhouette on the port's sample where it samples (300 < n)."""
    x = _blobs(0)
    inits, drawn = [], []
    with monkeypatch.context() as m:
        record_fit_lloyd(m, port_models, inits)
        record_calls(m, port_metrics, "sample_rows", drawn)
        got = sweep_k(x, range(1, 7), seed=2, silhouette_sample=sample,
                      chunk_size=256, device=CPU)
    used = replay_fit_lloyd(monkeypatch, ref_models, inits)
    replay_jax_random(monkeypatch, "choice", drawn)
    want = ref_sweep_k(x, list(range(1, 7)), seed=2,
                       silhouette_sample=sample, chunk_size=256)
    assert used() == len(inits) == 6
    assert len(drawn) == (5 if sample < x.shape[0] else 0)
    _rows_close(got, want, x)
    assert suggest_k(got) == ref_suggest_k(want) == 4


@pytest.mark.parametrize("model", ["accelerated", "minibatch", "spherical",
                                   "bisecting", "fuzzy", "gmm", "balanced"])
def test_sweep_k_takes_every_ported_family(model):
    """Each ported family of ``_FITTERS`` sweeps: the reference's row keys
    for every k and, on separated blobs, the reference's suggestion (the
    seeding draws differ; both reach the blobs)."""
    x = _blobs(5, n=400, std=0.3)
    got = sweep_k(x, [3, 4], model=model, seed=1, device=CPU)
    want = ref_sweep_k(x, [3, 4], model=model, seed=1)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert suggest_k(got) == ref_suggest_k(want) == 4


@pytest.mark.parametrize("model", ["gmm", "fuzzy"])
def test_soft_sweeps_match_the_reference(monkeypatch, model):
    """A GMM or fuzzy sweep from the port's starts (replayed through the
    reference's ``resolve_fit_inputs``) and silhouette samples: the
    reference's rows, GMM rows with ``bic`` / ``aic`` to RTOL, and the
    same BIC / AIC / silhouette suggestions.  The sweep stops at the blob
    count: above it EM converges slowly, and its stop rule can meet the
    tolerance one iteration apart in two f32 sum orders."""
    import importlib

    from torch_replay import record_fit_inputs, replay_fit_inputs

    port_mod = importlib.import_module(f"kmeans_tpu_torch.models.{model}")
    ref_mod = importlib.import_module(f"kmeans_tpu.models.{model}")
    x = _blobs(6, n=600)
    inits, drawn = [], []
    with monkeypatch.context() as m:
        record_fit_inputs(m, port_mod, inits)
        record_calls(m, port_metrics, "sample_rows", drawn)
        got = sweep_k(x, [2, 3, 4], model=model, seed=3, max_iter=30,
                      silhouette_sample=300, chunk_size=256, device=CPU)
    used = replay_fit_inputs(monkeypatch, ref_mod, inits)
    replay_jax_random(monkeypatch, "choice", drawn)
    want = ref_sweep_k(x, [2, 3, 4], model=model, seed=3, max_iter=30,
                       silhouette_sample=300, chunk_size=256)
    assert used() == len(inits) == 3
    _rows_close(got, want, x)
    criteria = ["silhouette"] + (["bic", "aic"] if model == "gmm" else [])
    for c in criteria:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[c], w[c], rtol=RTOL, err_msg=c)
        assert suggest_k(got, criterion=c) == \
            ref_suggest_k(want, criterion=c) == 4


def test_gap_statistic_matches_the_reference(monkeypatch):
    """The gap rows from the port's fits and uniform reference sets, both
    replayed; Tibshirani's rule picks the same k."""
    x = _blobs(1, n=600)
    inits, refs = [], []
    with monkeypatch.context() as m:
        record_fit_lloyd(m, port_models, inits)
        record_calls(m, port_selection, "uniform_rows", refs)
        got = gap_statistic(x, [2, 3, 4, 5], n_refs=3, seed=4,
                            chunk_size=256, device=CPU)
    used = replay_fit_lloyd(monkeypatch, ref_models, inits)
    replay_jax_random(monkeypatch, "uniform", refs)
    want = ref_gap(x, [2, 3, 4, 5], n_refs=3, seed=4, chunk_size=256)
    assert used() == len(inits) == 16 and len(refs) == 12
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert g["k"] == w["k"]
        for key in ("log_w", "ref_log_w", "gap", "s"):
            np.testing.assert_allclose(g[key], w[key], rtol=0,
                                       atol=LOG_ATOL, err_msg=key)
    assert suggest_k_gap(got) == ref_suggest_k_gap(want) == 4


ROWS = [
    {"k": 2, "inertia": 900.0, "silhouette": 0.4, "bic": 50.0, "aic": 40.0},
    {"k": 3, "inertia": 300.0, "silhouette": 0.7, "bic": 30.0, "aic": 45.0},
    {"k": 4, "inertia": 250.0, "silhouette": 0.6, "bic": 35.0, "aic": 20.0},
    {"k": 5, "inertia": 230.0, "silhouette": 0.5, "bic": 60.0, "aic": 25.0},
]


@pytest.mark.parametrize("criterion", ["silhouette", "bic", "aic", "elbow"])
def test_suggest_k_matches_the_reference(criterion):
    assert suggest_k(ROWS, criterion=criterion) == ref_suggest_k(
        ROWS, criterion=criterion)


def test_suggest_rules_refuse_as_the_reference():
    cases = [
        (lambda f: f([{"k": 1, "inertia": 3.0}]), suggest_k, ref_suggest_k),
        (lambda f: f(ROWS[:2], criterion="elbow"), suggest_k, ref_suggest_k),
        (lambda f: f([{"k": 2, "silhouette": 0.1}], criterion="bic"),
         suggest_k, ref_suggest_k),
        (lambda f: f(ROWS, criterion="median"), suggest_k, ref_suggest_k),
        (lambda f: f([]), suggest_k_gap, ref_suggest_k_gap),
    ]
    for call, mine, theirs in cases:
        with pytest.raises(ValueError) as got:
            call(mine)
        with pytest.raises(ValueError) as want:
            call(theirs)
        assert str(got.value) == str(want.value)
    # Flat objective: no elbow, the smallest k; rising gaps: the max gap.
    flat = [{"k": k, "inertia": 5.0} for k in (2, 3, 4)]
    assert suggest_k(flat, criterion="elbow") == ref_suggest_k(
        flat, criterion="elbow") == 2
    gaps = [{"k": k, "gap": float(k), "s": 0.0} for k in (2, 3, 4)]
    assert suggest_k_gap(gaps) == ref_suggest_k_gap(gaps) == 4


@pytest.mark.parametrize("model", ["kernel", "kmedoids", "spectral"])
def test_pairwise_sweeps_match_the_reference(monkeypatch, model):
    """A k-medoids, kernel or spectral sweep from the port's draws replayed
    through the reference: the reference's rows (spectral's silhouette in
    its embedding; the center-free kernel and spectral rows without DB /
    CH) and the same suggestion.  The rows lie on a 1/8 grid, where the
    medoid costs are exact products."""
    from torch_replay import replay_pairwise

    x = np.round(_blobs(7, n=300, d=4, k=3) * 8.0) / 8.0
    got = replay_pairwise(monkeypatch, model, lambda: sweep_k(
        x, [2, 3], model=model, seed=3, max_iter=30, chunk_size=128,
        device=CPU))
    want = ref_sweep_k(x, [2, 3], model=model, seed=3, max_iter=30,
                       chunk_size=128)
    _rows_close(got, want, x)
    for g, w in zip(got, want):
        for key in set(w) - {"k", "n_iter", "converged", "inertia"}:
            np.testing.assert_allclose(g[key], w[key], rtol=SCORE_RTOL,
                                       err_msg=key)
    assert ("davies_bouldin" in got[0]) == (model == "kmedoids")
    assert suggest_k(got) == ref_suggest_k(want)


def test_selection_guards_match_the_reference():
    x = _blobs(3, n=30)
    cases = [
        (lambda f: f(x, [0, 2]), sweep_k, ref_sweep_k),
        (lambda f: f(x, [2, 31]), sweep_k, ref_sweep_k),
        (lambda f: f(x, [2], model="trimmed"), sweep_k, ref_sweep_k),
        (lambda f: f(x, [2], n_refs=0), gap_statistic, ref_gap),
        (lambda f: f(x, [40]), gap_statistic, ref_gap),
    ]
    for call, mine, theirs in cases:
        mine_cpu = (lambda *a, **kw: mine(*a, device=CPU, **kw))
        with pytest.raises(ValueError) as got:
            call(mine_cpu)
        with pytest.raises(ValueError) as want:
            call(theirs)
        assert str(got.value) == str(want.value)


def test_selection_runs_on_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = _blobs(4, n=40)
    for call in (lambda: sweep_k(x, [2]), lambda: gap_statistic(x, [2])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
