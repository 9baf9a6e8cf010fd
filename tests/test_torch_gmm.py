"""The port's Gaussian mixtures (in memory and streamed) against the JAX
package's, on the CPU.

Mirrors ``tests/test_gmm.py`` and ``tests/test_gmm_stream.py``.  Both fits
start from one explicit ``init`` made with numpy; the port runs with
``device="cpu"``.  Labels, ``n_iter`` and ``converged`` must be equal (the
data's responsibilities have no near-ties, and ``TOL`` is far above the
log-likelihood's rounding, so both loops stop at one iteration); means,
variances and mixing weights agree to RTOL / ATOL (1e-4: two packages sum
the same f32 terms in other orders, and EM's fixed point amplifies that a
little), the log-likelihood to LL_RTOL (1e-5).  Where the port draws on
its own — the ``n_init`` restarts, ``sample`` — the draws are recorded
and replayed through the reference (``tests/torch_replay.py``).  The
streamed fit's batches are the reference's bit for bit (numpy draws), so
the streamed states agree to the same tolerances, and a checkpoint of
either package resumes in the other.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kmeans_tpu.models.gmm as ref_gmm_module  # noqa: E402
from kmeans_tpu.config import KMeansConfig as RefConfig  # noqa: E402
from kmeans_tpu.models import GaussianMixture as RefGMM  # noqa: E402
from kmeans_tpu.models import fit_gmm as ref_fit_gmm  # noqa: E402
from kmeans_tpu.models.gmm import GMMParams as RefParams  # noqa: E402
from kmeans_tpu.models.gmm import GMMState as RefState  # noqa: E402
from kmeans_tpu.models.gmm import gmm_log_resp as ref_log_resp  # noqa: E402
from kmeans_tpu.models.gmm import gmm_predict as ref_predict  # noqa: E402
from kmeans_tpu.models.gmm_stream import \
    fit_gmm_stream as ref_fit_stream  # noqa: E402
from kmeans_tpu.models.gmm_stream import \
    gmm_assign_stream as ref_assign_stream  # noqa: E402
import kmeans_tpu_torch.models.gmm as port_gmm_module  # noqa: E402
from kmeans_tpu_torch import GaussianMixture, KMeansConfig  # noqa: E402
from kmeans_tpu_torch.convert import gmm_from_numpy, gmm_to_numpy  # noqa: E402
from kmeans_tpu_torch.models.gmm import (GMMParams, fit_gmm,  # noqa: E402
                                         gmm_log_resp, gmm_predict)
from kmeans_tpu_torch.models.gmm_stream import (  # noqa: E402
    fit_gmm_stream, gmm_assign_stream)

CPU = "cpu"
RTOL = 1e-4
ATOL = 1e-4
LL_RTOL = 1e-5
#: The stop rule's tolerance on the mean log-likelihood's change: far
#: above its f32 rounding, so both packages stop at one iteration.
TOL = 1e-3
MAX_ITER = 10


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    """Hide orbax, so the reference writes npz checkpoints the port
    reads."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _blobs(seed, n=800, d=6, k=4, std=1.0, spread=4.0):
    """Blobs with per-feature scales (so diag differs from spherical); the
    init is the first row of each blob."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)) * spread
    lab = rng.integers(0, k, size=n)
    lab[:k] = np.arange(k)
    scale = rng.uniform(0.5, 1.5, size=d)
    x = (centres[lab] + std * scale * rng.normal(size=(n, d)))
    x = x.astype(np.float32)
    return x, x[:k].copy()


def _cfg(cls, k, **kw):
    return cls(k=k, init="given", chunk_size=128, tol=TOL, max_iter=MAX_ITER,
               **kw)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _same_state(got, want):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert int(got.n_iter) == int(want.n_iter)
    assert bool(got.converged) == bool(want.converged)
    _close(got.means.numpy(), want.means, "means")
    _close(got.covariances.numpy(), want.covariances, "covariances")
    _close(got.mix_weights.numpy(), want.mix_weights, "mix_weights")
    _close(got.resp_counts.numpy(), want.resp_counts, "resp_counts")
    np.testing.assert_allclose(float(got.log_likelihood),
                               float(want.log_likelihood), rtol=LL_RTOL)


@pytest.mark.parametrize("case", ["diag", "spherical", "tied", "weights",
                                  "bf16"])
def test_fit_gmm_matches_the_reference(case):
    x, c0 = _blobs(0)
    ct = case if case in ("diag", "spherical", "tied") else "diag"
    kw, w = {}, None
    if case == "bf16":
        kw["compute_dtype"] = "bfloat16"
    if case == "weights":
        w = np.random.default_rng(1).uniform(0.5, 2.0, x.shape[0]).astype(
            np.float32)
    want = ref_fit_gmm(jnp.asarray(x), 4, covariance_type=ct,
                       init=jnp.asarray(c0), config=_cfg(RefConfig, 4, **kw),
                       weights=None if w is None else jnp.asarray(w))
    got = fit_gmm(x, 4, covariance_type=ct, init=c0,
                  config=_cfg(KMeansConfig, 4, **kw), weights=w, device=CPU)
    _same_state(got, want)


def test_tied_at_d64_matches_the_reference():
    """The shared (d, d) covariance at d = 64: its Cholesky factor and
    triangular solves (torch's against jax's) and the symmetrized scatter
    give the reference's fit."""
    x, c0 = _blobs(2, n=900, d=64, k=3, spread=3.0)
    want = ref_fit_gmm(jnp.asarray(x), 3, covariance_type="tied",
                       init=jnp.asarray(c0), config=_cfg(RefConfig, 3))
    got = fit_gmm(x, 3, covariance_type="tied", init=c0,
                  config=_cfg(KMeansConfig, 3), device=CPU)
    _same_state(got, want)
    assert got.covariances.shape == (64, 64)


def test_a_dead_component_keeps_its_mean_and_variance():
    """A start far from every row gets no soft mass: it keeps its mean and
    starting variance and its weight floors through ``log(max(pi,
    1e-37))``, as in the reference."""
    x, c0 = _blobs(3)
    c0 = c0.copy()
    c0[3] = 1e4
    want = ref_fit_gmm(jnp.asarray(x), 4, init=jnp.asarray(c0),
                       config=_cfg(RefConfig, 4))
    got = fit_gmm(x, 4, init=c0, config=_cfg(KMeansConfig, 4), device=CPU)
    _same_state(got, want)
    assert float(got.resp_counts[3]) <= 1e-12
    np.testing.assert_array_equal(got.means.numpy()[3], c0[3])
    assert float(got.mix_weights[3]) == float(np.asarray(want.mix_weights)[3])


@pytest.mark.parametrize("ct", ["diag", "spherical", "tied"])
def test_log_resp_and_predict_match_the_reference(ct):
    """On the reference's fitted parameters: ``gmm_log_resp`` (log
    responsibilities and per-row log-densities) to ATOL, and
    ``gmm_predict`` label for label."""
    x, c0 = _blobs(4)
    st = ref_fit_gmm(jnp.asarray(x), 4, covariance_type=ct,
                     init=jnp.asarray(c0), config=_cfg(RefConfig, 4))
    rp = RefParams(st.means, st.covariances,
                   jnp.log(jnp.maximum(st.mix_weights, 1e-37)))
    pp = GMMParams(*(torch.from_numpy(np.array(a)) for a in rp))
    lr_w, lp_w = ref_log_resp(jnp.asarray(x), rp, chunk_size=100,
                              covariance_type=ct)
    lr_g, lp_g = gmm_log_resp(x, pp, chunk_size=100, covariance_type=ct)
    _close(lr_g.numpy(), lr_w, "log_resp", atol=1e-3)
    _close(lp_g.numpy(), lp_w, "log_prob", rtol=1e-5)
    np.testing.assert_array_equal(
        gmm_predict(x, pp, chunk_size=100, covariance_type=ct).numpy(),
        np.asarray(ref_predict(jnp.asarray(x), rp, chunk_size=100,
                               covariance_type=ct)))


@pytest.mark.parametrize("ct", ["diag", "spherical", "tied"])
def test_estimator_carried_from_the_reference(ct):
    """A reference ``GaussianMixture`` fit carried across with
    ``convert.gmm_from_numpy`` answers the same in the port: predict,
    predict_proba, score_samples, score, bic, aic and the sklearn-shaped
    attributes."""
    x, c0 = _blobs(5)
    ref = RefGMM(n_components=4, covariance_type=ct, init=jnp.asarray(c0),
                 chunk_size=128, max_iter=MAX_ITER).fit(jnp.asarray(x))
    got = GaussianMixture(n_components=4, covariance_type=ct,
                          chunk_size=128, device=CPU)
    got.state = gmm_from_numpy(ref.state, device=CPU)
    np.testing.assert_array_equal(got.predict(x).numpy(),
                                  np.asarray(ref.predict(x)))
    _close(got.predict_proba(x).numpy(), ref.predict_proba(x), "proba",
           atol=1e-5)
    _close(got.score_samples(x).numpy(), ref.score_samples(x), "samples",
           rtol=1e-5)
    for name in ("score", "bic", "aic"):
        np.testing.assert_allclose(getattr(got, name)(x),
                                   getattr(ref, name)(x), rtol=1e-5)
    _close(got.covariances_.numpy(), ref.covariances_, "covariances_")
    assert got.covariances_.shape == tuple(ref.covariances_.shape)
    assert got.n_iter_ == ref.n_iter_ and got.converged_ == ref.converged_
    # And back: the port's state is a reference GMMState's fields.
    back = RefState(**gmm_to_numpy(got.state))
    np.testing.assert_array_equal(np.asarray(back.labels),
                                  np.asarray(ref.state.labels))


@pytest.mark.parametrize("ct", ["diag", "tied"])
def test_sample_replays_through_the_reference(ct, monkeypatch):
    """``sample`` draws components (``draw_indices``: an int64 CDF) and
    Gaussian noise from a generator seeded with ``seed + 1``; replayed
    through the reference's ``gmm_sample`` (its ``categorical`` and
    ``normal`` returning the port's draws), the rows agree to 1e-5."""
    import torch_replay

    x, c0 = _blobs(6, d=5)
    ref = RefGMM(n_components=4, covariance_type=ct, init=jnp.asarray(c0),
                 chunk_size=128, max_iter=5).fit(jnp.asarray(x))
    port = GaussianMixture(n_components=4, covariance_type=ct, device=CPU)
    port.state = gmm_from_numpy(ref.state, device=CPU)
    comps, noise = [], []
    with monkeypatch.context() as m:
        torch_replay.record_calls(m, port_gmm_module, "draw_indices",
                                  comps)
        torch_replay.record_calls(m, torch, "randn", noise)
        xs, comp = port.sample(300)
    assert len(comps) == len(noise) == 1
    torch_replay.replay_jax_random(monkeypatch, "categorical", comps)
    torch_replay.replay_jax_random(monkeypatch, "normal", noise)
    xs_w, comp_w = ref.sample(300)
    np.testing.assert_array_equal(comp.numpy(), np.asarray(comp_w))
    _close(xs.numpy(), xs_w, "samples", rtol=1e-5, atol=1e-5)
    # The draws follow the mixing weights.
    counts = np.bincount(comp.numpy(), minlength=4) / 300
    assert np.abs(counts - port.weights_.numpy()).max() < 0.1


def test_n_init_restarts_replay_through_the_reference(monkeypatch):
    """``n_init=3`` k-means++ restarts: each restart's start is the port's
    draw, replayed through the reference's restarts; both keep the same
    highest-likelihood fit."""
    import torch_replay

    x, _ = _blobs(7)
    inits = []
    with monkeypatch.context() as m:
        torch_replay.record_fit_inputs(m, port_gmm_module, inits)
        got = GaussianMixture(n_components=4, n_init=3, seed=5,
                              max_iter=MAX_ITER, tol=TOL, chunk_size=128,
                              device=CPU).fit(x)
    assert len(inits) == 3
    used = torch_replay.replay_fit_inputs(monkeypatch, ref_gmm_module, inits)
    want = RefGMM(n_components=4, n_init=3, seed=5, max_iter=MAX_ITER,
                  tol=TOL, chunk_size=128).fit(jnp.asarray(x))
    assert used() == 3
    _same_state(got.state, want.state)


def test_errors_match_the_reference():
    x, c0 = _blobs(8, n=100)
    for kw in (dict(covariance_type="full"), dict(reg_covar=-1.0)):
        with pytest.raises(ValueError) as want:
            ref_fit_gmm(jnp.asarray(x), 4, init=jnp.asarray(c0), **kw)
        with pytest.raises(ValueError) as got:
            fit_gmm(x, 4, init=c0, device=CPU, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The streamed fit
# ---------------------------------------------------------------------------

STREAM_KW = dict(batch_size=200, steps=24, seed=3)


@pytest.fixture(scope="module")
def stream_data(tmp_path_factory):
    x, c0 = _blobs(9, n=3000, d=8, k=4, spread=5.0)
    path = str(tmp_path_factory.mktemp("gmm") / "x.npy")
    np.save(path, x)
    return path, x, c0


def _stream_cfg(cls):
    return cls(k=4, chunk_size=512)


def _same_stream(got, want, labels=True):
    if labels:
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
        np.testing.assert_allclose(float(got.log_likelihood),
                                   float(want.log_likelihood), rtol=LL_RTOL)
        _close(got.resp_counts.numpy(), want.resp_counts, "resp_counts",
               atol=1e-2)
    assert int(got.n_iter) == int(want.n_iter)
    _close(got.means.numpy(), want.means, "means")
    _close(got.covariances.numpy(), want.covariances, "covariances")
    _close(got.mix_weights.numpy(), want.mix_weights, "mix_weights")


@pytest.mark.parametrize("ct", ["diag", "spherical"])
def test_fit_gmm_stream_matches_the_reference(stream_data, ct):
    """Online EM over a memory-mapped ``.npy``: the same numpy batches,
    the same Robbins–Monro rates in f32, the starting variances from the
    same host subsample; the final streamed pass's labels, total
    log-likelihood and soft counts."""
    path, _, c0 = stream_data
    data = np.load(path, mmap_mode="r")
    want = ref_fit_stream(data, 4, covariance_type=ct, init=jnp.asarray(c0),
                          config=_stream_cfg(RefConfig), **STREAM_KW)
    got = fit_gmm_stream(data, 4, covariance_type=ct, init=c0,
                         config=_stream_cfg(KMeansConfig), device=CPU,
                         **STREAM_KW)
    _same_stream(got, want)


@pytest.mark.parametrize("first", ["port", "ref"])
def test_stream_checkpoint_resumes_in_the_other_package(stream_data,
                                                        tmp_path, first):
    """Twelve steps in one package with a checkpoint, then ``resume`` to
    24 in the other (its sampling and schedule adopted from the
    checkpoint): the result is the uninterrupted run's."""
    path, _, c0 = stream_data
    data = np.load(path, mmap_mode="r")
    ck = str(tmp_path / "ck")
    fits = {
        "port": lambda **kw: fit_gmm_stream(
            data, 4, config=_stream_cfg(KMeansConfig), device=CPU, **kw),
        "ref": lambda **kw: ref_fit_stream(
            data, 4, config=_stream_cfg(RefConfig), **kw),
    }
    second = "ref" if first == "port" else "port"
    init = c0 if first == "port" else jnp.asarray(c0)
    fits[first](init=init, checkpoint_path=ck, checkpoint_every=5,
                final_pass=False, **dict(STREAM_KW, steps=12))
    resumed = fits[second](checkpoint_path=ck, resume=True, steps=24)
    whole = fit_gmm_stream(data, 4, init=c0, config=_stream_cfg(KMeansConfig),
                           device=CPU, **STREAM_KW)
    if second == "ref":
        resumed, whole = whole, resumed
    _same_stream(resumed, whole)


def test_stream_preempted_and_resumed_is_the_uninterrupted_run(stream_data,
                                                               tmp_path):
    """SIGTERM at the 7th batch read cuts a checkpoint at the step boundary
    and raises ``Preempted``; the resumed run ends bit for bit where the
    uninterrupted one does."""
    from kmeans_tpu_torch.utils import faults
    from kmeans_tpu_torch.utils.preempt import Preempted

    path, _, c0 = stream_data
    data = np.load(path, mmap_mode="r")
    ck = str(tmp_path / "ck")
    kw = dict(config=_stream_cfg(KMeansConfig), device=CPU, **STREAM_KW)
    with faults.active("stream.read:sigterm@7"):
        with pytest.raises(Preempted) as cut:
            fit_gmm_stream(data, 4, init=c0, checkpoint_path=ck,
                           checkpoint_every=100, **kw)
    assert 0 < cut.value.step < STREAM_KW["steps"]
    resumed = fit_gmm_stream(data, 4, checkpoint_path=ck, resume=True, **kw)
    whole = fit_gmm_stream(data, 4, init=c0, **kw)
    for a, b in zip(resumed, whole):
        assert torch.equal(a, b)


def test_gmm_assign_stream_matches_the_reference(stream_data):
    path, x, c0 = stream_data
    st = ref_fit_gmm(jnp.asarray(x), 4, init=jnp.asarray(c0),
                     config=_cfg(RefConfig, 4))
    rp = RefParams(st.means, st.covariances,
                   jnp.log(jnp.maximum(st.mix_weights, 1e-37)))
    pp = GMMParams(*(torch.from_numpy(np.array(a)) for a in rp))
    data = np.load(path, mmap_mode="r")
    lab_w, ll_w, soft_w = ref_assign_stream(data, rp, chunk_size=700)
    lab_g, ll_g, soft_g = gmm_assign_stream(data, pp, chunk_size=700)
    np.testing.assert_array_equal(lab_g, lab_w)
    np.testing.assert_allclose(ll_g, ll_w, rtol=LL_RTOL)
    _close(soft_g, soft_w, "soft counts", atol=1e-2)


@pytest.mark.parametrize("case", ["tied", "kappa", "t0", "foreign",
                                  "contradiction"])
def test_stream_refusals_match_the_reference(stream_data, tmp_path, case):
    """The streamed fit's refusals, word for word: tied covariance, the
    schedule's ranges, a checkpoint of another family, and an explicit
    argument that contradicts the checkpoint."""
    from kmeans_tpu_torch.models.streaming import fit_minibatch_stream

    path, _, c0 = stream_data
    data = np.load(path, mmap_mode="r")
    ck = str(tmp_path / "ck")
    kw = dict(steps=2, batch_size=64)
    if case == "tied":
        kw["covariance_type"] = "tied"
    elif case == "kappa":
        kw["kappa"] = 0.5
    elif case == "t0":
        kw["t0"] = 0.5
    else:
        if case == "foreign":
            fit_minibatch_stream(data, 4, init=c0, checkpoint_path=ck,
                                 device=CPU, **kw)
        else:
            fit_gmm_stream(data, 4, init=c0, checkpoint_path=ck, seed=1,
                           device=CPU, **kw)
            kw["seed"] = 2
        kw.update(checkpoint_path=ck, resume=True)
    with pytest.raises(ValueError) as want:
        ref_fit_stream(data, 4, **kw)
    with pytest.raises(ValueError) as got:
        fit_gmm_stream(data, 4, device=CPU, **kw)
    assert str(got.value) == str(want.value)
