"""The port's Anderson mixing and accelerated fits against the JAX package.

The same numpy inputs go through both packages: the port on the CPU
(``device="cpu"``: the kernels' plain versions), the reference on its XLA
route.  The fits start from an explicit ``init`` on separated blobs, and the
tolerance stops them while each safeguard decision is far from the f32 sum's
rounding, so the outcome sequences, sweep counts and labels must be equal;
centroids agree to rtol 1e-5 and atol 1e-6 (the two sum the same f32 terms
in another order), the mixing ops to rtol 1e-5.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu import obs as ref_obs
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu.models.accelerated import ACCEL_STEPS as REF_ACCEL_STEPS
from kmeans_tpu.ops import anderson as RA
from kmeans_tpu_torch import KMeansConfig, fit_lloyd, fit_lloyd_accelerated
from kmeans_tpu_torch.models.accelerated import ACCEL_STEPS
from kmeans_tpu_torch.ops import anderson as PA

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTCOMES = ("accepted", "rejected", "fallback")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _problem(seed=0, n=800, d=8, k=6, spread=6.0):
    """Separated blobs and an explicit init of k data rows, two of them
    from one blob so the first sweeps move rows between clusters."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k - 1)]
    pick.append(int(np.flatnonzero(lab == 0)[1]))
    return x, x[pick].copy()


@pytest.fixture
def ref_counting():
    """The reference's outcome counter records only while its metrics
    registry is enabled."""
    was = ref_obs.enabled()
    ref_obs.enable()
    yield
    if not was:
        ref_obs.disable()


def _tally(counter):
    return {o: counter.value(outcome=o) for o in OUTCOMES}


# ---------------------------------------------------------------------------
# ops/anderson
# ---------------------------------------------------------------------------

def _pushes(case):
    """(m, kd, [(x, r), ...]) of one history case."""
    rng = np.random.default_rng(7)
    m, kd = 3, 12
    if case == "wrap":          # five pushes into a ring of three
        pairs = [(rng.normal(size=kd), rng.normal(size=kd))
                 for _ in range(5)]
    elif case == "warmup":      # one pair: no direction to mix yet
        pairs = [(rng.normal(size=kd), rng.normal(size=kd))]
    else:                       # "singular": zero residuals, a zero Gram
        pairs = [(rng.normal(size=kd), np.zeros(kd)) for _ in range(3)]
    return m, kd, [(a.astype(np.float32), b.astype(np.float32))
                   for a, b in pairs]


@pytest.mark.parametrize("case", ["wrap", "warmup", "singular"])
def test_push_and_mix_match_reference(case):
    m, kd, pairs = _pushes(case)
    rx, rr, rc = RA.anderson_reset(m, kd)
    px, pr, pc = PA.anderson_reset(m, kd, device=CPU)
    for a, b in pairs:
        rx, rr, rc = RA.anderson_push(rx, rr, rc, jnp.asarray(a),
                                      jnp.asarray(b))
        px, pr, pc = PA.anderson_push(px, pr, pc, _t(a), _t(b))
    assert int(pc) == int(rc) == len(pairs)
    np.testing.assert_array_equal(px.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(rr))
    r_mixed, r_ok = RA.anderson_mix(rx, rr, rc, reg=jnp.float32(1e-8))
    p_mixed, p_ok = PA.anderson_mix(px, pr, pc, reg=1e-8)
    assert bool(p_ok) == bool(r_ok) == (case == "wrap")
    if case == "wrap":
        _close(p_mixed, r_mixed, atol=0.0, what="mixed iterate")


def test_mix_lands_the_fixed_point_of_an_affine_map():
    """Three pairs of an affine map in R² span its residuals, so the
    constrained solve gives the exact fixed point (as in the reference)."""
    a = torch.tensor([[0.9, 0.2], [0.0, 0.5]])
    b = torch.tensor([1.0, 1.0])
    xstar = np.linalg.solve(np.eye(2) - a.numpy(), b.numpy())
    xs, rs, cnt = PA.anderson_reset(3, 2, device=CPU)
    v = torch.zeros(2)
    for _ in range(3):
        tv = a @ v + b
        xs, rs, cnt = PA.anderson_push(xs, rs, cnt, v, tv - v)
        v = tv
    mixed, ok = PA.anderson_mix(xs, rs, cnt, reg=1e-10)
    assert bool(ok)
    np.testing.assert_allclose(mixed.numpy(), xstar, rtol=1e-3)


def _step_inputs(settle):
    """A scripted sequence of (c, tc, f_c, shift_sq) of an affine
    contraction with residuals in general position: warm-up, a step whose
    mix is used (unless the settle switch is on), a rejection, then steps
    after the cleared history."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    a = ((q * rng.uniform(0.5, 0.9, size=6)) @ q.T).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    c = rng.normal(size=(2, 3)).astype(np.float32)
    out = []
    for f in (100.0, 90.0, 1e6, 85.0, 80.0, 79.0):
        tc = (a @ c.reshape(-1) + b).reshape(2, 3).astype(np.float32)
        out.append((c, tc, np.float32(f),
                    np.float32(((tc - c) ** 2).sum())))
        c = tc
    return out, (np.float32(1e-12) if not settle else np.float32(10.0))


@pytest.mark.parametrize("settle", [False, True])
def test_anderson_step_matches_reference(settle):
    seq, tol = _step_inputs(settle)
    c0 = seq[0][0]
    rst = RA.anderson_state(jnp.asarray(c0), *RA.anderson_reset(4, 6)[:2])
    pst = PA.anderson_state(_t(c0), *PA.anderson_reset(4, 6, device=CPU)[:2])
    reg = np.float32(1e-8)
    codes = []
    for c, tc, f, sh in seq:
        rc, rst, rout = RA.anderson_step(
            jnp.asarray(c), jnp.asarray(tc), jnp.asarray(f), jnp.asarray(sh),
            rst, tol=jnp.asarray(tol), reg=jnp.asarray(reg))
        pc, pst, pout = PA.anderson_step(
            _t(c), _t(tc), torch.tensor(f), torch.tensor(sh), pst, tol=tol,
            reg=reg)
        assert int(pout) == int(rout)
        codes.append(int(pout))
        _close(pc, rc, what="c_next")
        for name in ("count", "stall", "n_acc", "n_rej", "n_fb", "mix_on"):
            assert int(getattr(pst, name)) == int(getattr(rst, name)), name
        for name in ("c_safe", "f_prev", "r_prev", "r_best", "xs", "rs"):
            _close(getattr(pst, name), getattr(rst, name), what=name)
    want = ([PA.OUTCOME_FALLBACK] * 2 if settle
            else [PA.OUTCOME_FALLBACK, PA.OUTCOME_ACCEPTED])
    assert codes[:2] == want
    assert codes[2] == PA.OUTCOME_REJECTED
    # The rejection rewound to the last plain output and cleared the ring.
    assert int(pst.n_rej) == 1


# ---------------------------------------------------------------------------
# The accelerated fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_beta_zero_is_plain_lloyd_bit_for_bit(cd):
    x, c0 = _problem(seed=1)
    k = c0.shape[0]
    kw = dict(init=c0, device=CPU, tol=1e-4, max_iter=50)
    cfg = KMeansConfig(k=k, update="matmul", compute_dtype=cd)
    acc = fit_lloyd_accelerated(x, k, config=cfg, accel="beta", beta_max=0.0,
                                **kw)
    plain = fit_lloyd(x, k, config=cfg, **kw)
    for name in ("centroids", "labels", "inertia", "n_iter", "converged",
                 "counts"):
        assert torch.equal(getattr(acc, name), getattr(plain, name)), name


#: (accel, update, beta_max, tol, blob spread, seed).  At β = 1 the beta
#: loop's end game is decided by rounding in either package: once the
#: labels freeze the iterate mirrors about the fixed point (c' = 2m − c) at
#: a constant shift, and only a rejection of an objective that is equal up
#: to the f32 sum's order ends it.  So β = 1 is held to the reference with a
#: tolerance that stops it first, and β ≤ 0.5 (a contraction) to 1e-3.
ACCEL_CASES = [
    ("beta", "auto", 1.0, 1e-1, 3.0, 3),       # one rejection on the way
    ("beta", "matmul", 0.5, 1e-3, 6.0, 0),
    ("anderson", "matmul", 1.0, 1e-3, 3.0, 0),  # accepts and a rejection
    ("anderson", "delta", 1.0, 1e-3, 2.0, 5),
    ("anderson", "auto", 1.0, 1e-3, 6.0, 1),
]


@pytest.mark.parametrize("accel,update,beta_max,tol,spread,seed",
                         ACCEL_CASES)
def test_accelerated_fit_matches_reference(accel, update, beta_max, tol,
                                           spread, seed, ref_counting):
    x, c0 = _problem(seed=seed, spread=spread)
    k = c0.shape[0]
    kw = dict(tol=tol, accel=accel, beta_max=beta_max)
    before = _tally(REF_ACCEL_STEPS), _tally(ACCEL_STEPS)
    port, diag = fit_lloyd_accelerated(
        x, k, init=c0, device=CPU, diag=True,
        config=KMeansConfig(k=k, update=update), **kw)
    ref = kmeans_tpu.fit_lloyd_accelerated(
        jnp.asarray(x), k, init=jnp.asarray(c0),
        config=RefConfig(k=k, update=update), **kw)
    assert int(port.n_iter) == int(ref.n_iter)
    assert bool(port.converged) and bool(ref.converged)
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    _close(port.centroids, ref.centroids, what="centroids")
    _close(port.inertia, ref.inertia, atol=0.0, what="inertia")
    assert len(diag["outcomes"]) == int(port.n_iter)
    if accel == "anderson":
        ref_delta = {o: _tally(REF_ACCEL_STEPS)[o] - before[0][o]
                     for o in OUTCOMES}
        port_delta = {o: _tally(ACCEL_STEPS)[o] - before[1][o]
                      for o in OUTCOMES}
        assert port_delta == ref_delta == {o: diag[o] for o in OUTCOMES}
        assert ref_delta["accepted"] >= 1      # the mixing was exercised


def test_inject_bad_step_rejects_exactly_once(ref_counting):
    x, c0 = _problem(seed=5)
    k = c0.shape[0]
    kw = dict(tol=1e-4, max_iter=60, accel="anderson")
    clean = fit_lloyd_accelerated(x, k, init=c0, device=CPU, **kw)
    before = _tally(REF_ACCEL_STEPS)
    drilled, diag = fit_lloyd_accelerated(x, k, init=c0, device=CPU,
                                          inject_bad_step=1, diag=True, **kw)
    ref = kmeans_tpu.fit_lloyd_accelerated(
        jnp.asarray(x), k, init=jnp.asarray(c0), inject_bad_step=1, **kw)
    assert diag["rejected"] == 1
    assert diag["outcomes"][2] == PA.OUTCOME_REJECTED
    assert _tally(REF_ACCEL_STEPS)["rejected"] - before["rejected"] == 1
    assert int(drilled.n_iter) == int(ref.n_iter)
    assert bool(drilled.converged)
    np.testing.assert_array_equal(drilled.labels.numpy(), clean.labels.numpy())
    _close(drilled.inertia, clean.inertia, atol=0.0)


def test_outcomes_cover_every_iteration_and_the_tally():
    x, c0 = _problem(seed=6, spread=2.0)
    k = c0.shape[0]
    before = _tally(ACCEL_STEPS)
    st, diag = fit_lloyd_accelerated(x, k, init=c0, device=CPU, tol=1e-6,
                                     max_iter=80, accel="anderson",
                                     diag=True)
    after = _tally(ACCEL_STEPS)
    assert sum(diag[o] for o in OUTCOMES) == int(st.n_iter)
    assert {o: after[o] - before[o] for o in OUTCOMES} == {
        o: diag[o] for o in OUTCOMES}
    assert diag["outcomes"][0] == PA.OUTCOME_FALLBACK   # warm-up is plain
    # The beta loop records nothing in the tally, as in the reference.
    fit_lloyd_accelerated(x, k, init=c0, device=CPU, accel="beta")
    assert _tally(ACCEL_STEPS) == after


def test_nested_accelerated_matches_reference():
    x, c0 = _problem(seed=7, n=4000, k=4)
    k = c0.shape[0]
    kw = dict(tol=1e-3, accel="anderson", schedule="nested")
    port = fit_lloyd_accelerated(x, k, init=c0, device=CPU,
                                 config=KMeansConfig(k=k, nested_start=256),
                                 **kw)
    ref = kmeans_tpu.fit_lloyd_accelerated(
        jnp.asarray(x), k, init=jnp.asarray(c0),
        config=RefConfig(k=k, nested_start=256), **kw)
    assert int(port.n_iter) == int(ref.n_iter)
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    _close(port.centroids, ref.centroids, what="centroids")


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(config=KMeansConfig(k=6, empty="farthest")), NotImplementedError,
     "farthest"),
    (dict(schedule="nested", weights=np.ones(800, np.float32)), ValueError,
     "nested"),
    (dict(accel="beta", inject_bad_step=2), ValueError, "inject_bad_step"),
    (dict(accel="anderson", anderson_m=1), ValueError, "anderson_m"),
    (dict(accel="anderson", anderson_m=65), ValueError, "anderson_m"),
    (dict(accel="momentum"), ValueError, "accel"),
    (dict(schedule="sometimes"), ValueError, "schedule"),
])
def test_refusals(kwargs, error, match):
    x, c0 = _problem()
    with pytest.raises(error, match=match):
        fit_lloyd_accelerated(x, 6, init=c0, device=CPU, **kwargs)


def test_entry_points_default_to_the_card():
    """With no card and no ``device="cpu"``, every new entry point raises
    instead of running on the CPU."""
    from kmeans_tpu_torch import MiniBatchKMeans, fit_minibatch, nested_ladder

    x, c0 = _problem(n=200)
    calls = [
        lambda: fit_lloyd_accelerated(x, 6, init=c0),
        lambda: fit_lloyd_accelerated(x, 6, init=c0, accel="anderson"),
        lambda: fit_minibatch(x, 6, init=c0, steps=2),
        lambda: nested_ladder(x, c0, tol=1e-4),
        lambda: MiniBatchKMeans(n_clusters=6, init=c0).fit(x),
        lambda: MiniBatchKMeans(n_clusters=6, init=c0).partial_fit(x),
        lambda: PA.anderson_reset(5, 12),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            "import kmeans_tpu_torch.ops.anderson\n"
            "import kmeans_tpu_torch.models.accelerated\n"
            "import kmeans_tpu_torch.models.minibatch\n"
            "import kmeans_tpu_torch.convert\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'kmeans_tpu.')) or m == 'kmeans_tpu')\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
