"""The port's DP×TP, DP×FP and DP×TP×FP bodies and the kernel hooks they run
on, against the JAX package, on the CPU.

The kernel hooks first: K1 in raw-score mode with ``valid_cols`` masking
padded columns, and K3's fold of given labels and scores, each against the
reference's Pallas kernels in interpret mode (``tests/test_pallas.py``
runs them so), untiled and on the tiled route (K5 / K6, ``k_tile``).  Then
the sharded fits on a gloo world of four CPU processes
(``tests/torch_mesh_worker.py``) against the single-device fit and the
reference's sharded fit on the conftest's CPU mesh of the same shape, as
``tests/test_parallel_pallas.py`` holds the reference's kernel bodies:
labels exactly (tie-free data; k = 5 divides neither 2 nor 4, so padded
k-slots are masked), centroids within 1e-4 (the reference's tolerance:
the merge sums in another order), inertia within rtol 1e-4.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_worker import run_world  # noqa: E402

from kmeans_tpu.config import KMeansConfig as RefConfig  # noqa: E402
from kmeans_tpu.models import fit_lloyd as ref_fit_lloyd  # noqa: E402
from kmeans_tpu.ops.pallas_lloyd import (accumulate_pallas,  # noqa: E402
                                         lloyd_pass_pallas)
from kmeans_tpu.parallel import engine as ref_engine  # noqa: E402
from kmeans_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from kmeans_tpu_torch.ops import cuda_lloyd as K  # noqa: E402

TOL = 1e-4
MAX_IT = 10


def _problem(seed=0, k=5, n=257, d=128):
    """The reference's problem (d = 128: its kernels' lane alignment)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(k, d)).astype(np.float32)
    lab = rng.integers(0, k, size=(n,))
    x = (centers[lab] + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    return x, x[:k].copy()


X, C0 = _problem()
# d = 130 pads to 132 over four feature ranks.
XD, CD = _problem(seed=4, d=130)


def _farthest_problem():
    """k = 4 over two blobs, two init centroids far off: empty slots."""
    rng = np.random.default_rng(3)
    centers = rng.uniform(-10, 10, size=(2, 128)).astype(np.float32)
    lab = rng.integers(0, 2, size=(200,))
    x = (centers[lab] + 0.3 * rng.normal(size=(200, 128))).astype(np.float32)
    return x, np.concatenate([centers, centers + 40.0]).astype(np.float32)


XF, CF = _farthest_problem()
# 598 centroids over four model ranks: slices of 150, the last with 148
# live columns, each slice two 128-column tiles on the tiled route.
CT = (X[np.arange(598) % 257] + 0.05 * np.random.default_rng(11).normal(
    size=(598, 128))).astype(np.float32)

#: name → (mesh shape, axis names, model_axis, feature_axis).
MESHES = {
    "tp 2x2": ((2, 2), ("data", "model"), "model", None),
    "tp 1x4": ((1, 4), ("data", "model"), "model", None),
    "fp 2x2": ((2, 2), ("data", "feature"), None, "feature"),
    "fp 1x4": ((1, 4), ("data", "feature"), None, "feature"),
    "tpfp 1x2x2": ((1, 2, 2), ("data", "model", "feature"), "model",
                   "feature"),
}


def _mesh_kw(name):
    shape, axes, model, feature = MESHES[name]
    kw = dict(mesh_shape=shape, mesh_axes=axes)
    if model:
        kw["model_axis"] = model
    if feature:
        kw["feature_axis"] = feature
    return kw


def _cases():
    cases = []
    for name in MESHES:
        cases.append((f"fit {name}", "fit", dict(
            x=X, k=5, init=C0, tol=1e-10, max_iter=MAX_IT, **_mesh_kw(name))))
    for name in ("fp 1x4", "tpfp 1x2x2"):
        cases.append((f"ragged d {name}", "fit", dict(
            x=XD, k=5, init=CD, tol=1e-10, max_iter=MAX_IT,
            **_mesh_kw(name))))
    for name in ("tp 2x2", "tp 1x4", "fp 2x2", "tpfp 1x2x2"):
        cases.append((f"farthest {name}", "fit", dict(
            x=XF, k=4, init=CF, tol=1e-10, max_iter=8,
            config=dict(k=4, empty="farthest"), **_mesh_kw(name))))
    for name in ("tp 2x2", "fp 2x2"):
        cases.append((f"seeded {name}", "fit", dict(
            x=X, k=5, tol=1e-10, max_iter=MAX_IT, config=dict(k=5, seed=3),
            **_mesh_kw(name))))
    cases.append(("tiled tp 1x4", "tp_tiled", dict(
        x=X, c=CT, mesh_shape=(1, 4))))
    cases.append(("runner tp", "runner", dict(
        x=X, k=4, init=C0[:4], tol=1e-10, max_iter=MAX_IT,
        model_axis="model", mesh_shape=(2, 2))))
    cases.append(("runner dp", "runner", dict(
        x=X, k=4, init=C0[:4], tol=1e-10, max_iter=MAX_IT,
        mesh_shape=(4, 1))))
    # The guards (raised on every rank before the first collective).
    for what, cfg in (("scatter", dict(comm="scatter")),
                      ("delta", dict(update="delta"))):
        cases.append((f"guard {what}", "fit", dict(
            x=X, k=5, init=C0, config=dict(k=5, **cfg),
            **_mesh_kw("tp 2x2"))))
    cases.append(("guard runner k", "runner", dict(
        x=X, k=5, init=C0, model_axis="model", mesh_shape=(2, 2))))
    return cases


@pytest.fixture(scope="module")
def world():
    return run_world(4, _cases())


@pytest.fixture(scope="module")
def single():
    """The reference's single-device fits the sharded ones are held to."""
    return {
        "blobs": ref_fit_lloyd(jnp.asarray(X), 5, init=jnp.asarray(C0),
                               tol=1e-10, max_iter=MAX_IT),
        "ragged": ref_fit_lloyd(jnp.asarray(XD), 5, init=jnp.asarray(CD),
                                tol=1e-10, max_iter=MAX_IT),
        "farthest": ref_fit_lloyd(
            jnp.asarray(XF), 4, init=jnp.asarray(CF),
            config=RefConfig(k=4, empty="farthest", tol=1e-10, max_iter=8)),
    }


def _ok(res):
    assert "error" not in res, res["error"]
    return res


def _assert_fit(got, want):
    _ok(got)
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    np.testing.assert_allclose(got["centroids"], np.asarray(want.centroids),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["inertia"], float(want.inertia),
                               rtol=TOL)
    assert got["n_iter"] == int(want.n_iter)
    np.testing.assert_allclose(got["counts"], np.asarray(want.counts))


# ---------------------------------------------------------------------------
# The kernel hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_tile", [None, 128])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_valid", [297, 1])
def test_k1_valid_cols_raw_scores_match_pallas(n_valid, cd, k_tile):
    """K1 in raw-score mode, the last columns masked (a TP slice's padding;
    ``n_valid=1``: one live column), untiled and on the tiled route:
    labels equal and raw scores ``min(||c||² − 2x·c)`` within rtol 1e-5
    of the reference's interpret-mode kernel."""
    x, _ = _problem(seed=7, k=300, n=517)
    c = _problem(seed=8, k=300, n=300)[0]
    valid = np.arange(300) < n_valid
    got = K.lloyd_pass_cuda(torch.from_numpy(x), torch.from_numpy(c),
                            valid_cols=torch.from_numpy(valid),
                            with_update=False, raw_scores=True,
                            compute_dtype=cd, k_tile=k_tile)
    want = lloyd_pass_pallas(jnp.asarray(x), jnp.asarray(c),
                             valid_cols=jnp.asarray(valid), with_update=False,
                             raw_scores=True, compute_dtype=cd,
                             interpret=True, k_tile=k_tile)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].numpy().max() < n_valid
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5,
                               atol=1e-5 * float(np.abs(want[1]).max()))


@pytest.mark.parametrize("k_tile", [None, 128])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_k3_given_scores_drops_other_slices_rows(cd, k_tile):
    """K3 on a TP slice: shard-relative labels (rows won elsewhere fall
    outside ``[0, k)`` and drop) and the resolved global scores, against
    ``accumulate_pallas``, untiled and on the tiled route."""
    x, _ = _problem(seed=9, k=5, n=400)
    rng = np.random.default_rng(10)
    lab_g = rng.integers(0, 12, size=400).astype(np.int32)
    rel = lab_g - 4                      # the slice [4, 8) of 12 columns
    scores = rng.normal(size=400).astype(np.float32) * 10
    w = (rng.random(400) > 0.2).astype(np.float32)
    got = K.accumulate_cuda(torch.from_numpy(x), torch.from_numpy(rel), 4,
                            scores=torch.from_numpy(scores),
                            weights=torch.from_numpy(w), compute_dtype=cd,
                            k_tile=k_tile)
    want = accumulate_pallas(jnp.asarray(x), jnp.asarray(rel), 4,
                             scores=jnp.asarray(scores),
                             weights=jnp.asarray(w), compute_dtype=cd,
                             interpret=True, k_tile=k_tile)
    for g, r in zip(got, want):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-4 * float(np.abs(r).max()))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# The sharded bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_body_matches_single_device(world, single, name):
    _assert_fit(world[f"fit {name}"], single["blobs"])


@pytest.mark.parametrize("name", ["tp 2x2", "fp 2x2", "tpfp 1x2x2"])
def test_sharded_body_matches_the_references(world, cpu_devices, name):
    """Against the reference's sharded fit on its CPU mesh of the same
    shape (its XLA bodies)."""
    shape, axes, model, feature = MESHES[name]
    mesh = ref_make_mesh(shape, axes, devices=cpu_devices[:4])
    want = ref_engine.fit_lloyd_sharded(
        X, 5, mesh=mesh, init=C0, tol=1e-10, max_iter=MAX_IT,
        model_axis=model, feature_axis=feature)
    _assert_fit(world[f"fit {name}"], want)


@pytest.mark.parametrize("name", ["fp 1x4", "tpfp 1x2x2"])
def test_feature_padding_is_exact(world, single, name):
    """d = 130 over four feature ranks: two zero columns pad the last
    slice and are cut from the result."""
    got = _ok(world[f"ragged d {name}"])
    assert got["centroids"].shape == (5, 130)
    _assert_fit(got, single["ragged"])


@pytest.mark.parametrize("name", ["tp 2x2", "tp 1x4", "fp 2x2",
                                  "tpfp 1x2x2"])
def test_farthest_reseed_matches_single_device(world, single, name):
    """Empty slots healed across slices: the r-th empty slot (in global
    k order over the model ranks) takes the r-th ranked worst row."""
    got = world[f"farthest {name}"]
    _assert_fit(got, single["farthest"])
    assert np.all(got["counts"] > 0)


@pytest.mark.parametrize("name", ["tp 2x2", "fp 2x2"])
def test_seeded_sharded_fit_is_the_single_device_fit(world, name):
    """k-means++ on a TP or FP mesh seeds over the row blocks (data ×
    feature, after the exchange): the port's single-device seeding from the
    same seed, so the same fit."""
    from kmeans_tpu_torch import KMeansConfig, fit_lloyd

    got = _ok(world[f"seeded {name}"])
    want = fit_lloyd(X, 5, config=KMeansConfig(k=5, seed=3,
                                               update="matmul"),
                     tol=1e-10, max_iter=MAX_IT, device="cpu")
    np.testing.assert_array_equal(got["labels"], want.labels.numpy())
    np.testing.assert_allclose(got["centroids"], want.centroids.numpy(),
                               rtol=TOL, atol=TOL)


def test_tiled_tp_body_is_the_untiled_one(world):
    """The TP body on the tiled route (K5 / K6 with ``valid_cols``, their
    plain versions here) gives the untiled route's labels, counts and
    inertia, and sums within rtol 1e-5."""
    got = _ok(world["tiled tp 1x4"])
    np.testing.assert_array_equal(got["labels"][0], got["labels"][1])
    np.testing.assert_array_equal(got["counts"][0], got["counts"][1])
    np.testing.assert_allclose(got["centroids"][0], got["centroids"][1],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["inertia"][0], got["inertia"][1],
                               rtol=1e-5)


def test_runner_model_axis_matches_the_dp_runner(world):
    """``LloydRunner(model_axis=)`` steps the TP body: the DP runner's
    fit; k % model must be 0, as in the reference."""
    tp = _ok(world["runner tp"])
    dp = _ok(world["runner dp"])
    np.testing.assert_array_equal(tp["labels"], dp["labels"])
    np.testing.assert_allclose(tp["centroids"], dp["centroids"], rtol=TOL,
                               atol=TOL)
    assert tp["n_iter"] == dp["n_iter"]
    assert "k % model axis == 0" in world["guard runner k"]["error"]


@pytest.mark.parametrize("what,cfg", [
    ("scatter", dict(comm="scatter")), ("delta", dict(update="delta"))])
def test_guards_print_the_reference_line(world, cpu_devices, what, cfg):
    mesh = ref_make_mesh((2, 2), ("data", "model"), devices=cpu_devices[:4])
    with pytest.raises(ValueError) as e:
        ref_engine.fit_lloyd_sharded(X, 5, mesh=mesh, init=C0,
                                     model_axis="model",
                                     config=RefConfig(k=5, **cfg))
    assert world[f"guard {what}"]["error"] == f"ValueError: {e.value}"
