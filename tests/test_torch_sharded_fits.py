"""The port's sharded accelerated, trimmed, streamed and spherical fits
against the JAX package's, on the CPU, the families that run their inner
fits on the mesh (bisecting, x-means, g-means, and ``cli train --mesh``
for the four of them, the soft families and the pairwise ones: the
k-medoids and kernel ring passes and the sharded spectral fit), the
sharded soft, balanced and projected fits (fuzzy, GMM, balanced, PCA and
the streamed GMM), and the placement that keeps each rank to its rows.

One gloo world of four CPU processes (``tests/torch_mesh_worker.py``) runs
every case once (dp 4: every problem's rows pad, and the trimmed budget
exceeds a rank's rows); the reference runs on the conftest's virtual CPU
mesh of the same dp, from the same numpy inputs and an explicit c0.  Labels,
outlier masks and iteration counts must be equal (the data is tie-free
blobs, or ties exactly where a test pins the lowest-index rule); centroids,
counts and inertia agree to RTOL / ATOL (1e-5), the two packages summing
the same f32 terms in other orders.  The spherical fits run the sphere
update on DP (delta and dense, allreduce and scatter), FP (mesh (2, 1, 2):
each rank's sums are full width, so the norm needs no collective) and TP
(mesh (2, 2)); every centroid's norm is 1 within 1e-6.  The mesh families
are held to the port's single-device fit from the same seed (the sharded
seeding draws what one device draws), their inertia also to
``INERTIA_ATOL_REL`` of Σ‖x‖² (each row's expanded distance rounds at
‖x‖²'s scale).  The soft and balanced fits are held to the reference's
sharded fit of the same dp and to the port's single-device fit: labels
and ``n_iter`` equal, floats to SOFT_RTOL / SOFT_ATOL (1e-4: EM and the
Sinkhorn sweeps carry the f32 sum order's differences through every
iteration); PCA components up to a per-row sign (1e-4).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_worker import run_world  # noqa: E402

from kmeans_tpu.config import KMeansConfig as RefConfig  # noqa: E402
from kmeans_tpu.data import make_blobs as ref_make_blobs  # noqa: E402
from kmeans_tpu.models.streaming import \
    fit_minibatch_stream as ref_fit_stream  # noqa: E402
from kmeans_tpu.parallel import engine as ref_engine  # noqa: E402
from kmeans_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch.parallel import engine as port_engine  # noqa: E402

RTOL = 1e-5
ATOL = 1e-5
INERTIA_ATOL_REL = 1e-6
DPS = (4,)
MAX_ITER = 25
SOFT_RTOL = 1e-4
SOFT_ATOL = 1e-4
SPECTRAL_INERTIA_ATOL = 1e-4


def _blobs(seed, n, d, k, std=0.5, spread=3.0):
    rng = np.random.default_rng(seed)
    centres = (rng.normal(size=(k, d)) * spread).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    return (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


# n = 1001 is uneven for dp 4 (the padding rows).
X = _blobs(0, 1001, 16, 5)
C0 = X[:5].copy()
W_FRAC = np.random.default_rng(2).uniform(0.5, 2.0, 1001).astype(np.float32)
# The reference's trimmed tie case (``tests/test_trimmed.py``, its data):
# exact duplicate far rows, so the trim threshold has real ties and only
# the lowest indices may be trimmed.
XT = np.array(ref_make_blobs(jax.random.key(21), 331, 6, 4,
                             cluster_std=0.5)[0])
XT[7] = XT[130] = XT[260] = 300.0
CT = XT[:4].copy()
# m = 40 larger than a rank's rows (97 rows: 25 a rank at dp 4), weighted.
XB = np.random.default_rng(5).normal(size=(97, 4)).astype(np.float32)
WB = np.random.default_rng(5).uniform(0.5, 1.5, 97).astype(np.float32)
# Empty slots under trimming: two init centroids on one row.
XE = _blobs(3, 401, 8, 4)
CE = np.stack([XE[0], XE[0], XE[1], XE[2]]).astype(np.float32)
# The streamed fit: 4003 rows, batches of 250 (248 on dp 4: the rounding).
XS = _blobs(13, 4003, 10, 5, std=0.3)
CS = XS[:5].copy()
STREAM_KW = dict(batch_size=250, steps=40, seed=3)


def _directions(seed, n, d, k, spread=0.15):
    """Rows around k unit directions with random magnitudes: the spherical
    family's data."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(k, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    lab = rng.integers(0, k, size=n)
    x = (dirs[lab] + spread * rng.normal(size=(n, d))) * rng.uniform(
        0.5, 20.0, size=(n, 1))
    return x.astype(np.float32)


# d = 15 pads to 16 columns on the feature axis of 2.
XSP = _directions(15, 1001, 15, 5)
CSP = XSP[:5].copy()
#: The sphere cases: name → (mesh kwargs, fit kwargs).
SPHERE = {
    "dp": ({}, {}),
    "dp matmul": ({}, dict(config=dict(k=5, update="matmul"))),
    "dp scatter": ({}, dict(config=dict(k=5, comm="scatter"))),
    "fp": (dict(mesh_shape=(2, 1, 2), mesh_axes=("data", "model",
                                                 "feature")),
           dict(feature_axis="feature")),
    "tp": (dict(mesh_shape=(2, 2), mesh_axes=("data", "model")),
           dict(model_axis="model")),
}
# The auto-k and bisecting families on the mesh: separated blobs.
XA = _blobs(17, 1001, 6, 4, std=0.4, spread=6.0)
FAMILIES = {"bisecting": (5, dict(k=5, seed=3)),
            "xmeans": (8, dict(k=1, seed=3)),
            "gmeans": (8, dict(k=1, seed=3))}
#: ``cli train`` on the world (``--mesh 4``) against one device.
CLI_BASE = ["train", "--n", "1500", "--d", "6", "--seed", "2", "--device",
            "cpu", "--max-iter", "30"]
CLI_FAMILIES = {"spherical": "4", "bisecting": "4", "xmeans": "8",
                "gmeans": "8", "fuzzy": "4", "gmm": "4", "kmedoids": "4",
                "kernel": "4"}
# The soft and balanced families: unequal blobs (balancing moves rows),
# n = 1001 uneven for dp 4, a third of the weights 0 in one case.
XSB = _blobs(19, 1001, 6, 4, std=0.6, spread=4.0)
CSB = XSB[:4].copy()
WZ = np.ones(1001, np.float32)
WZ[4::3] = 0.0
#: name → (family, fit kwargs), each run on the world and held to the
#: reference's sharded fit and to the port's single-device one.
SOFT = {
    "fuzzy": ("fuzzy", dict(tol=1e-8, max_iter=10)),
    "fuzzy weighted": ("fuzzy", dict(tol=1e-8, max_iter=10,
                                     weights=W_FRAC)),
    "gmm diag": ("gmm", dict(tol=1e-3, max_iter=10)),
    "gmm tied": ("gmm", dict(tol=1e-3, max_iter=10,
                             covariance_type="tied")),
    "balanced": ("balanced", dict(tol=1e-6, max_iter=4, sinkhorn_sweeps=10)),
    "balanced zero weights": ("balanced", dict(
        tol=1e-6, max_iter=4, sinkhorn_sweeps=10, weights=WZ)),
}
#: The accelerated cases: name → (accel, beta_max, tol).  At β = 1 the beta
#: loop's end is decided by a rounding rise of the objective, which two
#: packages summing in other orders reach at other sweeps
#: (``tests/test_torch_accel.py``'s cases say why), so β = 1 runs to a
#: tolerance that stops it first and β = 0.5 (a contraction) to 1e-3, as
#: there.
ACCEL = {"beta": ("beta", 1.0, 1e-1), "beta half": ("beta", 0.5, 1e-3),
         "anderson": ("anderson", 1.0, 1e-3)}


@pytest.fixture(scope="module")
def stream_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream") / "xs.npy")
    np.save(path, XS)
    return path


def _cases(stream_path, tmp):
    cases = []
    for name, (accel, beta_max, tol) in ACCEL.items():
        cases.append((f"accel {name}", "accel", dict(
            x=X, k=5, init=C0, tol=tol, max_iter=MAX_ITER, accel=accel,
            beta_max=beta_max)))
    cases.append(("accel weighted", "accel", dict(
        x=X, k=5, init=C0, tol=1e-3, max_iter=MAX_ITER, weights=W_FRAC,
        beta_max=0.5, config=dict(k=5, compute_dtype="float32"))))
    cases.append(("accel seeded", "accel", dict(
        x=X, k=5, tol=1e-3, max_iter=MAX_ITER,
        config=dict(k=5, seed=4, accel="anderson"))))
    for name, cfg in (("nested", dict(schedule="nested")),
                      ("farthest", dict(empty="farthest")),
                      ("accel", dict())):
        cases.append((f"accel guard {name}", "accel", dict(
            x=X, k=5, init=C0, config=dict(k=5, **cfg),
            **({"accel": "momentum"} if name == "accel" else {}))))
    tkw = dict(tol=1e-10, config=dict(k=4, init="given", chunk_size=64))
    cases.append(("trimmed ties", "trimmed", dict(
        x=XT, k=4, n_trim=2, init=CT, max_iter=MAX_ITER, **tkw)))
    cases.append(("trimmed big m", "trimmed", dict(
        x=XB, k=3, n_trim=40, init=XB[:3].copy(), weights=WB, max_iter=15,
        tol=1e-10, config=dict(k=3, init="given", chunk_size=32))))
    cases.append(("trimmed zero", "trimmed", dict(
        x=XB, k=3, n_trim=0, init=XB[:3].copy(), max_iter=10, tol=1e-10,
        config=dict(k=3, init="given", chunk_size=32))))
    cases.append(("trimmed farthest", "trimmed", dict(
        x=XE, k=4, trim_fraction=0.05, init=CE, max_iter=MAX_ITER,
        tol=1e-10, config=dict(k=4, empty="farthest"))))
    cases.append(("stream", "stream", dict(
        path=stream_path, k=5, init=CS, **STREAM_KW)))
    ck = os.path.join(tmp, "stream-ck")
    cases.append(("stream ckpt", "stream", dict(
        path=stream_path, k=5, init=CS, checkpoint_path=ck,
        checkpoint_every=10, **STREAM_KW)))
    # SIGTERM on rank 0 alone, at its 12th batch read: every rank stops
    # at one step, and the resumed run is the uninterrupted one.
    cases.append(("stream preempted", "stream", dict(
        path=stream_path, k=5, init=CS, checkpoint_path=ck + "-cut",
        checkpoint_every=10, fault="stream.read:sigterm@12", fault_rank=0,
        **STREAM_KW)))
    cases.append(("stream resumed", "stream", dict(
        path=stream_path, k=5, checkpoint_path=ck + "-cut",
        checkpoint_every=10, resume=True, **STREAM_KW)))
    cases.append(("block storage", "block_storage", dict(x=X)))
    for name, (mesh_kw, kw) in SPHERE.items():
        cases.append((f"sphere {name}", "sphere", dict(
            x=XSP, k=5, init=CSP, tol=1e-10, max_iter=MAX_ITER, **mesh_kw,
            **kw)))
    for family, (k, cfg) in FAMILIES.items():
        cases.append((f"{family} mesh", "family", dict(
            family=family, x=XA, k=k, config=cfg)))
    for name, (family, kw) in SOFT.items():
        cases.append((f"soft {name}", "soft", dict(
            family=family, x=XSB, k=4, init=CSB,
            config=dict(k=4, chunk_size=128), **kw)))
    cases.append(("pca", "pca", dict(x=X + 50.0, n_components=4,
                                     whiten=True, chunk_size=96)))
    cases.append(("gmm stream", "gmm_stream", dict(
        path=stream_path, k=5, init=CS, config=dict(k=5, chunk_size=512),
        **STREAM_KW)))
    for family, k in dict(CLI_FAMILIES, spectral="4").items():
        cases.append((f"cli {family}", "cli", dict(argv=CLI_BASE + [
            "--model", family, "--k", k, "--mesh", str(DPS[0])])))
    return cases


@pytest.fixture(scope="module")
def worlds(stream_file, tmp_path_factory):
    out = {}
    for dp in DPS:
        tmp = str(tmp_path_factory.mktemp(f"dp{dp}"))
        out[dp] = run_world(dp, _cases(stream_file, tmp))
        out[dp]["tmp"] = tmp
    return out


@pytest.fixture(scope="module")
def ref_meshes(cpu_devices):
    return {dp: ref_make_mesh((dp, 1), ("data", "model"),
                              devices=cpu_devices[:dp]) for dp in (2, 4)}


def _ok(res):
    assert "error" not in res, res["error"]
    return res


def _assert_state(got, want, labels=True):
    _ok(got)
    if labels:
        np.testing.assert_array_equal(got["labels"],
                                      np.asarray(want.labels))
    np.testing.assert_allclose(got["centroids"], np.asarray(want.centroids),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["counts"], np.asarray(want.counts),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["inertia"], float(want.inertia),
                               rtol=RTOL)
    assert got["n_iter"] == int(want.n_iter)
    assert got["converged"] == bool(want.converged)


# ---------------------------------------------------------------------------
# (a) the accelerated fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name", list(ACCEL))
def test_accelerated_matches_the_reference(worlds, ref_meshes, dp, name):
    """β and Anderson on the mesh against the reference's sharded loop of
    the same dp: the same iterations, accept / reject path and result."""
    accel, beta_max, tol = ACCEL[name]
    want = ref_engine.fit_lloyd_accelerated_sharded(
        X, 5, mesh=ref_meshes[dp], init=C0, tol=tol, max_iter=MAX_ITER,
        accel=accel, beta_max=beta_max)
    _assert_state(worlds[dp][f"accel {name}"], want)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name", list(ACCEL))
def test_accelerated_is_the_single_device_fit(worlds, dp, name):
    """The mesh runs the single-device loop's own iterations on merged
    sweeps: the port's ``fit_lloyd_accelerated`` (dense sweeps) from the
    same c0 gives the same labels and iterations."""
    accel, beta_max, tol = ACCEL[name]
    got = _ok(worlds[dp][f"accel {name}"])
    want = kt.fit_lloyd_accelerated(
        X, 5, init=C0, tol=tol, max_iter=MAX_ITER, accel=accel,
        beta_max=beta_max, device="cpu",
        config=kt.KMeansConfig(k=5, update="matmul"))
    np.testing.assert_array_equal(got["labels"], want.labels.numpy())
    np.testing.assert_allclose(got["centroids"], want.centroids.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert got["n_iter"] == int(want.n_iter)


@pytest.mark.parametrize("dp", DPS)
def test_accelerated_weighted_and_seeded(worlds, ref_meshes, dp):
    """Fractional weights in f32 (the dense update demoted to the segment
    reduction), and k-means++ from ``config.seed``: the single-device
    port's seeding (a ``torch.Generator``'s draws) gives the same fit."""
    want = ref_engine.fit_lloyd_accelerated_sharded(
        X, 5, mesh=ref_meshes[dp], init=C0, tol=1e-3, max_iter=MAX_ITER,
        weights=W_FRAC, beta_max=0.5,
        config=RefConfig(k=5, compute_dtype="float32"))
    _assert_state(worlds[dp]["accel weighted"], want)
    got = _ok(worlds[dp]["accel seeded"])
    one = kt.fit_lloyd_accelerated(
        X, 5, tol=1e-3, max_iter=MAX_ITER, device="cpu",
        config=kt.KMeansConfig(k=5, seed=4, accel="anderson",
                               update="matmul"))
    np.testing.assert_array_equal(got["labels"], one.labels.numpy())
    assert got["n_iter"] == int(one.n_iter)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("case,kw", [
    ("nested", dict(config=dict(schedule="nested"))),
    ("farthest", dict(config=dict(empty="farthest"))),
    ("accel", dict(accel="momentum"))])
def test_accelerated_guards_print_the_reference_line(worlds, ref_meshes, dp,
                                                     case, kw):
    kw = dict(kw)
    cfg = RefConfig(k=5, **kw.pop("config", {}))
    with pytest.raises((ValueError, NotImplementedError)) as e:
        ref_engine.fit_lloyd_accelerated_sharded(
            X, 5, mesh=ref_meshes[dp], init=C0, config=cfg, **kw)
    assert worlds[dp][f"accel guard {case}"]["error"] == \
        f"{type(e.value).__name__}: {e.value}"


# ---------------------------------------------------------------------------
# (b) the trimmed fit
# ---------------------------------------------------------------------------

def _assert_trimmed(got, want):
    _ok(got)
    np.testing.assert_array_equal(got["outlier_mask"],
                                  np.asarray(want.outlier_mask))
    _assert_state(got, want)


@pytest.mark.parametrize("dp", DPS)
def test_trimmed_ties_match_the_reference(worlds, ref_meshes, dp):
    """Three equal far rows and a budget of two: the two lowest global
    indices are trimmed (rows 7 and 130, on different ranks), as
    the reference's sharded selection and one device's ``lax.top_k``
    order them."""
    cfg = RefConfig(k=4, init="given", chunk_size=64)
    want = ref_engine.fit_trimmed_sharded(
        XT, 4, mesh=ref_meshes[dp], n_trim=2, init=CT, tol=1e-10,
        max_iter=MAX_ITER, config=cfg)
    got = worlds[dp]["trimmed ties"]
    _assert_trimmed(got, want)
    mask = got["outlier_mask"]
    assert mask[7] and mask[130] and not mask[260]
    one = kt.fit_trimmed(XT, 4, n_trim=2, init=CT, tol=1e-10,
                         max_iter=MAX_ITER, device="cpu",
                         config=kt.KMeansConfig(k=4, init="given",
                                                chunk_size=64))
    np.testing.assert_array_equal(mask, one.outlier_mask.numpy())
    np.testing.assert_array_equal(got["labels"], one.labels.numpy())


@pytest.mark.parametrize("dp", DPS)
def test_trimmed_big_m_weights_match_the_reference(worlds, ref_meshes, dp):
    """m = 40 above a rank's 25 rows: ``m_loc`` is the rank's rows, and
    the weights ride the correction."""
    want = ref_engine.fit_trimmed_sharded(
        XB, 3, mesh=ref_meshes[dp], n_trim=40, init=XB[:3].copy(),
        weights=WB, tol=1e-10, max_iter=15,
        config=RefConfig(k=3, init="given", chunk_size=32))
    _assert_trimmed(worlds[dp]["trimmed big m"], want)


@pytest.mark.parametrize("dp", DPS)
def test_trimmed_zero_and_farthest_match_the_reference(worlds, ref_meshes,
                                                       dp):
    """``n_trim=0`` is the plain sharded fit with an all-false mask; under
    ``empty="farthest"`` an empty slot takes the worst inlier."""
    got = _ok(worlds[dp]["trimmed zero"])
    want = ref_engine.fit_trimmed_sharded(
        XB, 3, mesh=ref_meshes[dp], n_trim=0, init=XB[:3].copy(),
        tol=1e-10, max_iter=10,
        config=RefConfig(k=3, init="given", chunk_size=32))
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    assert not got["outlier_mask"].any()
    want = ref_engine.fit_trimmed_sharded(
        XE, 4, mesh=ref_meshes[dp], trim_fraction=0.05, init=CE, tol=1e-10,
        max_iter=MAX_ITER, config=RefConfig(k=4, empty="farthest"))
    got = worlds[dp]["trimmed farthest"]
    _assert_trimmed(got, want)
    assert np.all(got["counts"] > 0)


# ---------------------------------------------------------------------------
# (c) the streamed sharded step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", DPS)
def test_stream_matches_the_reference(worlds, ref_meshes, dp, stream_file):
    """Each rank gathers its contiguous slice of every step's sorted index
    list; one all-reduce merges the slices' stats: the reference's sharded
    step on the same batches (250 rows rounded to 248), and its final
    pass."""
    want = ref_fit_stream(np.load(stream_file, mmap_mode="r"), 5,
                          init=jnp.asarray(CS), mesh=ref_meshes[dp],
                          **STREAM_KW)
    _assert_state(worlds[dp]["stream"], want)


@pytest.mark.parametrize("dp", DPS)
def test_stream_checkpoint_is_the_references(worlds, ref_meshes, dp,
                                             stream_file):
    """Rank 0 alone writes the bundle; ``mesh_dp`` records dp, the
    reference's loader reads it, and a resume on another dp is refused
    by both packages with the same line."""
    from kmeans_tpu.utils.checkpoint import load_array_checkpoint

    got = _ok(worlds[dp]["stream ckpt"])
    _assert_state(got, _as_state(worlds[dp]["stream"]))
    ck = os.path.join(worlds[dp]["tmp"], "stream-ck")
    arrays, meta = load_array_checkpoint(ck)
    assert meta["extra"]["mesh_dp"] == dp and int(arrays["n_iter"]) == 40
    np.testing.assert_array_equal(arrays["centroids"], got["centroids"])
    other = 2
    with pytest.raises(ValueError) as ref_e:
        ref_fit_stream(np.load(stream_file, mmap_mode="r"), 5,
                       mesh=ref_meshes[other], checkpoint_path=ck,
                       resume=True, **STREAM_KW)
    assert f"({dp})" in str(ref_e.value)


def _as_state(res):
    from types import SimpleNamespace

    return SimpleNamespace(**_ok(res))


@pytest.mark.parametrize("dp", DPS)
def test_stream_signal_on_one_rank_stops_all(worlds, dp):
    """SIGTERM reaches rank 0 alone: its flag rides the next all-reduce,
    every rank stops at the same step (the world ends; a rank left behind
    would wait in a collective), rank 0's bundle is at that step, and the
    resume finishes bit for bit as the uninterrupted fit."""
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    cut = worlds[dp]["stream preempted"]
    assert "preempted" in cut, cut
    step = cut["preempted"]
    assert 0 < step < STREAM_KW["steps"]
    ck = os.path.join(worlds[dp]["tmp"], "stream-ck-cut")
    assert latest_step(ck) is not None
    whole = _ok(worlds[dp]["stream"])
    got = _ok(worlds[dp]["stream resumed"])
    np.testing.assert_array_equal(got["centroids"], whole["centroids"])
    np.testing.assert_array_equal(got["labels"], whole["labels"])
    assert got["n_iter"] == STREAM_KW["steps"]


@pytest.mark.parametrize("dp", [2, 4])
def test_stream_rank_slices_are_the_batch(dp, stream_file):
    """``sample_batches(part=(r, p))``: the p slices of a step, in rank
    order, are the whole batch."""
    from kmeans_tpu_torch.data.stream import sample_batches

    data = np.load(stream_file, mmap_mode="r")
    whole = list(sample_batches(data, 248, 3, seed=3))
    parts = [list(sample_batches(data, 248, 3, seed=3, part=(r, dp)))
             for r in range(dp)]
    for step in range(3):
        torch.testing.assert_close(
            torch.cat([p[step] for p in parts]), whole[step], rtol=0,
            atol=0)
    with pytest.raises(ValueError, match="part"):
        next(sample_batches(data, 250, 3, part=(0, 4)))


# ---------------------------------------------------------------------------
# Placement: each rank keeps its own rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor", "view"])
def test_row_block_owns_its_rows(kind):
    """A rank's block is a copy of its rows, never a view that keeps all
    of ``x`` alive: its storage is n_loc rows, for numpy input, a host
    tensor and a view of a larger tensor on the block's device (on the
    card, a card tensor: ``tests/test_torch_cuda.py`` holds that case)."""
    x = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    xin = {"numpy": x, "tensor": torch.from_numpy(x),
           "view": torch.from_numpy(np.concatenate([x, x]))[:40]}[kind]
    for rank in range(4):
        block = port_engine._row_block(xin, 40, 11, rank, "cpu")
        assert block.untyped_storage().nbytes() == 11 * 3 * 4
        np.testing.assert_array_equal(block[:min(11, 40 - 11 * rank)],
                                      x[11 * rank:11 * rank + 11])


@pytest.mark.parametrize("dp", DPS)
def test_placed_blocks_own_their_rows(worlds, dp):
    """The same through ``_place`` on every rank of the world."""
    for rows_bytes, storage in worlds[dp]["block storage"]:
        assert storage == rows_bytes


def test_package_surface_has_the_new_fits():
    import kmeans_tpu_torch.parallel as p

    for name in ("fit_lloyd_accelerated_sharded", "fit_trimmed_sharded",
                 "fit_spherical_sharded"):
        assert hasattr(p, name), name
    assert port_engine.ENGINE_CKPT_EVERY == ref_engine.ENGINE_CKPT_EVERY


# ---------------------------------------------------------------------------
# (d) the sphere update and the families that fit on the mesh
# ---------------------------------------------------------------------------

def _ref_sphere_mesh(cpu_devices, name, dp):
    shape, axes = {"fp": ((2, 1, 2), ("data", "model", "feature")),
                   "tp": ((2, 2), ("data", "model"))}.get(
                       name, ((dp, 1), ("data", "model")))
    return ref_make_mesh(shape, axes, devices=cpu_devices[:dp])


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name", list(SPHERE))
def test_sphere_update_matches_the_reference(worlds, cpu_devices, dp, name):
    """``fit_spherical_sharded`` on every layout against the reference's:
    the same labels and iterations, unit-norm centroids."""
    mesh_kw, kw = SPHERE[name]
    kw = dict(kw)
    cfg = kw.pop("config", None)
    want = ref_engine.fit_spherical_sharded(
        XSP, 5, mesh=_ref_sphere_mesh(cpu_devices, name, dp), init=CSP,
        tol=1e-10, max_iter=MAX_ITER,
        config=None if cfg is None else RefConfig(**cfg), **kw)
    got = worlds[dp][f"sphere {name}"]
    _assert_state(got, want)
    np.testing.assert_allclose(np.linalg.norm(got["centroids"], axis=1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("dp", DPS)
def test_sphere_dense_mesh_is_the_single_device_fit(worlds, dp):
    """The dense sphere sweep on the mesh runs ``fit_spherical``'s
    iterations: the same labels and centroids from the same init."""
    got = _ok(worlds[dp]["sphere dp matmul"])
    want = kt.fit_spherical(XSP, 5, init=CSP, tol=1e-10, max_iter=MAX_ITER,
                            device="cpu")
    np.testing.assert_array_equal(got["labels"], want.labels.numpy())
    np.testing.assert_allclose(got["centroids"], want.centroids.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert got["n_iter"] == int(want.n_iter)


def _inertia_close(got, want, x):
    atol = INERTIA_ATOL_REL * float((np.asarray(x, np.float64) ** 2).sum())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_families_on_the_mesh_are_the_single_device_fits(worlds, dp,
                                                         family):
    """Bisecting, x-means and g-means with ``mesh``: every inner fit on the
    engine (the split masks admitted as binary weights), the same splits,
    discovered k and labels as one device's fit from the same seed."""
    import kmeans_tpu_torch.models as models

    k, cfg = FAMILIES[family]
    got = _ok(worlds[dp][f"{family} mesh"])
    want = getattr(models, f"fit_{family}")(
        XA, k, config=kt.KMeansConfig(**cfg), device="cpu")
    np.testing.assert_array_equal(got["labels"], want.labels.numpy())
    assert got["centroids"].shape == tuple(want.centroids.shape)
    np.testing.assert_allclose(got["centroids"], want.centroids.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["counts"], want.counts.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert got["n_iter"] == int(want.n_iter)
    assert got["converged"] == bool(want.converged)
    _inertia_close(got["inertia"], float(want.inertia), XA)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("family", list(CLI_FAMILIES))
def test_train_mesh_families_print_the_one_device_line(worlds, dp, family,
                                                       capsys):
    """``cli train --model F --mesh N`` joined to the world: rank 0 prints
    one result line, the ``--mesh 1`` line's fields (the discovered k for
    x-means and g-means) plus ``mesh``."""
    from kmeans_tpu_torch import cli as port_cli

    res = _ok(worlds[dp][f"cli {family}"])
    assert res["rc"] == 0, res["err"]
    two = json.loads(res["out"].strip().splitlines()[-1])
    argv = CLI_BASE + ["--model", family, "--k", CLI_FAMILIES[family]]
    assert port_cli.main(argv) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert two["mesh"] == dp and "mesh" not in one
    same = ("n", "d", "k", "n_iter", "mode", "converged")
    assert {f: two[f] for f in same} == {f: one[f] for f in same}
    assert sorted(set(two) - {"mesh"}) == sorted(one)
    np.testing.assert_allclose(two["inertia"], one["inertia"], rtol=1e-5)


@pytest.mark.parametrize("dp", DPS)
def test_train_mesh_spectral_prints_the_one_device_line(worlds, dp, capsys):
    """``cli train --model spectral --mesh N``: the sharded embedding (its
    two landmark-sized all-reduces) and the engine's k-means print the
    ``--mesh 1`` line.  The embedding-space inertia of four separated
    blobs is near 0 (each blob collapses to one point of the embedding),
    where the all-reduces' f32 order moves it in absolute terms: held to
    SPECTRAL_INERTIA_ATOL (1e-4, on 1500 unit-norm rows)."""
    from kmeans_tpu_torch import cli as port_cli

    res = _ok(worlds[dp]["cli spectral"])
    assert res["rc"] == 0, res["err"]
    two = json.loads(res["out"].strip().splitlines()[-1])
    assert port_cli.main(CLI_BASE + ["--model", "spectral", "--k", "4"]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert two["mesh"] == dp and "mesh" not in one
    same = ("n", "d", "k", "n_iter", "mode", "converged")
    assert {f: two[f] for f in same} == {f: one[f] for f in same}
    assert sorted(set(two) - {"mesh"}) == sorted(one)
    np.testing.assert_allclose(two["inertia"], one["inertia"],
                               atol=SPECTRAL_INERTIA_ATOL)


# ---------------------------------------------------------------------------
# (e) the soft, balanced and projected fits
# ---------------------------------------------------------------------------

def _soft_fits(name, dp, ref_mesh):
    """``(reference sharded fit, port single-device fit)`` of a SOFT case."""
    import kmeans_tpu_torch.models as models

    family, kw = SOFT[name]
    kw = dict(kw)
    w = kw.pop("weights", None)
    ref = getattr(ref_engine, f"fit_{family}_sharded")(
        XSB, 4, mesh=ref_mesh, init=CSB, weights=w,
        config=RefConfig(k=4, chunk_size=128), **kw)
    one = getattr(models, f"fit_{family}")(
        XSB, 4, init=CSB, weights=w, device="cpu",
        config=kt.KMeansConfig(k=4, chunk_size=128), **kw)
    return ref, one


def _soft_same(got, want, what):
    for name, v in got.items():
        if name in ("all_reduces",):
            continue
        w = want[name] if isinstance(want, dict) else getattr(want, name)
        w = np.asarray(w.numpy() if isinstance(w, torch.Tensor) else w)
        if name == "labels" or w.dtype.kind in "iub":
            np.testing.assert_array_equal(v, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(v, w, rtol=SOFT_RTOL, atol=SOFT_ATOL,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name", list(SOFT))
def test_soft_and_balanced_fits_match_the_reference(worlds, ref_meshes, dp,
                                                    name):
    """Fuzzy, GMM (diag, tied) and balanced (with weight-0 rows too) on the
    world against the reference's sharded fit of the same dp and the
    port's single-device fit from the same c0."""
    got = _ok(worlds[dp][f"soft {name}"])
    ref, one = _soft_fits(name, dp, ref_meshes[dp])
    _soft_same(got, ref, "reference")
    _soft_same(got, one._asdict(), "single device")
    for v in got.values():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            assert not np.isnan(v).any()


@pytest.mark.parametrize("dp", DPS)
def test_soft_fits_count_their_all_reduces(worlds, dp):
    """One all-reduce a pass: fuzzy's passes and its final pass; GMM's
    also its starting variances' and its total weight's.  Balanced: one
    for ε's scale, then two a Sinkhorn sweep and one for each pass's
    merge.  (The labels' gather is an all-gather.)"""
    fz = worlds[dp]["soft fuzzy"]
    assert fz["all_reduces"] == int(fz["n_iter"]) + 1
    gm = worlds[dp]["soft gmm diag"]
    assert gm["all_reduces"] == int(gm["n_iter"]) + 3
    bal = worlds[dp]["soft balanced"]
    sweeps = SOFT["balanced"][1]["sinkhorn_sweeps"]
    passes = int(bal["n_iter"]) + 1
    # ε's scale, then per pass the sweeps and the update / final merge.
    assert bal["all_reduces"] == 1 + passes * (2 * sweeps + 1)


@pytest.mark.parametrize("dp", DPS)
def test_pca_fit_sharded_matches_the_reference(worlds, ref_meshes, dp):
    """The global pilot mean and the merged centred moments: components up
    to sign, variances and mean as the reference's sharded fit and the
    port's single-device fit."""
    from kmeans_tpu.parallel.preprocess import \
        pca_fit_sharded as ref_pca_sharded

    got = _ok(worlds[dp]["pca"])
    want = ref_pca_sharded(X + 50.0, 4, mesh=ref_meshes[dp], whiten=True,
                           chunk_size=96)
    one = kt.data.pca_fit(X + 50.0, 4, whiten=True, chunk_size=96,
                          device="cpu")
    for w in (want, one):
        wc = np.asarray(w.components.numpy() if isinstance(
            w.components, torch.Tensor) else w.components)
        s = np.sign((got["components"] * wc).sum(axis=1))
        np.testing.assert_allclose(got["components"] * s[:, None], wc,
                                   atol=1e-4)
        np.testing.assert_allclose(got["explained_variance"],
                                   np.asarray(w.explained_variance),
                                   rtol=1e-4)
        np.testing.assert_allclose(got["mean"], np.asarray(w.mean),
                                   rtol=1e-5)
    assert got["whiten"] is True


@pytest.mark.parametrize("dp", DPS)
def test_gmm_stream_on_the_mesh_matches_the_reference(worlds, ref_meshes,
                                                      dp, stream_file):
    """The streamed GMM with each rank gathering its slice of every batch
    (250 rows round to 248 on dp 4) and one all-reduce of the soft moments
    a step: the reference's mesh stream."""
    from kmeans_tpu.models.gmm_stream import fit_gmm_stream as ref_gmm_stream

    got = _ok(worlds[dp]["gmm stream"])
    data = np.load(stream_file, mmap_mode="r")
    want = ref_gmm_stream(data, 5, mesh=ref_meshes[dp], init=jnp.asarray(CS),
                          config=RefConfig(k=5, chunk_size=512), **STREAM_KW)
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    assert int(got["n_iter"]) == int(want.n_iter)
    for name in ("means", "covariances", "mix_weights"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)),
                                   rtol=SOFT_RTOL, atol=SOFT_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(float(got["log_likelihood"]),
                               float(want.log_likelihood), rtol=1e-5)
