"""The port's data-parallel engine (``kmeans_tpu_torch.parallel``) against
the JAX package's (``kmeans_tpu.parallel``), on the CPU.

The port runs one process per device: each dp is one gloo world of dp CPU
processes (``tests/torch_mesh_worker.py``), spawned once per module and
running every case in order; the reference runs on the conftest's virtual
CPU mesh of the same dp.  Both get the same numpy inputs and an explicit
c0.  Labels must be equal on tie-free data (well-separated blobs); the rest
within RTOL / ATOL, the reference's own tolerance
(``tests/test_yinyang.py``).  The reference's scatter yinyang fails its own
test (``tests/test_yinyang.py::test_sharded_yinyang_matches_single_device
[scatter]``), so the port's scatter yinyang is held against the
reference's single-device fit, as that test does.  The seeding is held
against the port's single-device seeding bit for bit: the draws are a
``torch.Generator``'s, which the reference cannot make.
"""

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
from kmeans_tpu.models import fit_lloyd as ref_fit_lloyd  # noqa: E402
from kmeans_tpu.models import fit_minibatch as ref_fit_minibatch  # noqa
from kmeans_tpu.parallel import engine as ref_engine  # noqa: E402
from kmeans_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from kmeans_tpu.parallel import sharded_assign as ref_sharded_assign  # noqa
import kmeans_tpu_torch.parallel as port_parallel  # noqa: E402
from kmeans_tpu_torch.config import KMeansConfig as kt_config  # noqa: E402
from kmeans_tpu_torch.models import init as port_init  # noqa: E402
from kmeans_tpu_torch.models.minibatch import (apply_batch_stats,  # noqa
                                               batch_stats)
from kmeans_tpu_torch.parallel import engine as port_engine  # noqa: E402

RTOL = 1e-5
ATOL = 1e-5
DPS = (2, 4)
UPDATES = ("matmul", "segment", "delta", "hamerly", "yinyang")
COMMS = ("allreduce", "scatter")
MAX_ITER = 25


def _blobs(seed, n, d, k, std=0.5, spread=3.0):
    rng = np.random.default_rng(seed)
    centres = (rng.normal(size=(k, d)) * spread).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + std * rng.normal(size=(n, d))).astype(np.float32)
    return x, centres


# The shared problems.  n = 1001 is uneven for dp 2 and 4 (the pad path).
X, _ = _blobs(0, 1001, 16, 5)
C0 = X[:5].copy()
W_BIN = (np.random.default_rng(1).random(1001) > 0.3).astype(np.float32)
W_FRAC = np.random.default_rng(2).uniform(0.5, 2.0, 1001).astype(np.float32)
# empty="farthest": two init centroids on one row force an empty slot.
XF, _ = _blobs(2, 501, 8, 4)
CF = np.stack([XF[0], XF[0], XF[1], XF[2]]).astype(np.float32)
# Tied worst rows: four copies of one far row (equal min_d2, four slots).
XT = np.concatenate([XF[:497], np.repeat(XF[:1] + 30.0, 4, axis=0)])
CT = np.stack([XF[0], XF[0], XF[0], XF[1], XF[2]]).astype(np.float32)
# Small shards: 20 rows over 4 ranks, 5 rows a rank < k = 6.
XS = (np.random.default_rng(1).normal(size=(20, 4)) * 3).astype(np.float32)
CS = np.stack([XS[0], XS[0], XS[1], XS[2], XS[3], XS[3]]).astype(np.float32)
# Minibatch: a tail rank that is mostly padding at dp 4 (1801 = 3·451 + 448).
XM, _ = _blobs(14, 1801, 8, 4, std=0.3)
# k-means++ from a seed: blobs far enough apart that the seeding gives
# each one a centroid (no two centroids share a blob, so no near-ties).
XK, _ = _blobs(5, 1001, 16, 5, std=0.3, spread=10.0)
# Stationary minibatch (the reference's l.881-935): separated blobs, the
# true centres as the shared init.
XST, CST = _blobs(13, 4003, 10, 5, std=0.2)
# The pairwise families' ring passes: 601 rows (one padding row at dp 2,
# three at dp 4), explicit medoid indices, labels and landmarks; a
# seventh of the weights 0 in the weighted cases.
# The rows lie on a 1/8 grid, where every distance product is exact in f32
# (see ``tests/test_torch_medoids.py``).
XP = np.round(_blobs(21, 601, 8, 4, std=0.6, spread=4.0)[0] * 8.0) / 8.0
IDX0 = np.array([0, 1, 2, 3], np.int32)
LAB0 = np.random.default_rng(22).integers(0, 4, 601).astype(np.int32)
WP = np.random.default_rng(23).uniform(0.5, 1.5, 601).astype(np.float32)
WP[::7] = 0.0
LP = XP[::19][:32].copy()
PCFG = dict(k=4, chunk_size=64)
#: name → (family, fit kwargs), each held to the reference's ring fit of
#: the same dp and to the port's single-device fit.
PAIRWISE = {
    "kmedoids": ("kmedoids", dict(init=IDX0)),
    "kmedoids weighted": ("kmedoids", dict(init=IDX0, weights=WP,
                                           metric="sqeuclidean")),
    "kernel rbf": ("kernel", dict(init=LAB0)),
    "kernel linear weighted": ("kernel", dict(init=LAB0, weights=WP,
                                              kernel="linear")),
}


def _fit_kw(k, **cfg):
    return dict(k=k, tol=1e-10, max_iter=MAX_ITER,
                config=dict(k=k, **cfg))


def _cases():
    cases = []
    for update in UPDATES:
        for comm in COMMS:
            cases.append((f"fit {update} {comm}", "fit",
                          dict(x=X, init=C0, **_fit_kw(
                              5, update=update, comm=comm))))
    for name, w, cd, update in (("binary", W_BIN, None, "delta"),
                                ("fractional", W_FRAC, "float32",
                                 "matmul"),
                                ("fractional-delta", W_FRAC, "float32",
                                 "delta")):
        cases.append((f"weights {name}", "fit", dict(
            x=X, init=C0, weights=w,
            **_fit_kw(5, update=update, compute_dtype=cd))))
    for comm in COMMS:
        for name, x, c0, k in (("farthest", XF, CF, 4),
                               ("tied", XT, CT, 5),
                               ("small", XS, CS, 6)):
            cases.append((f"{name} {comm}", "fit", dict(
                x=x, init=c0, **_fit_kw(k, empty="farthest", comm=comm,
                                        update="matmul"))))
        cases.append((f"farthest-delta {comm}", "fit", dict(
            x=XF, init=CF, **_fit_kw(4, empty="farthest", comm=comm,
                                     update="delta"))))
    cases.append(("assign", "assign", dict(x=X, c=C0 + 0.25)))
    for method in ("k-means++", "k-means||", "random"):
        cases.append((f"init {method}", "init",
                      dict(x=X, k=5, method=method, seed=7)))
    cases.append(("init random weighted", "init",
                  dict(x=X, k=5, method="random", seed=7, weights=W_FRAC)))
    cases.append(("init k-means++ weighted", "init",
                  dict(x=X, k=5, method="k-means++", seed=7,
                       weights=W_FRAC)))
    cases.append(("kmpar knobs", "kmpar", dict(
        x=X, k=12, seed=9, rounds=3, oversampling=64, chunk_size=256)))
    cases.append(("fit k-means++", "fit", dict(
        x=XK, k=5, max_iter=MAX_ITER, tol=1e-10,
        config=dict(k=5, seed=4, update="delta"))))
    cases.append(("minibatch tail", "minibatch", dict(
        x=XM, k=4, init=XM[:4].copy(), batch_size=64, steps=30,
        config=dict(k=4, seed=5))))
    cases.append(("minibatch draws", "minibatch_draws", dict(
        n=1801, d=8, k=4, batch_size=64, steps=30, seed=5)))
    cases.append(("minibatch stationary", "minibatch", dict(
        x=XST, k=5, init=CST, batch_size=256, steps=60,
        config=dict(k=5, seed=0))))
    for comm in COMMS:
        cases.append((f"split {comm}", "split", dict(
            x=X, k=5, init=C0, comm=comm, sweeps=3)))
    cases.append(("runner", "runner", dict(
        x=X, k=5, init=C0, max_iter=MAX_ITER, tol=1e-10,
        config=dict(k=5, update="matmul"))))
    cases.append(("runner matmul fit", "fit", dict(
        x=X, init=C0, **_fit_kw(5, update="matmul"))))
    cases.append(("runner farthest", "runner", dict(
        x=XF, k=4, init=CF, max_iter=MAX_ITER, tol=1e-10,
        config=dict(k=4, update="auto", empty="farthest"))))
    # Refusals (raised on every rank before the first collective).
    # Model and feature axes of one rank: the sharded body on a DP mesh.
    cases.append(("model_axis of 1", "fit", dict(
        x=X, init=C0, model_axis="model", **_fit_kw(5))))
    cases.append(("feature_axis of 1", "fit", dict(
        x=X, init=C0, feature_axis="feature", mesh_axes=(
            "data", "model", "feature"), **_fit_kw(5))))
    cases.append(("refuse sphere", "fit",
                  dict(x=X, init=C0, k=5, center_update="sphere",
                       config=dict(k=5, empty="farthest"))))
    cases.append(("model mesh", "mesh", dict(shape=(1, 2))))
    cases.append(("mesh freed", "mesh_freed", {}))
    cases.append(("refuse big mesh", "mesh", dict(shape=(8, 1))))
    cases.append(("guard hamerly farthest", "fit", dict(
        x=X, init=C0, k=5, config=dict(k=5, update="hamerly",
                                       empty="farthest"))))
    cases.append(("guard delta fractional", "fit", dict(
        x=X, init=C0, k=5, weights=W_FRAC,
        config=dict(k=5, update="delta", compute_dtype="bfloat16"))))
    cases.append(("guard init shape", "fit", dict(x=X, init=C0[:3], k=5)))
    cases.append(("guard weights shape", "fit",
                  dict(x=X, init=C0, k=5, weights=W_FRAC[:10])))
    cases.append(("guard resume without dir", "fit",
                  dict(x=X, init=C0, k=5, resume=True)))
    for name, (family, kw) in PAIRWISE.items():
        cases.append((f"pairwise {name}", "pairwise", dict(
            family=family, x=XP, k=4, config=PCFG, max_iter=20, **kw)))
    for family in ("kmedoids", "kernel"):
        cases.append((f"pairwise {family} seeded", "pairwise", dict(
            family=family, x=XP, k=4, max_iter=20,
            config=dict(PCFG, seed=3))))
    cases.append(("kernel pads", "kernel_pads", dict(
        x=XP, k=4, labels0=LAB0, max_iter=20)))
    cases.append(("spectral", "spectral", dict(x=XP, k=4, landmarks=LP,
                                                chunk_size=64)))
    cases.append(("spectral fit", "spectral_fit", dict(
        x=XP, k=4, n_landmarks=48, config=dict(PCFG, seed=5))))
    return cases


@pytest.fixture(scope="module")
def worlds():
    """Every case in a gloo world of each dp, once for the module."""
    cases = _cases()
    return {dp: run_world(dp, cases) for dp in DPS}


@pytest.fixture(scope="module")
def ref_meshes(cpu_devices):
    return {dp: ref_make_mesh((dp, 1), ("data", "model"),
                              devices=cpu_devices[:dp]) for dp in DPS}


def _ok(res):
    assert "error" not in res, res["error"]
    return res


def _ref_fit(mesh, x, c0, k, weights=None, **cfg):
    return ref_engine.fit_lloyd_sharded(
        x, k, mesh=mesh, init=c0, tol=1e-10, max_iter=MAX_ITER,
        weights=weights, config=RefConfig(k=k, **cfg))


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


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("update", UPDATES)
def test_fit_matches_the_reference(worlds, ref_meshes, dp, comm, update):
    """Every DP flavour and merge against the reference's sharded fit of
    the same dp (padded rows: 1001 is uneven for dp 2 and 4); the scatter
    yinyang against the reference's single-device fit (its own sharded
    scatter yinyang fails its test)."""
    got = worlds[dp][f"fit {update} {comm}"]
    if update == "yinyang" and comm == "scatter":
        want = ref_fit_lloyd(jnp.asarray(X), 5, init=jnp.asarray(C0),
                             tol=1e-10, max_iter=MAX_ITER,
                             config=RefConfig(k=5, update="yinyang"))
    else:
        want = _ref_fit(ref_meshes[dp], X, C0, 5, update=update, comm=comm)
    _assert_state(got, want)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("update", UPDATES)
def test_allreduce_and_scatter_agree(worlds, dp, update):
    a = _ok(worlds[dp][f"fit {update} allreduce"])
    s = _ok(worlds[dp][f"fit {update} scatter"])
    np.testing.assert_array_equal(a["labels"], s["labels"])
    assert a["n_iter"] == s["n_iter"]
    np.testing.assert_allclose(a["centroids"], s["centroids"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", [f"{u} {c}" for u in UPDATES
                                  for c in COMMS])
def test_dp2_and_dp4_agree(worlds, name):
    a = _ok(worlds[2][f"fit {name}"])
    b = _ok(worlds[4][f"fit {name}"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    np.testing.assert_allclose(a["centroids"], b["centroids"], rtol=RTOL,
                               atol=ATOL)
    assert a["n_iter"] == b["n_iter"]


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name,weights,cd,update", [
    ("binary", W_BIN, None, "delta"),
    ("fractional", W_FRAC, "float32", "matmul"),
    ("fractional-delta", W_FRAC, "float32", "delta"),
])
def test_weights_match_the_reference(worlds, ref_meshes, dp, name, weights,
                                     cd, update):
    """Binary weights (zeros beside the padding's), and fractional ones in
    f32 compute, the dense update demoted to the segment reduction as on
    one device."""
    want = _ref_fit(ref_meshes[dp], X, C0, 5, weights=weights, update=update,
                    compute_dtype=cd)
    _assert_state(worlds[dp][f"weights {name}"], want)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("name,x,c0,k", [
    ("farthest", XF, CF, 4), ("tied", XT, CT, 5), ("small", XS, CS, 6)])
def test_empty_farthest_matches_the_reference(worlds, ref_meshes, dp, comm,
                                              name, x, c0, k):
    """The sharded farthest reseed: the r-th empty slot takes the r-th
    ranked worst row, the lower row first on a tie (four tied worst rows),
    shards with fewer rows than k (20 rows over 4 ranks, k = 6), and
    through scatter with k % dp != 0 (k = 5 and 6 at dp 4)."""
    got = _ok(worlds[dp][f"{name} {comm}"])
    want = _ref_fit(ref_meshes[dp], x, c0, k, empty="farthest", comm=comm,
                    update="matmul")
    _assert_state(got, want)
    assert np.all(got["counts"] > 0)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("comm", COMMS)
def test_delta_farthest_matches_the_reference(worlds, ref_meshes, dp, comm):
    want = _ref_fit(ref_meshes[dp], XF, CF, 4, empty="farthest", comm=comm,
                    update="delta")
    _assert_state(worlds[dp][f"farthest-delta {comm}"], want)


def test_tied_worst_rows_take_the_lowest_index():
    """The engine's ``top_stable`` keeps the lower index on a tie, as
    ``lax.top_k`` does (``torch.topk`` fixes no tie order)."""
    v = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    vals, idx = port_engine.top_stable(v, 4)
    assert idx.tolist() == [1, 2, 4, 3]
    _, ref_idx = jax.lax.top_k(jnp.asarray(v.numpy()), 4)
    assert idx.tolist() == np.asarray(ref_idx).tolist()


@pytest.mark.parametrize("dp", DPS)
def test_sharded_assign_matches_the_reference(worlds, ref_meshes, dp):
    got = _ok(worlds[dp]["assign"])
    labels, mind = ref_sharded_assign(X, C0 + 0.25, mesh=ref_meshes[dp])
    np.testing.assert_array_equal(got["labels"], np.asarray(labels))
    np.testing.assert_allclose(got["mind"], np.asarray(mind), rtol=RTOL,
                               atol=1e-4)
    assert got["labels"].shape == (1001,)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("method,weighted", [
    ("k-means++", False), ("k-means||", False), ("random", False),
    ("random", True), ("k-means++", True)])
def test_sharded_init_is_the_single_device_init(worlds, dp, method,
                                                weighted):
    """The sharded seeding gives the port's single-device seeding's
    centroids bit for bit from the same generator, and leaves the
    generator where it does."""
    name = f"init {method}" + (" weighted" if weighted else "")
    got = _ok(worlds[dp][name])
    gen = torch.Generator().manual_seed(7)
    w = torch.from_numpy(W_FRAC) if weighted else None
    want = port_init.init_centroids(gen, torch.from_numpy(X), 5,
                                    method=method, weights=w)
    np.testing.assert_array_equal(got["centroids"], want.numpy())
    np.testing.assert_array_equal(got["next"],
                                  torch.rand(4, generator=gen).numpy())


@pytest.mark.parametrize("dp", DPS)
def test_kmeans_parallel_sharded_knobs(worlds, dp):
    got = _ok(worlds[dp]["kmpar knobs"])
    want = port_init.kmeans_parallel(
        torch.Generator().manual_seed(9), torch.from_numpy(X), 12, rounds=3,
        oversampling=64, chunk_size=256)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("dp", DPS)
def test_seeded_fit_is_the_single_device_fit(worlds, dp):
    """``fit_lloyd_sharded`` with k-means++ from ``config.seed``: the
    single-device port's fit from the same seed."""
    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.models.lloyd import fit_lloyd

    got = _ok(worlds[dp]["fit k-means++"])
    want = fit_lloyd(XK, 5, config=KMeansConfig(k=5, seed=4, update="delta"),
                     max_iter=MAX_ITER, tol=1e-10, device="cpu")
    np.testing.assert_array_equal(got["labels"], want.labels.numpy())
    np.testing.assert_allclose(got["centroids"], want.centroids.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert got["n_iter"] == int(want.n_iter)


def test_resolve_comm_and_bytes_match_the_reference():
    for req in ("auto", "allreduce", "scatter"):
        for dp in (1, 2, 8):
            for sharded in (False, True):
                for k, d in ((1000, 300), (65536, 2048), (8192, 128),
                             (7, 3)):
                    try:
                        want = ref_engine._resolve_comm(
                            req, dp=dp, sharded_axes=sharded, k=k, d=d)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            port_engine._resolve_comm(
                                req, dp=dp, sharded_axes=sharded, k=k, d=d)
                        assert str(got.value) == str(e)
                        continue
                    assert port_engine._resolve_comm(
                        req, dp=dp, sharded_axes=sharded, k=k, d=d) == want
    with pytest.raises(ValueError, match="unknown comm"):
        port_engine._resolve_comm("ring", dp=8, sharded_axes=False, k=1, d=1)
    assert port_engine._SCATTER_AUTO_MIN_BYTES == \
        ref_engine._SCATTER_AUTO_MIN_BYTES
    for comm in COMMS:
        for dp in (1, 2, 3, 4, 8):
            for k, d in ((5, 16), (1000, 2048), (65536, 2048), (13, 7)):
                assert port_engine._sweep_collective_bytes(
                    comm, dp=dp, k=k, d=d) == \
                    ref_engine._sweep_collective_bytes(comm, dp=dp, k=k, d=d)


def test_pad_rows_matches_the_reference():
    for n, m in ((1001, 4), (8, 4), (3, 8)):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        w = np.linspace(0.5, 1.5, n).astype(np.float32)
        for weights in (None, w):
            px, pw, pn = port_engine._pad_rows(x, m, weights=weights)
            rx, rw, rn = ref_engine._pad_rows(x, m, weights=weights)
            np.testing.assert_array_equal(px, np.asarray(rx))
            np.testing.assert_array_equal(pw, rw)
            assert pn == rn
    assert port_engine._mesh_layout(4, 1, 1) == \
        ref_engine._mesh_layout(4, 1, 1)
    from types import SimpleNamespace

    from kmeans_tpu_torch.parallel.init_sharded import \
        sharded_init_applicable

    dp_mesh = SimpleNamespace(axis_sizes={"data": 2, "model": 1})
    tp_mesh = SimpleNamespace(axis_sizes={"data": 2, "model": 2})
    block = torch.zeros(8, 3)
    assert sharded_init_applicable(block, 5, mesh=dp_mesh,
                                   data_axis="data")
    assert not sharded_init_applicable(block, 5, mesh=tp_mesh,
                                       data_axis="data")
    assert not sharded_init_applicable(block[0], 5, mesh=dp_mesh,
                                       data_axis="data")


@pytest.mark.parametrize("dp", DPS)
def test_minibatch_tail_rank(worlds, dp):
    """n = 1801: the tail rank's importance weight ``n_valid·dp/n`` (the
    reference's formula in f32), and a fit whose final assignment labels
    every real row; its centroids are a replay of the ranks' draws through
    ``batch_stats`` on one device, the stats summed and applied."""
    got = _ok(worlds[dp]["minibatch tail"])
    draws = _ok(worlds[dp]["minibatch draws"])
    n, n_loc = 1801, -(-1801 // dp)
    for r, (s_i, n_valid, _) in enumerate(draws):
        want_valid = int(np.clip(n - r * n_loc, 0, n_loc))
        assert n_valid == want_valid
        want = (np.float32(want_valid) * np.float32(dp) / np.float32(n)
                if want_valid > 0 else 0.0)
        assert s_i == float(want)
    assert got["labels"].shape == (1801,)
    assert np.all(got["counts"] > 0) and np.isfinite(got["inertia"])
    c = torch.from_numpy(XM[:4].copy())
    n_seen = torch.zeros(4)
    x = torch.from_numpy(XM)
    for step in range(30):
        bc = bs = 0
        for s_i, _, idx in draws:
            rows = torch.from_numpy(np.minimum(idx[step], n - 1))
            c_r, s_r, _ = batch_stats(c, x[rows], compute_dtype=None,
                                      row_weight=s_i)
            bc, bs = bc + c_r, bs + s_r
        c, n_seen, _ = apply_batch_stats(c, n_seen, bc, bs)
    np.testing.assert_allclose(got["centroids"], c.numpy(), rtol=RTOL,
                               atol=ATOL)
    want_labels = np.argmin(
        ((XM[:, None, :] - got["centroids"][None]) ** 2).sum(-1), 1)
    np.testing.assert_array_equal(got["labels"], want_labels)


@pytest.mark.parametrize("dp", DPS)
def test_minibatch_stationary_matches_the_reference(worlds, dp):
    """The reference's stationary case: per-rank stratified draws reach the
    single-device global sampler's partition (ARI > 0.99) and inertia
    within 5% (different draws)."""
    from kmeans_tpu.metrics import adjusted_rand_index

    got = _ok(worlds[dp]["minibatch stationary"])
    want = ref_fit_minibatch(jnp.asarray(XST), 5, init=jnp.asarray(CST),
                             batch_size=256, steps=60)
    ari = float(adjusted_rand_index(got["labels"], np.asarray(want.labels)))
    assert ari > 0.99, ari
    np.testing.assert_allclose(got["inertia"], float(want.inertia),
                               rtol=0.05)


@pytest.mark.parametrize("dp", DPS)
def test_runner_on_a_mesh_matches_the_dense_fit(worlds, dp):
    """``LloydRunner(mesh=)`` steps the dense reduction: the same fit as
    ``fit_lloyd_sharded(update="matmul")``; ``empty="farthest"`` heals."""
    run = _ok(worlds[dp]["runner"])
    fit = _ok(worlds[dp]["runner matmul fit"])
    np.testing.assert_array_equal(run["labels"], fit["labels"])
    np.testing.assert_allclose(run["centroids"], fit["centroids"],
                               rtol=RTOL, atol=ATOL)
    assert run["n_iter"] == fit["n_iter"]
    np.testing.assert_allclose(run["inertia"], fit["inertia"], rtol=RTOL)
    assert np.all(_ok(worlds[dp]["runner farthest"])["counts"] > 0)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("case,item", [("refuse sphere", "A9a")])
def test_unported_arguments_name_their_item(worlds, ref_meshes, dp, case,
                                            item):
    """The sphere update, ported with the spherical family (ROADMAP
    ``item``), refuses what the reference's refuses, with its error: the
    farthest reseed is a Lloyd policy."""
    err = worlds[dp][case]["error"]
    with pytest.raises(ValueError) as want:
        ref_engine.fit_lloyd_sharded(
            X, 5, mesh=ref_meshes[dp], init=C0, center_update="sphere",
            config=RefConfig(k=5, empty="farthest"))
    assert err == f"ValueError: {want.value}"


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("case", ["model_axis of 1", "feature_axis of 1"])
def test_one_rank_model_and_feature_axes_are_data_parallel(worlds, ref_meshes,
                                                           dp, case):
    """A model or feature axis of one rank runs the sharded body with
    nothing to resolve across slices: the reference's dense DP fit."""
    want = _ref_fit(ref_meshes[dp], X, C0, 5, update="matmul")
    _assert_state(worlds[dp][case], want)


@pytest.mark.parametrize("dp", DPS)
def test_mesh_with_a_model_axis(worlds, dp):
    """A (1, 2) mesh of the world: its shape and this rank's place on
    it (the world of 4 has too many ranks for it)."""
    got = worlds[dp]["model mesh"]
    if dp == 2:
        assert got == {"shape": (1, 2), "rank": 0, "size": 2}
    else:
        assert got["error"] == ("ValueError: mesh shape (1, 2) needs 2 "
                                "processes, the process group has 4")


def test_mesh_of_one_runs_its_collectives():
    """A mesh of one rank runs every collective in its group (only a
    view without a group, one rank of a larger mesh, skips them): each
    sweep's merge and the final pass's are issued, as an NCCL world of one
    on a card issues them."""
    got = run_world(1, [("stats", "stats", dict(x=X, k=5, init=C0,
                                                sweeps=3))])["stats"]
    assert got["all_reduce"][0] >= 3 + 1, got


@pytest.mark.parametrize("dp", DPS)
def test_a_mesh_goes_with_its_last_reference(worlds, dp):
    """No mesh or view refers to itself, so its process group goes when
    the caller drops it, not at the interpreter's teardown, where a live
    group can abort the exit ("terminate called without an active
    exception")."""
    assert worlds[dp]["mesh freed"] is True


@pytest.mark.parametrize("dp", DPS)
def test_mesh_needs_its_devices(worlds, dp):
    err = worlds[dp]["refuse big mesh"]["error"]
    assert err == (f"ValueError: mesh shape (8, 1) needs 8 devices, have "
                   f"{dp}")


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("case,kw", [
    ("guard hamerly farthest", dict(config=dict(update="hamerly",
                                                empty="farthest"))),
    ("guard delta fractional", dict(weights=W_FRAC, config=dict(
        update="delta", compute_dtype="bfloat16"))),
    ("guard init shape", dict(init=C0[:3])),
    ("guard weights shape", dict(weights=W_FRAC[:10])),
    ("guard resume without dir", dict(resume=True)),
])
def test_guards_print_the_reference_line(worlds, ref_meshes, dp, case, kw):
    kw = dict(kw)
    cfg = RefConfig(k=5, **kw.pop("config", {}))
    init = kw.pop("init", C0)
    with pytest.raises(ValueError) as e:
        ref_engine.fit_lloyd_sharded(X, 5, mesh=ref_meshes[dp], init=init,
                                     config=cfg, **kw)
    assert worlds[dp][case]["error"] == f"ValueError: {e.value}"


def test_engine_families_on_the_registry():
    """The engine's metric families, the reference's names, on the port's
    registry (stamped in process here, as a fit stamps them)."""
    from kmeans_tpu_torch import obs

    port_engine._observe_sharded_fit("lloyd.delta", "plain", "dp2", 2, 0.5,
                                     5)
    port_engine._ENGINE_COLLECTIVE_BYTES.labels(
        function="lloyd.delta", comm="allreduce").set(
        port_engine._sweep_collective_bytes("allreduce", dp=2, k=5, d=16))
    text = obs.REGISTRY.expose()
    for fam in ("kmeans_tpu_engine_fit_seconds",
                "kmeans_tpu_engine_sweep_seconds",
                "kmeans_tpu_engine_fits_total", "kmeans_tpu_engine_shards",
                "kmeans_tpu_engine_collective_bytes"):
        assert f"# TYPE {fam}" in text, fam
    ref_types = {n: type(m).__name__ for n, m in (
        ("kmeans_tpu_engine_fit_seconds", ref_engine._ENGINE_FIT_SECONDS),
        ("kmeans_tpu_engine_sweep_seconds",
         ref_engine._ENGINE_SWEEP_SECONDS),
        ("kmeans_tpu_engine_fits_total", ref_engine._ENGINE_FITS_TOTAL),
        ("kmeans_tpu_engine_shards", ref_engine._ENGINE_SHARDS))}
    port_types = {n: type(m).__name__ for n, m in (
        ("kmeans_tpu_engine_fit_seconds", port_engine._ENGINE_FIT_SECONDS),
        ("kmeans_tpu_engine_sweep_seconds",
         port_engine._ENGINE_SWEEP_SECONDS),
        ("kmeans_tpu_engine_fits_total", port_engine._ENGINE_FITS_TOTAL),
        ("kmeans_tpu_engine_shards", port_engine._ENGINE_SHARDS))}
    assert ref_types == port_types


def test_package_surface():
    for name in ("fit_lloyd_sharded", "fit_minibatch_sharded",
                 "fit_lloyd_accelerated_sharded", "fit_trimmed_sharded",
                 "sharded_assign", "kmeans_parallel_sharded", "make_mesh",
                 "cpu_mesh", "mesh_from_config", "ensure_initialized",
                 "process_info", "fit_kmedoids_sharded",
                 "fit_kernel_kmeans_sharded", "spectral_embedding_sharded"):
        assert hasattr(port_parallel, name), name


@pytest.mark.parametrize("comm,parts", [
    ("allreduce", ["pass", "merge", "update"]),
    ("scatter", ["pass", "merge", "update", "gather"])])
def test_sweep_split_records_each_part(worlds, comm, parts):
    """``sweep_split``: one record a sweep, each part's host milliseconds
    (no device time off the card)."""
    split = worlds[2][f"split {comm}"]
    assert isinstance(split, list), split
    assert len(split) == 3
    for sweep in split:
        assert list(sweep) == parts
        assert all(host >= 0.0 and dev is None
                   for host, dev in sweep.values())



# ---------------------------------------------------------------------------
# The pairwise families' ring passes and the sharded spectral embedding
# ---------------------------------------------------------------------------

def _ref_pairwise(mesh, family, **kw):
    from kmeans_tpu.parallel import (fit_kernel_kmeans_sharded,
                                     fit_kmedoids_sharded)

    fit = {"kmedoids": fit_kmedoids_sharded,
           "kernel": fit_kernel_kmeans_sharded}[family]
    kw = dict(kw)
    if "init" in kw:
        kw["init"] = jnp.asarray(kw["init"])
    return fit(XP, 4, mesh=mesh, config=RefConfig(**PCFG), max_iter=20,
               **kw)


def _assert_pairwise(got, want, family):
    """Medoid indices / labels equal (tie-free blobs), floats to RTOL."""
    _ok(got)
    np.testing.assert_array_equal(got["labels"], np.asarray(want.labels))
    assert got["n_iter"] == int(want.n_iter)
    assert got["converged"] == bool(want.converged)
    if family == "kmedoids":
        np.testing.assert_array_equal(got["medoid_indices"],
                                      np.asarray(want.medoid_indices))
        np.testing.assert_array_equal(got["medoids"],
                                      np.asarray(want.medoids))
        np.testing.assert_allclose(got["inertia"], float(want.inertia),
                                   rtol=RTOL)
    else:
        np.testing.assert_allclose(got["objective"], float(want.objective),
                                   rtol=RTOL)
        np.testing.assert_allclose(got["counts"], np.asarray(want.counts),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["within_mass"],
                                   np.asarray(want.within_mass), rtol=1e-4)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name", list(PAIRWISE))
def test_pairwise_ring_matches_the_reference(worlds, ref_meshes, dp, name):
    """k-medoids and kernel k-means as ring passes against the reference's
    ring fits of the same dp (RTOL on the floats: the two packages sum
    the ring steps' f32 terms in other orders)."""
    family, kw = PAIRWISE[name]
    _assert_pairwise(worlds[dp][f"pairwise {name}"],
                     _ref_pairwise(ref_meshes[dp], family, **kw), family)


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("name", list(PAIRWISE))
def test_pairwise_ring_is_the_single_device_fit(worlds, dp, name):
    """The ring fit against the port's single-device fit (a ring of one),
    and the ring's traffic: dp − 1 shifts a sweep of the O(n²) pass, and
    the all-reduces of each family's step (k-medoids: the medoid rows and
    two MINs an iteration, then the rows and the inertia; kernel: (N, T)
    and the changed count an iteration, then (N, T) and the objective)."""
    import kmeans_tpu_torch.models as port_models

    family, kw = PAIRWISE[name]
    got = _ok(worlds[dp][f"pairwise {name}"])
    fit = {"kmedoids": port_models.fit_kmedoids,
           "kernel": port_models.fit_kernel_kmeans}[family]
    one = fit(XP, 4, config=kt_config(**PCFG), max_iter=20, device="cpu",
              **kw)
    _assert_pairwise(got, one, family)
    it = got["n_iter"]
    if family == "kmedoids":
        assert got["ring_shifts"] == (dp - 1) * it
        assert got["all_reduces"] == 3 * it + 2
    else:
        assert got["ring_shifts"] == (dp - 1) * (it + 1)
        assert got["all_reduces"] == 2 * it + 2


@pytest.mark.parametrize("dp", DPS)
@pytest.mark.parametrize("family", ["kmedoids", "kernel"])
def test_seeded_pairwise_ring_is_the_single_device_fit(worlds, dp, family):
    """Seeded from ``config.seed`` (the D-sampling of medoid rows, or
    k-means++ and K1 for the kernel labels): the sharded seeding draws
    what one device draws, so the fit is the single-device one."""
    import kmeans_tpu_torch.models as port_models

    got = _ok(worlds[dp][f"pairwise {family} seeded"])
    fit = {"kmedoids": port_models.fit_kmedoids,
           "kernel": port_models.fit_kernel_kmeans}[family]
    one = fit(XP, 4, config=kt_config(**PCFG, seed=3), max_iter=20,
              device="cpu")
    _assert_pairwise(got, one, family)


@pytest.mark.parametrize("dp", DPS)
def test_kernel_ring_pins_padding_rows_to_label_0(worlds, dp):
    """The padding rows of the last block (global index ≥ n) stay at label
    0 through every pass, so they never count as changed."""
    got = _ok(worlds[dp]["kernel pads"])
    pad = (-601) % dp
    assert got["labels"].shape == (601 + pad,)
    assert pad and np.all(got["labels"][601:] == 0)
    np.testing.assert_array_equal(
        got["labels"][:601], _ok(worlds[dp]["pairwise kernel rbf"])[
            "labels"])


def _projector(u):
    u = np.asarray(u, np.float64)
    return u @ u.T


@pytest.mark.parametrize("dp", DPS)
def test_spectral_embedding_sharded_matches_the_reference(worlds, ref_meshes,
                                                          dp):
    """The sharded embedding from explicit landmarks: its projector U Uᵀ
    (free of the eigenvectors' signs and of turns in a degenerate pair)
    against the reference's sharded embedding and the port's one device,
    within 1e-5; every rank's ``eigh`` gave the same eigenvectors, bit for
    bit, and every row has norm 1."""
    from kmeans_tpu.parallel import spectral_embedding_sharded as ref_embed

    from kmeans_tpu_torch.models import spectral_embedding

    got = _ok(worlds[dp]["spectral"])
    emb = got["embedding"]
    assert emb.shape == (601, 4)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-6)
    want = np.asarray(ref_embed(XP, 4, mesh=ref_meshes[dp],
                                landmarks=jnp.asarray(LP)))
    np.testing.assert_allclose(_projector(emb), _projector(want), atol=1e-5)
    one = spectral_embedding(XP, 4, landmarks=LP, chunk_size=64,
                             device="cpu").numpy()
    np.testing.assert_allclose(_projector(emb), _projector(one), atol=1e-5)
    bases = got["bases"]
    assert bases.shape == (dp, 32, 4)
    for r in range(1, dp):
        np.testing.assert_array_equal(bases[r], bases[0])


@pytest.mark.parametrize("dp", DPS)
def test_fit_spectral_on_the_mesh_is_the_single_device_fit(worlds, dp):
    """``fit_spectral(mesh=)`` draws the single-device landmarks and
    seeding: the same partition (labels up to a permutation), the
    embedding up to rotation."""
    from kmeans_tpu_torch.metrics import adjusted_rand_index
    from kmeans_tpu_torch.models import fit_spectral

    got = _ok(worlds[dp]["spectral fit"])
    one = fit_spectral(XP, 4, n_landmarks=48, config=kt_config(**PCFG,
                                                               seed=5),
                       device="cpu")
    assert float(adjusted_rand_index(got["labels"], one.labels.numpy(),
                                     device="cpu")) == 1.0
    np.testing.assert_allclose(_projector(got["embedding"]),
                               _projector(one.embedding.numpy()), atol=1e-5)
