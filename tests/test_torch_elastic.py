"""The port's elastic sharded fit (``fit_lloyd_sharded(ckpt_dir=...)``)
against the JAX package's, on the CPU: the reference's
``tests/test_engine_elastic.py`` on gloo worlds of CPU processes.

A dp-4 world cuts the bundles (and resumes some of them on the same mesh);
a dp-2 world then resumes the others on the shrunk mesh, with the comm
flipped.  The parity contract is the reference's: the classic update's
elastic run is the fused fit's (labels equal, centroids within ATOL
1e-5); the delta, hamerly and yinyang flavours re-derive their carried
state at every segment start, so their yardstick is an uninterrupted
elastic run with the same cadence.  On the CPU the plain versions are
deterministic, so a kill and resume on the same mesh is bit for bit that
run; on a shrunk mesh the merge sums in another order, and the labels stay
equal with the centroids within ATOL.  Bundles cross packages both ways.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_mesh_worker import run_world  # noqa: E402

from kmeans_tpu.config import KMeansConfig as RefConfig  # noqa: E402
from kmeans_tpu.config import engine_fingerprint as ref_fingerprint  # noqa
from kmeans_tpu.parallel import engine as ref_engine  # noqa: E402
from kmeans_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from kmeans_tpu_torch.config import KMeansConfig  # noqa: E402
from kmeans_tpu_torch.parallel import engine as port_engine  # noqa: E402

K = 10
MAX_IT = 40
ATOL = 1e-5
X = np.random.default_rng(1).normal(size=(1024, 16)).astype(np.float32)
C0 = X[:K].copy()
FLAVOURS = ("delta", "hamerly", "yinyang")
COMMS = ("allreduce", "scatter")
#: SIGTERM at the second segment boundary: the fit stops at sweep 8.
SIGTERM = "engine.sweep_merge:sigterm@2"


def _fit(ck=None, **kw):
    out = dict(x=X, k=K, tol=0.0)
    if "init" not in kw and "resume" not in kw:
        out["init"] = C0
    if ck is not None:
        out["ckpt_dir"] = ck
    out.update(kw)
    out.setdefault("max_iter", MAX_IT)
    return out


def _dp4_cases(d):
    cases = [
        ("plain", "elastic", _fit()),
        ("elastic", "elastic", _fit(f"{d}/e", ckpt_every=4)),
        ("partial", "elastic", _fit(f"{d}/p", max_iter=7, ckpt_every=3)),
        ("partial for ref", "elastic", _fit(f"{d}/pr", max_iter=7,
                                            ckpt_every=3)),
        ("partial for tp", "elastic", _fit(f"{d}/pt", max_iter=7,
                                           ckpt_every=3)),
        ("cut scatter", "elastic", _fit(
            f"{d}/s", ckpt_every=4, fault=SIGTERM,
            config=dict(k=K, tol=0.0, comm="scatter"))),
        ("cut rank 0", "elastic", _fit(
            f"{d}/r0", ckpt_every=4, fault=SIGTERM, fault_rank=0,
            config=dict(k=K, tol=0.0, update="matmul"))),
        ("short", "elastic", _fit(f"{d}/fp", max_iter=4, ckpt_every=2)),
        ("mismatch", "elastic", _fit(
            resume=f"{d}/fp", config=dict(k=K, seed=99, tol=0.0))),
        ("missing", "elastic", _fit(resume=f"{d}/nope")),
        ("bad every", "elastic", _fit(f"{d}/v", ckpt_every=-1)),
        ("resume no dir", "elastic", _fit(resume=True)),
        ("resume other dir", "elastic", _fit(f"{d}/v",
                                             resume=f"{d}/other")),
        ("from ref", "elastic", _fit(resume=f"{d}/ref", ckpt_every=3)),
    ]
    for f in FLAVOURS:
        for comm in COMMS:
            cfg = dict(k=K, tol=0.0, update=f, comm=comm)
            cases += [
                (f"uncut {f} {comm}", "elastic", _fit(
                    f"{d}/b-{f}-{comm}", ckpt_every=4, config=cfg)),
                (f"cut {f} {comm}", "elastic", _fit(
                    f"{d}/a-{f}-{comm}", ckpt_every=4, config=cfg,
                    fault=SIGTERM)),
                (f"cut again {f} {comm}", "elastic", _fit(
                    f"{d}/c-{f}-{comm}", ckpt_every=4, config=cfg,
                    fault=SIGTERM)),
                (f"same mesh {f} {comm}", "elastic", _fit(
                    resume=f"{d}/c-{f}-{comm}", ckpt_every=4, config=cfg)),
            ]
    return cases


def _dp2_cases(d):
    cases = [
        ("resume partial", "elastic", _fit(resume=f"{d}/p", ckpt_every=3)),
        ("resume scatter cut", "elastic", _fit(
            resume=f"{d}/s", ckpt_every=4,
            config=dict(k=K, tol=0.0, comm="allreduce"))),
        ("resume rank 0 cut", "elastic", _fit(
            resume=f"{d}/r0", ckpt_every=4,
            config=dict(k=K, tol=0.0, update="matmul"))),
        ("resume converged", "elastic", _fit(resume=f"{d}/e")),
        ("resume on tp", "elastic", _fit(
            resume=f"{d}/pt", ckpt_every=3, model_axis="model",
            mesh_shape=(1, 2))),
    ]
    for f in FLAVOURS:
        for comm in COMMS:
            cases.append((f"shrunk {f} {comm}", "elastic", _fit(
                resume=f"{d}/a-{f}-{comm}", ckpt_every=4,
                config=dict(k=K, tol=0.0, update=f, comm="allreduce"))))
    return cases


@pytest.fixture(scope="module")
def ref_meshes(cpu_devices):
    return {dp: ref_make_mesh((dp, 1), ("data", "model"),
                              devices=cpu_devices[:dp]) for dp in (2, 4)}


@pytest.fixture(scope="module")
def ref_plain(ref_meshes):
    """The reference's uninterrupted fused fit: the classic yardstick."""
    return ref_engine.fit_lloyd_sharded(X, K, mesh=ref_meshes[4], init=C0,
                                        tol=0.0, max_iter=MAX_IT)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, ref_meshes):
    d = str(tmp_path_factory.mktemp("elastic"))
    # A bundle the reference cut, for the port to resume: with orbax
    # hidden, as the reference then writes the npz bundle both read.
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax", None)
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        ref_engine.fit_lloyd_sharded(X, K, mesh=ref_meshes[4], init=C0,
                                     tol=0.0, max_iter=7,
                                     ckpt_dir=f"{d}/ref", ckpt_every=3)
    with open(f"{d}/ref/meta.json", encoding="utf-8") as f:
        out = {"dir": d, "ref meta": json.load(f)}
    out[4] = run_world(4, _dp4_cases(d))
    out[2] = run_world(2, _dp2_cases(d))
    return out


def _ok(res):
    assert "error" not in res, res["error"]
    assert "preempted" not in res, res
    return res


def _assert_same(got, want, exact=False):
    """``want`` a port result or a reference state."""
    _ok(got)
    get = (lambda k: want[k]) if isinstance(want, dict) else \
        (lambda k: np.asarray(getattr(want, k)))
    np.testing.assert_array_equal(got["labels"], get("labels"))
    if exact:
        np.testing.assert_array_equal(got["centroids"], get("centroids"))
    else:
        np.testing.assert_allclose(got["centroids"], get("centroids"),
                                   atol=ATOL)
    assert got["n_iter"] == int(get("n_iter"))


def test_port_fit_is_the_references(worlds, ref_plain):
    _assert_same(worlds[4]["plain"], ref_plain)


def test_classic_elastic_matches_fused(worlds, ref_plain):
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    got = worlds[4]["elastic"]
    _assert_same(got, worlds[4]["plain"])
    _assert_same(got, ref_plain)
    assert latest_step(f"{worlds['dir']}/e") == got["n_iter"]


def test_mesh_migration_dp_to_tp(worlds, ref_plain):
    """A partial fit on the dp-4 mesh resumed on a (1, 2) DP × TP mesh: the
    bundle carries global f32 centroids, not shards, so the new mesh
    re-places them like any explicit init (and its own bundles gather the
    model ranks' slices)."""
    from kmeans_tpu_torch.utils.checkpoint import load_array_checkpoint

    got = worlds[2]["resume on tp"]
    _assert_same(got, ref_plain)
    arrays, meta = load_array_checkpoint(f"{worlds['dir']}/pt")
    assert meta["extra"]["layout"] == "dp1.tp2"
    np.testing.assert_array_equal(arrays["centroids"], got["centroids"])


def test_mesh_migration_dp4_to_dp2(worlds, ref_plain):
    """A partial fit on dp 4 resumed on dp 2."""
    part = _ok(worlds[4]["partial"])
    assert part["n_iter"] == 7 and not part["converged"]
    got = worlds[2]["resume partial"]
    _assert_same(got, ref_plain)
    assert got["resumes"]["ok"] == 1


def test_preempt_resume_scatter_to_allreduce_shrunk(worlds, ref_plain):
    """SIGTERM on every rank mid-run with comm='scatter' (k = 10 divides
    neither dp), resumed on dp 2 with comm='allreduce'."""
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    cut = worlds[4]["cut scatter"]
    assert cut["preempted"] == 8
    assert f"--resume {worlds['dir']}/s" in cut["hint"]
    assert latest_step(f"{worlds['dir']}/s") == _ok(
        worlds[2]["resume scatter cut"])["n_iter"]
    got = worlds[2]["resume scatter cut"]
    assert got["resumes"]["ok"] == 1
    _assert_same(got, ref_plain)


def test_signal_on_one_rank_stops_every_rank(worlds, ref_meshes):
    """SIGTERM reaches rank 0 alone: the ranks all-reduce the flag at the
    boundary, so all of them stop at sweep 8 (the world ends: a rank left
    behind would wait in a collective) and rank 0's bundle resumes to the
    uninterrupted classic fit."""
    assert worlds[4]["cut rank 0"]["preempted"] == 8
    want = ref_engine.fit_lloyd_sharded(
        X, K, mesh=ref_meshes[4], init=C0, tol=0.0, max_iter=MAX_IT,
        config=RefConfig(k=K, tol=0.0, update="matmul"))
    _assert_same(worlds[2]["resume rank 0 cut"], want)


@pytest.mark.parametrize("comm", COMMS)
@pytest.mark.parametrize("update", FLAVOURS)
def test_bounds_family_kill_resume_exact(worlds, update, comm):
    """Preempted at a boundary and resumed: on the same mesh and comm bit
    for bit the uninterrupted elastic run; on the shrunk mesh with the comm
    flipped to allreduce, label-exact (the refresh at each segment start
    re-derives the carried state, so the cadence defines the run)."""
    uncut = _ok(worlds[4][f"uncut {update} {comm}"])
    assert worlds[4][f"cut {update} {comm}"]["preempted"] == 8
    assert worlds[4][f"cut again {update} {comm}"]["preempted"] == 8
    same = worlds[4][f"same mesh {update} {comm}"]
    _assert_same(same, uncut, exact=True)
    np.testing.assert_array_equal(same["counts"], uncut["counts"])
    assert same["inertia"] == uncut["inertia"]
    _assert_same(worlds[2][f"shrunk {update} {comm}"], uncut)


def test_resume_fingerprint_mismatch_refused(worlds):
    got = worlds[4]["mismatch"]
    assert got["error"].startswith("ValueError: refusing to resume")
    assert "fingerprint" in got["error"]
    assert got["resumes"]["refused"] == 1


def test_resume_missing_checkpoint_errors(worlds):
    got = worlds[4]["missing"]
    assert got["error"].startswith("FileNotFoundError")
    assert got["resumes"]["error"] == 1


def test_resume_converged_checkpoint_short_circuits(worlds, ref_plain):
    done = _ok(worlds[4]["elastic"])
    assert done["converged"]
    again = worlds[2]["resume converged"]
    assert again["resumes"]["finished"] == 1
    assert again["n_iter"] == done["n_iter"]
    _assert_same(again, ref_plain)


@pytest.mark.parametrize("case,match", [
    ("bad every", "ckpt_every"), ("resume no dir", "resume"),
    ("resume other dir", "resume")])
def test_elastic_argument_validation(worlds, ref_meshes, case, match,
                                     tmp_path):
    """Each refusal is the reference's line."""
    got = worlds[4][case]["error"]
    assert got.startswith("ValueError") and match in got
    kw = {"bad every": dict(ckpt_dir=str(tmp_path / "v"), ckpt_every=-1),
          "resume no dir": dict(resume=True),
          "resume other dir": dict(ckpt_dir="/v", resume="/other")}[case]
    with pytest.raises(ValueError) as e:
        ref_engine.fit_lloyd_sharded(X, K, mesh=ref_meshes[4], init=C0,
                                     **kw)
    if case != "resume other dir":
        assert got == f"ValueError: {e.value}"


def test_reference_bundle_resumes_in_the_port(worlds, ref_plain):
    """A bundle the reference cut (7 sweeps on its dp-4 mesh) resumes in
    the port's dp-4 world to the reference's uninterrupted fit."""
    got = worlds[4]["from ref"]
    assert got["resumes"]["ok"] == 1
    _assert_same(got, ref_plain)


def test_port_bundle_resumes_in_the_reference(worlds, ref_meshes, ref_plain,
                                              tmp_path):
    """A bundle the port cut resumes in ``kmeans_tpu.parallel.
    fit_lloyd_sharded`` to the reference's uninterrupted fit."""
    ck = str(tmp_path / "pr")
    shutil.copytree(f"{worlds['dir']}/pr", ck)
    got = ref_engine.fit_lloyd_sharded(X, K, mesh=ref_meshes[2], tol=0.0,
                                       max_iter=MAX_IT, resume=ck,
                                       ckpt_every=3)
    np.testing.assert_array_equal(np.asarray(got.labels),
                                  np.asarray(ref_plain.labels))
    np.testing.assert_allclose(np.asarray(got.centroids),
                               np.asarray(ref_plain.centroids), atol=ATOL)
    assert int(got.n_iter) == int(ref_plain.n_iter)


def test_fingerprints_are_the_references(worlds):
    """The bundle's fingerprint, key for key, in both packages' bundles
    (the JSON round trip included), and the function itself over configs."""
    with open(f"{worlds['dir']}/pr/meta.json", encoding="utf-8") as f:
        metas = [json.load(f), worlds["ref meta"]]
    assert metas[0]["extra"]["fingerprint"] == \
        metas[1]["extra"]["fingerprint"]
    for key in ("engine", "layout", "comm", "update", "converged"):
        assert metas[0]["extra"][key] == metas[1]["extra"][key], key
    for kw in (dict(), dict(compute_dtype="bfloat16", update="delta",
                            seed=3, tol=1e-3, empty="farthest")):
        port = port_engine.engine_fingerprint(KMeansConfig(k=K, **kw),
                                              k=K, d=16)
        ref = ref_fingerprint(RefConfig(k=K, **kw), k=K, d=16)
        assert port == ref
        assert json.loads(json.dumps(port)) == ref
    import torch

    assert port_engine.engine_fingerprint(
        KMeansConfig(k=K, compute_dtype=torch.bfloat16), k=K,
        d=16)["compute_dtype"] == "bfloat16"


def test_engine_checkpoint_families_on_the_registry():
    from kmeans_tpu_torch import obs

    port_engine._ENGINE_CKPT_SECONDS.observe(0.01)
    port_engine._ENGINE_RESUMES_TOTAL.labels(outcome="ok")
    text = obs.REGISTRY.expose()
    for fam in ("kmeans_tpu_engine_ckpt_seconds",
                "kmeans_tpu_engine_resumes_total"):
        assert f"# TYPE {fam}" in text, fam
    assert type(port_engine._ENGINE_CKPT_SECONDS).__name__ == \
        type(ref_engine._ENGINE_CKPT_SECONDS).__name__
    assert port_engine.ENGINE_CKPT_EVERY == ref_engine.ENGINE_CKPT_EVERY
