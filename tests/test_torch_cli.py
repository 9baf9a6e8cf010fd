"""The port's ``train`` command against the JAX package's, on the CPU.

Each behaviour test of the reference's CLI suite (``tests/test_cli.py``,
the CLI tests of ``tests/test_obs.py`` and ``tests/test_tracing.py``) runs
its body once through each package's ``main`` (``side``; the port's with
``--device cpu`` appended).  The
flag guards run through both ``main``s and must give the same exit code and
the same stderr, line for line.  A fit through both on the same
well-separated ``--input`` must give result lines with the same keys and
inertia within ``INERTIA_RTOL`` (the k-means++ draws differ: ``jax.random``
against a ``torch.Generator``, but on these blobs both reach the same
partition).  ``--out`` writes the reference's bytes for the same rows and
labels.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from kmeans_tpu import cli as ref_cli
from kmeans_tpu import session as ref_session
from kmeans_tpu.obs import read_events
from kmeans_tpu_torch import cli as port_cli
from kmeans_tpu_torch import session as port_session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Final inertia of the two packages' fits of the same separated blobs: the
#: same partition, f32 sums in another order.
INERTIA_RTOL = 1e-4
#: ``sweep``'s floats: scores taken at two packages' fits from one start
#: (their centroids agree to 1e-5, which Davies–Bouldin's centroid
#: distances amplify above the blob count); ``SWEEP_ATOL`` for the gap
#: rows' logs and spreads near 0; inertia also to 1e-6 of Σ‖x‖².
SWEEP_RTOL = 1e-4
SWEEP_ATOL = 1e-5
SIDES = ("ref", "port")


@pytest.fixture(autouse=True)
def npz_format(monkeypatch):
    """Hide orbax, so the reference's runner checkpoints are npz bundles."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def _main(side):
    if side == "ref":
        return ref_cli.main
    return lambda argv: port_cli.main(list(argv) + ["--device", "cpu"])


def _run(side, capsys, argv):
    rc = _main(side)(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _separated(seed, n, d, k, std=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(k, d))
    lab = rng.integers(0, k, size=n)
    return (centers[lab] + std * rng.normal(size=(n, d))).astype(np.float32)


@pytest.fixture()
def cifar_like_npy(tmp_path):
    """(2048, 3072) float32 features on disk, the CIFAR-10 feature width at
    a test-sized row count."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(10, 3072)).astype(np.float32) * 3
    lab = rng.integers(0, 10, size=(2048,))
    x = (centers[lab] + rng.normal(size=(2048, 3072))).astype(np.float32)
    p = tmp_path / "cifar_like.npy"
    np.save(p, x)
    return str(p)


# ---------------------------------------------------------------------------
# tests/test_cli.py, once per package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_train_input_npy_end_to_end(side, cifar_like_npy, tmp_path, capsys):
    out_json = str(tmp_path / "board.json")
    rc, out, _ = _run(side, capsys, [
        "train", "--input", cifar_like_npy, "--k", "10",
        "--max-iter", "10", "--max-cards", "50", "--out", out_json,
    ])
    assert rc in (0, None)
    res = json.loads(out.splitlines()[0])
    assert (res["n"], res["d"], res["k"]) == (2048, 3072, 10)
    assert res["n_iter"] >= 1
    doc = json.loads(open(out_json).read())
    assert sorted(doc) == ["cards", "centroids", "meta"]
    assert len(doc["cards"]) == 50


@pytest.mark.parametrize("side", SIDES)
def test_train_minibatch_rejects_max_iter(side, capsys):
    rc, _, err = _run(side, capsys, [
        "train", "--model", "minibatch", "--max-iter", "50",
    ])
    assert rc == 2
    assert "--steps" in err


@pytest.mark.parametrize("side", SIDES)
def test_train_lloyd_rejects_steps(side, capsys):
    rc, _, err = _run(side, capsys, ["train", "--steps", "5"])
    assert rc == 2
    assert "minibatch" in err


@pytest.mark.parametrize("side", SIDES)
def test_train_minibatch_steps_take_effect(side, capsys):
    rc, out, _ = _run(side, capsys, [
        "train", "--model", "minibatch", "--n", "512", "--d", "8",
        "--k", "3", "--steps", "7", "--batch-size", "64",
    ])
    assert rc in (0, None)
    assert json.loads(out.splitlines()[0])["n_iter"] == 7


@pytest.mark.parametrize("side", SIDES)
def test_train_accel_anderson_nested(side, capsys):
    """n = 20000, more than twice the default nested_start, so the ladder
    runs rungs (8192, 16384)."""
    rc, out, _ = _run(side, capsys, [
        "train", "--n", "20000", "--d", "8", "--k", "4",
        "--accel", "anderson", "--schedule", "nested",
        "--anderson-m", "4",
    ])
    assert rc in (0, None)
    res = json.loads(out.splitlines()[0])
    assert res["mode"] == "accelerated"
    assert np.isfinite(res["inertia"]) and res["n_iter"] >= 1


@pytest.mark.parametrize("side", SIDES)
def test_train_accel_flag_guards(side, capsys):
    base = ["train", "--n", "200", "--d", "4", "--k", "3"]
    # --accel with a family that would ignore it.
    rc, _, err = _run(side, capsys, base + ["--model", "gmm", "--accel",
                                            "anderson"])
    assert rc == 2 and "--accel" in err
    rc, _, err = _run(side, capsys, base + ["--anderson-m", "4"])
    assert rc == 2 and "--anderson-m" in err
    rc, _, err = _run(side, capsys, base + ["--model", "kernel",
                                            "--schedule", "nested"])
    assert rc == 2 and "--schedule" in err
    rc, _, err = _run(side, capsys, base + ["--model", "minibatch",
                                            "--schedule", "nested",
                                            "--steps", "5"])
    assert rc == 2 and "ladder" in err
    rc, _, err = _run(side, capsys, base + ["--model", "lloyd", "--accel",
                                            "beta", "--progress"])
    assert rc == 2 and "anderson" in err


@pytest.mark.parametrize("side", SIDES)
def test_train_accel_runner_telemetry(side, tmp_path, capsys):
    tpath = str(tmp_path / "accel.jsonl")
    rc, out, _ = _run(side, capsys, [
        "train", "--n", "3000", "--d", "6", "--k", "4",
        "--model", "lloyd", "--accel", "anderson",
        "--telemetry", tpath,
    ])
    assert rc in (0, None)
    events = [json.loads(line) for line in open(tpath)]
    iters = [e for e in events if e.get("event") == "iter"]
    assert iters
    assert all(e.get("accel") in ("accepted", "rejected", "fallback")
               for e in iters)


@pytest.mark.parametrize("side", SIDES)
def test_train_minibatch_nested_schedule(side, capsys):
    rc, out, _ = _run(side, capsys, [
        "train", "--n", "4000", "--d", "6", "--k", "4",
        "--model", "minibatch", "--schedule", "nested",
        "--max-iter", "50",
    ])
    assert rc in (0, None)
    res = json.loads(out.splitlines()[0])
    assert res["mode"] == "minibatch"
    assert np.isfinite(res["inertia"])


@pytest.mark.parametrize("side", SIDES)
def test_cli_train_update_delta(side, capsys):
    rc = _main(side)([
        "train", "--n", "2000", "--d", "8", "--k", "4",
        "--update", "delta", "--max-iter", "30",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["mode"] == "lloyd" and out["converged"]


@pytest.mark.parametrize("side", SIDES)
def test_cli_runner_resume_corrupt_one_line_error(side, tmp_path, capsys):
    data = tmp_path / "x.npy"
    np.save(data, np.random.default_rng(0).normal(
        size=(200, 4)).astype(np.float32))
    torn = tmp_path / "ck"
    torn.mkdir()
    (torn / "meta.json").write_text("{torn")
    for resume in (str(torn), str(tmp_path / "nope")):
        rc, _, err = _run(side, capsys, [
            "train", "--input", str(data), "--k", "3", "--max-iter", "2",
            "--resume", resume,
        ])
        assert rc == 2, resume
        assert "Traceback" not in err
        assert "error: cannot resume" in err


@pytest.mark.parametrize("side", SIDES)
def test_cli_checkpoint_keep_creates_step_dirs(side, tmp_path, capsys):
    """The streamed fit's retention: two step-tagged siblings kept."""
    data = tmp_path / "x.npy"
    np.save(data, np.random.default_rng(0).normal(
        size=(400, 4)).astype(np.float32))
    rc, _, err = _run(side, capsys, [
        "train", "--input", str(data), "--k", "3", "--stream",
        "--model", "minibatch", "--steps", "4", "--batch-size", "64",
        "--checkpoint", str(tmp_path / "ck"), "--checkpoint-every", "1",
        "--checkpoint-keep", "2",
    ])
    tagged = sorted(p for p in os.listdir(tmp_path)
                    if p.startswith("ck.step-"))
    assert rc == 0, err
    assert tagged == ["ck.step-00000002", "ck.step-00000003"]


@pytest.mark.parametrize("side", SIDES)
def test_cli_checkpoint_keep_reaches_lloyd_runner(side, tmp_path, capsys):
    data = tmp_path / "x.npy"
    np.save(data, np.random.default_rng(0).normal(
        size=(400, 4)).astype(np.float32))
    rc, _, _ = _run(side, capsys, [
        "train", "--input", str(data), "--k", "3", "--max-iter", "4",
        "--tol", "0",
        "--checkpoint", str(tmp_path / "ck"), "--checkpoint-every", "1",
        "--checkpoint-keep", "2",
    ])
    assert rc == 0
    tagged = [p for p in os.listdir(tmp_path) if p.startswith("ck.step-")]
    assert len(tagged) == 2


# ---------------------------------------------------------------------------
# tests/test_obs.py and tests/test_tracing.py CLI tests, once per package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_cli_fit_telemetry_one_event_per_iteration(side, tmp_path):
    out = str(tmp_path / "out.jsonl")
    rc = _main(side)(["fit", "--n", "300", "--d", "2", "--k", "3",
                      "--telemetry", out])
    assert rc == 0
    events = read_events(out)
    iters = [e for e in events if e["event"] == "iter"]
    assert len(iters) >= 1
    assert [e["iteration"] for e in iters] == \
        list(range(1, len(iters) + 1))


@pytest.mark.parametrize("side", SIDES)
def test_cli_failed_resume_preserves_existing_telemetry(side, tmp_path,
                                                        capsys):
    out = tmp_path / "out.jsonl"
    prior = '{"event":"iter","iteration":1}\n'
    out.write_text(prior, encoding="utf-8")
    rc = _main(side)(["fit", "--n", "100", "--d", "2", "--k", "2",
                      "--telemetry", str(out),
                      "--resume", str(tmp_path / "no_such_ckpt")])
    assert rc == 2
    assert "cannot resume" in capsys.readouterr().err
    assert out.read_text(encoding="utf-8") == prior


@pytest.mark.parametrize("side", SIDES)
def test_cli_failed_stream_resume_preserves_existing_telemetry(
        side, tmp_path, capsys):
    """A refused streamed resume leaves an earlier run's telemetry as it
    was."""
    data = np.random.default_rng(0).normal(size=(1000, 3)) \
        .astype(np.float32)
    npy = str(tmp_path / "x.npy")
    np.save(npy, data)
    out = tmp_path / "out.jsonl"
    ck = str(tmp_path / "ck")
    prior = '{"event":"iter","iteration":1}\n'
    out.write_text(prior, encoding="utf-8")
    rc = _main(side)(["train", "--stream", "--input", npy, "--k", "2",
                      "--steps", "3", "--batch-size", "128",
                      "--checkpoint", ck, "--telemetry", str(out)])
    assert rc == 0
    prior = out.read_text(encoding="utf-8")
    assert prior.count("\n") == 3
    capsys.readouterr()
    rc = _main(side)(["train", "--stream", "--input", npy, "--k", "2",
                      "--steps", "3", "--batch-size", "512",
                      "--resume", ck, "--telemetry", str(out)])
    assert rc == 2
    err = capsys.readouterr().err
    assert "contradicts" in err
    assert out.read_text(encoding="utf-8") == prior


@pytest.mark.parametrize("side", SIDES)
def test_cli_telemetry_requires_step_paced_loop(side, tmp_path, capsys):
    rc = _main(side)(["fit", "--model", "gmm", "--n", "100", "--d", "2",
                      "--k", "2", "--telemetry", str(tmp_path / "x.jsonl")])
    assert rc == 2
    assert "step-paced" in capsys.readouterr().err
    rc = _main(side)(["fit", "--model", "accelerated", "--n", "100", "--d",
                      "2", "--k", "2", "--telemetry",
                      str(tmp_path / "x.jsonl")])
    assert rc == 2 and "step-paced" in capsys.readouterr().err


@pytest.mark.parametrize("side", SIDES)
def test_cli_fit_trace_and_telemetry_cross_reference(side, tmp_path):
    out = str(tmp_path / "out.json")
    tel = str(tmp_path / "run.jsonl")
    rc = _main(side)(["fit", "--n", "1500", "--d", "4", "--k", "3",
                      "--trace", out, "--telemetry", tel])
    assert rc == 0
    doc = json.loads(open(out, encoding="utf-8").read())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    trace_ids = {e["args"]["trace_id"] for e in evs}
    (run_span,) = [e for e in evs if e["name"] == "lloyd.run"]
    events = read_events(tel)
    iters = [e for e in events if e["event"] == "iter"]
    assert iters
    assert sum(e["name"] == "iteration" for e in evs) == len(iters)
    for e in events:
        assert e["trace_id"] in trace_ids
        assert e["run_id"] == run_span["args"]["run_id"]


# ---------------------------------------------------------------------------
# The port against the reference
# ---------------------------------------------------------------------------

GUARDS = [
    ["train", "--model", "minibatch", "--max-iter", "50"],
    ["train", "--steps", "5"],
    ["train", "--anderson-m", "4"],
    ["train", "--model", "minibatch", "--schedule", "nested", "--steps",
     "5"],
    ["train", "--model", "lloyd", "--accel", "beta", "--progress"],
    ["train", "--model", "lloyd", "--accel", "anderson"],
    ["train", "--model", "minibatch", "--accel", "anderson"],
    ["train", "--schedule", "nested"],
    ["train", "--model", "lloyd", "--minibatch"],
    ["train", "--model", "minibatch", "--no-minibatch"],
    ["train", "--update", "delta", "--minibatch"],
    ["train", "--model", "accelerated", "--update", "yinyang"],
    ["train", "--update", "hamerly", "--accel", "anderson", "--progress"],
    ["train", "--yinyang-groups", "0"],
    ["train", "--update", "delta", "--yinyang-groups", "4"],
    ["train", "--covariance-type", "tied"],
    ["train", "--trim-fraction", "0.1"],
    ["train", "--model", "trimmed", "--trim-fraction", "1.5"],
    ["train", "--model", "trimmed", "--trim-fraction", "-0.1"],
    ["train", "--model", "trimmed", "--update", "delta"],
    ["train", "--model", "trimmed", "--accel", "beta"],
    ["train", "--model", "trimmed", "--progress"],
    ["train", "--model", "trimmed", "--schedule", "nested"],
    ["train", "--model", "trimmed", "--steps", "5"],
    ["train", "--model", "accelerated", "--progress"],
    ["train", "--model", "minibatch", "--steps", "0"],
    ["train", "--model", "minibatch", "--batch-size", "0"],
    ["train", "--profile", "a", "--xla-trace", "b"],
    # The sharded engine's guards (--mesh above 1, --comm).
    ["train", "--model", "lloyd", "--accel", "anderson", "--progress",
     "--mesh", "2"],
    ["train", "--model", "minibatch", "--schedule", "nested", "--mesh",
     "2"],
    ["train", "--update", "delta", "--progress", "--mesh", "2"],
    ["train", "--update", "yinyang", "--telemetry", "t.jsonl", "--mesh",
     "2"],
    ["train", "--comm", "scatter"],
    ["train", "--comm", "allreduce", "--mesh", "1"],
    ["train", "--comm", "scatter", "--model", "minibatch", "--mesh", "2"],
    ["train", "--comm", "scatter", "--mesh", "2", "--progress"],
    ["train", "--coreset", "50", "--mesh", "2"],
    # The elastic checkpoint's guards (--ckpt-dir, --ckpt-every), and
    # --merge-k's before the fit.
    ["train", "--ckpt-dir", "ck"],
    ["train", "--ckpt-every", "3"],
    ["train", "--ckpt-dir", "ck", "--model", "accelerated", "--mesh", "2"],
    ["train", "--ckpt-dir", "ck", "--mesh", "2", "--progress"],
    ["train", "--ckpt-dir", "ck", "--resume", "other", "--mesh", "2"],
    ["train", "--ckpt-dir", "ck", "--ckpt-every", "0", "--mesh", "2"],
    ["train", "--merge-k", "0"],
    ["train", "--merge-k", "3", "--k", "3"],
    # The families of ROADMAP A9a: their flags and tables.
    ["train", "--model", "spherical", "--update", "delta"],
    ["train", "--model", "bisecting", "--update", "matmul"],
    ["train", "--model", "xmeans", "--comm", "scatter"],
    ["train", "--model", "gmeans", "--coreset", "50"],
    ["train", "--model", "spherical", "--trim-fraction", "0.1"],
    ["train", "--model", "bisecting", "--progress"],
    ["sweep", "--criterion", "bic"],
    ["sweep", "--criterion", "gap", "--model", "accelerated"],
    ["sweep", "--criterion", "elbow", "--k-max", "3"],
]


@pytest.mark.parametrize("argv", GUARDS, ids=lambda a: " ".join(a[1:]))
def test_flag_guards_equal_the_references(argv, capsys):
    """Each guard exits 2 with the reference's stderr, line for line, and
    needs no card."""
    ref = _run("ref", capsys, argv)
    got = port_cli.main(argv)           # no --device: a guard needs no card
    err = capsys.readouterr().err
    assert (got, err) == (ref[0], ref[2])
    assert got == 2 and len(err.strip().splitlines()) == 1


def test_input_errors_equal_the_references(tmp_path, capsys):
    garbage = tmp_path / "garbage.npy"
    garbage.write_bytes(b"this is not an npy file at all")
    flat = tmp_path / "flat.npy"
    np.save(flat, np.zeros(10, np.float32))
    for path in (str(tmp_path / "missing.npy"), str(garbage), str(flat)):
        argv = ["train", "--input", path, "--k", "3"]
        ref = _run("ref", capsys, argv)
        got = _run("port", capsys, argv)
        assert got[0] == ref[0] == 2 and got[2] == ref[2], path


@pytest.mark.parametrize("runner", [False, True], ids=["fused", "runner"])
@pytest.mark.parametrize("update", ["auto", "delta", "yinyang"])
def test_result_line_matches_the_references(update, runner, tmp_path,
                                            capsys):
    x = _separated(21, 2000, 8, 4)
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    argv = ["train", "--input", npy, "--k", "4", "--update", update,
            "--tol", "1e-6"]
    if runner:
        argv += ["--progress"]
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    rc_p, out_p, err_p = _run("port", capsys, argv)
    assert rc_r == rc_p == 0, err_p
    ref, got = json.loads(out_r), json.loads(out_p)
    assert list(got) == list(ref)
    assert {k: got[k] for k in ("n", "d", "k", "mode", "converged")} == \
        {k: ref[k] for k in ("n", "d", "k", "mode", "converged")}
    np.testing.assert_allclose(got["inertia"], ref["inertia"],
                               rtol=INERTIA_RTOL)
    if runner:
        lines = [json.loads(ln) for ln in err_p.splitlines()]
        ref_lines = [json.loads(ln) for ln in err_r.splitlines()]
        assert all(list(ln) == list(ref_lines[0]) for ln in lines)
        assert lines[-1]["iteration"] == got["n_iter"]


def test_export_bytes_equal_the_references(tmp_path, capsys):
    """``--out`` is the reference's document: the same rows and labels give
    the same bytes through either package's session copy, and the port's
    ``train --out`` writes that document for its fit's labels."""
    from kmeans_tpu_torch import KMeansConfig, fit_lloyd

    x = _separated(22, 600, 5, 3)
    for labels in (np.arange(600) % 3, np.where(np.arange(600) % 7 == 0,
                                                -1, np.arange(600) % 2)):
        for n_cards in (50, 500):
            mine = port_session.export_json(port_session.dataset_to_document(
                x[:n_cards], labels[:n_cards], max_cards=n_cards))
            ref = ref_session.export_json(ref_session.dataset_to_document(
                x[:n_cards], labels[:n_cards], max_cards=n_cards))
            assert mine == ref
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    out = str(tmp_path / "board.json")
    assert _main("port")(["train", "--input", npy, "--k", "3",
                          "--max-cards", "120", "--out", out]) == 0
    capsys.readouterr()
    st = fit_lloyd(x, 3, config=KMeansConfig(k=3, max_iter=100, tol=1e-4,
                                            seed=0), device="cpu")
    want = ref_session.export_json(ref_session.dataset_to_document(
        x[:120], st.labels.numpy()[:120], max_cards=120))
    assert open(out, encoding="utf-8").read() == want


PAIRWISE_LINES = [
    ["--stream", "--input", "x.npy", "--model", "kmedoids"],
    ["--model", "kernel"],
    ["--model", "spectral"],
    ["--pca", "1", "--model", "kernel"],
    ["--whiten", "--model", "spectral"],
]


@pytest.mark.parametrize("extra", PAIRWISE_LINES,
                         ids=[" ".join(e) for e in PAIRWISE_LINES])
def test_pairwise_train_lines_are_the_references(extra, tmp_path, capsys,
                                                 monkeypatch):
    """``train --model kmedoids|kernel|spectral`` on 100 rows: the port's
    draws replayed through the reference (the spectral fit from the port's
    embedding), the same exit code and result line (the objective within
    ``INERTIA_RTOL``); a flag the family cannot take gives the
    reference's guard line."""
    from torch_replay import replay_pairwise

    npy = str(tmp_path / "x.npy")
    np.save(npy, np.round(_separated(47, 100, 2, 2, std=0.4) * 8.0) / 8.0)
    argv = ["train", "--input", npy, "--k", "2"] + [
        a for a in extra if a not in ("--input", "x.npy")]
    family = extra[extra.index("--model") + 1]
    rc_p, out_p, err_p = replay_pairwise(
        monkeypatch, family, lambda: _run("port", capsys, argv))
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert (rc_p or 0) == (rc_r or 0), err_p + err_r
    if rc_p:
        assert rc_p == 2 and (out_p, err_p) == (out_r, err_r)
        return
    ref, got = json.loads(out_r), json.loads(out_p)
    assert list(got) == list(ref)
    same = ("n", "d", "k", "mode", "n_iter", "converged")
    assert {f: got[f] for f in same} == {f: ref[f] for f in same}
    np.testing.assert_allclose(got["inertia"], ref["inertia"],
                               rtol=INERTIA_RTOL)


def test_device_defaults_to_the_card(capsys):
    """``--device`` defaults to ``cuda``: without a card the fit exits 2
    with one line naming ``--device cpu`` (no fallback), after the flag
    guards."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = port_cli.main(["train", "--n", "100", "--d", "2", "--k", "2"])
    err = capsys.readouterr().err
    assert rc == 2 and "no CUDA device" in err and "--device cpu" in err
    assert len(err.strip().splitlines()) == 1


def test_sigterm_cuts_a_checkpoint_and_the_resume_finishes(tmp_path):
    """The preemption drill in a child process: SIGTERM once a progress
    line reports iteration >= 3 exits 3 with a "resume with" line and a
    checkpoint at that step; ``--resume`` for the rest finishes at the
    uninterrupted run's iteration count and inertia."""
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(23, 20000, 16, 8, std=3.0))
    ck = str(tmp_path / "ck")
    base = [sys.executable, "-m", "kmeans_tpu_torch.cli", "train",
            "--device", "cpu", "--input", npy, "--k", "8", "--tol", "-1"]
    total = 30
    full = subprocess.run(base + ["--max-iter", str(total)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=120)
    assert full.returncode == 0, full.stderr
    proc = subprocess.Popen(
        base + ["--max-iter", str(total), "--progress", "--checkpoint", ck,
                "--checkpoint-every", "1000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        for line in proc.stderr:
            if line.startswith("{") and json.loads(line)["iteration"] >= 3:
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 3, err
    assert f"resume with: --resume {ck}" in err.splitlines()
    step = latest_step(ck)
    assert 3 <= step < total and f"at iteration {step};" in err
    resumed = subprocess.run(
        base + ["--max-iter", str(total - step), "--resume", ck],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    got, want = json.loads(resumed.stdout), json.loads(full.stdout)
    assert got["n_iter"] == want["n_iter"] == total
    np.testing.assert_allclose(got["inertia"], want["inertia"],
                               rtol=INERTIA_RTOL)


# ---------------------------------------------------------------------------
# --model trimmed, and serve's --persist-dir
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", SIDES)
def test_train_trimmed_family(side, tmp_path, capsys):
    """tests/test_cli.py's: 5% of 200 rows export as unassigned cards,
    without a board position."""
    out_json = str(tmp_path / "trimmed.json")
    rc, out, _ = _run(side, capsys, [
        "train", "--n", "200", "--d", "2", "--k", "3", "--model", "trimmed",
        "--trim-fraction", "0.05", "--max-iter", "20", "--out", out_json,
    ])
    assert rc == 0
    res = json.loads(out.splitlines()[0])
    assert res["mode"] == "trimmed" and np.isfinite(res["inertia"])
    doc = json.loads(open(out_json).read())
    unassigned = [c for c in doc["cards"] if c["assignedTo"] is None]
    assert len(unassigned) == 10
    for c in unassigned:
        assert f"pos:{c['id']}" not in doc["meta"]


def test_train_trimmed_matches_the_references(tmp_path, capsys):
    """The same separated ``--input`` through both CLIs: the same
    result-line keys, n and k, the same 8 rows trimmed in both exports, and
    the inertia within INERTIA_RTOL (the draws differ; on these blobs both
    reach the same partition)."""
    x = _separated(24, 400, 3, 3)
    npy = str(tmp_path / "x.npy")
    np.save(npy, x)
    outs = []
    for side in SIDES:
        out_json = str(tmp_path / f"{side}.json")
        rc, out, _ = _run(side, capsys, [
            "train", "--input", npy, "--k", "3", "--model", "trimmed",
            "--trim-fraction", "0.02", "--tol", "1e-6", "--out", out_json,
            "--max-cards", "400"])
        assert rc == 0
        doc = json.loads(open(out_json).read())
        outs.append((json.loads(out), [c["assignedTo"] is None
                                       for c in doc["cards"]]))
    (ref, ref_un), (got, got_un) = outs
    assert list(got) == list(ref)
    assert {k: got[k] for k in ("n", "d", "k", "mode")} == \
        {k: ref[k] for k in ("n", "d", "k", "mode")}
    np.testing.assert_allclose(got["inertia"], ref["inertia"],
                               rtol=INERTIA_RTOL)
    assert got_un == ref_un and sum(got_un) == 8


@pytest.mark.parametrize("extra,want", [([], ".kmeans_rooms"),
                                         (["--persist-dir", ""], None),
                                         (["--persist-dir", "d"], "d")])
def test_serve_persist_dir_defaults_to_the_references(extra, want,
                                                      monkeypatch, capsys):
    """``serve --persist-dir`` defaults to the reference's ``.kmeans_rooms``
    ('' keeps rooms in memory): both CLIs hand ``serve`` the same value."""
    import kmeans_tpu.serve as ref_serve

    from kmeans_tpu_torch.serve import server as port_server

    got = {}
    for side, mod in (("ref", ref_serve), ("port", port_server)):
        monkeypatch.setattr(mod, "serve", lambda *a, _side=side, **kw:
                            got.setdefault(_side, kw["persist_dir"]))
    assert ref_cli.main(["serve"] + extra) == 0
    assert port_cli.main(["serve", "--device", "cpu"] + extra) == 0
    capsys.readouterr()
    assert got == {"ref": want, "port": want}


def test_serve_fleet_passes_persist_dir_to_the_workers(tmp_path,
                                                        monkeypatch):
    """``serve --workers N`` hands ``--persist-dir`` to the supervisor's
    config, which every worker's server reads (the reference's)."""
    from kmeans_tpu_torch.serve import fleet

    got = {}

    class Sup:
        def __init__(self, config, workers, device):
            got.update(config=config, workers=workers, device=device)

        def run(self):
            return 0

    monkeypatch.setattr(fleet, "FleetSupervisor", Sup)
    rooms = str(tmp_path / "rooms")
    assert port_cli.main(["serve", "--workers", "3", "--port", "8799",
                          "--device", "cpu", "--persist-dir", rooms]) == 0
    assert got["config"].persist_dir == rooms and got["workers"] == 3
    assert port_cli.main(["serve", "--workers", "2", "--port", "8799",
                          "--device", "cpu", "--persist-dir", ""]) == 0
    assert got["config"].persist_dir is None


def _cli_result(argv, env=None, cwd=None):
    """``python -m kmeans_tpu_torch.cli`` in a child process: its exit
    code, result line (None without one), stdout and stderr."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "kmeans_tpu_torch.cli",
                          *argv], cwd=cwd or REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if out.returncode == 0 and lines else None
    return out.returncode, res, out.stdout, out.stderr


MESH_BASE = ["train", "--n", "3000", "--d", "8", "--k", "5", "--seed", "2",
             "--device", "cpu"]


@pytest.mark.parametrize("model,extra", [
    ("lloyd", ["--comm", "scatter"]),
    ("minibatch", ["--steps", "40", "--batch-size", "256"]),
    ("accelerated", ["--accel", "anderson"]),
    ("trimmed", ["--trim-fraction", "0.02"]),
])
def test_train_mesh_runs_gloo_ranks_on_the_cpu(model, extra, tmp_path):
    """``train --mesh 2 --device cpu`` starts two gloo CPU ranks; rank 0
    alone prints the result line and writes ``--out``.  Its fields match
    the ``--mesh 1`` run from the same seed: the sharded k-means++ draws
    what the single-device one draws, so the lloyd, accelerated and trimmed
    fits are the same fits (inertia to the sum order); minibatch's batches
    are per-rank draws, so its inertia only lands near the single-device
    fit's."""
    out1, out2 = str(tmp_path / "one.json"), str(tmp_path / "two.json")
    base = MESH_BASE + ["--model", model]
    one_extra = [a for a in extra if a not in ("--comm", "scatter")]
    rc1, one, _, err1 = _cli_result(base + one_extra + ["--out", out1])
    rc2, two, stdout, err2 = _cli_result(base + extra + ["--mesh", "2",
                                                         "--out", out2])
    assert rc1 == 0 and rc2 == 0, err1 + err2
    assert len(stdout.strip().splitlines()) == 1
    assert two["mesh"] == 2 and "mesh" not in one
    same = ("n", "d", "k", "n_iter", "mode", "converged")
    assert {f: two[f] for f in same} == {f: one[f] for f in same}
    assert sorted(set(two) - {"mesh"}) == sorted(one)
    if model != "minibatch":
        np.testing.assert_allclose(two["inertia"], one["inertia"],
                                   rtol=1e-5)
        assert open(out2).read() == open(out1).read()
    else:
        np.testing.assert_allclose(two["inertia"], one["inertia"],
                                   rtol=0.05)
        json.loads(open(out2).read())
    assert err2.count("wrote ") == 1


def test_train_mesh_joins_an_existing_process_group(tmp_path):
    """Under a ``torch.distributed`` environment (``WORLD_SIZE`` set, as
    ``torchrun`` sets it) each process joins the group as its rank instead
    of starting ranks: rank 0 prints the result line, rank 1 nothing."""
    from kmeans_tpu_torch.parallel.mesh import free_port

    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    argv = [sys.executable, "-m", "kmeans_tpu_torch.cli", *MESH_BASE,
            "--mesh", "2"]
    procs = [subprocess.Popen(argv, cwd=str(tmp_path),
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    assert res["mesh"] == 2 and res["mode"] == "lloyd"
    assert outs[1][0].strip() == ""


def test_train_mesh_usage_errors(monkeypatch, capsys):
    """``--mesh N`` on the cards needs N of them (this host has none), and
    under a process group it must match ``WORLD_SIZE``: one line, exit 2,
    before any rank starts or any group is joined."""
    import torch

    if not torch.cuda.is_available():
        rc = port_cli.main(MESH_BASE[:-2] + ["--mesh", "2"])
        err = capsys.readouterr().err.strip().splitlines()
        assert rc == 2 and len(err) == 1 and "--device cpu" in err[0]
    monkeypatch.setenv("WORLD_SIZE", "2")
    rc = port_cli.main(MESH_BASE + ["--mesh", "3"])
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 2 and err == [
        "error: --mesh 3 contradicts the process group's WORLD_SIZE=2"]


def test_train_stream_mesh_splits_each_batch(tmp_path):
    """``train --stream --mesh 2``: each rank gathers half of every step's
    batch and one all-reduce merges the halves, so the fit is the
    single-device stream's on the same batches (inertia to the sum order),
    and the sharded final pass labels every row alike."""
    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(31, 6000, 8, 5))
    base = ["train", "--stream", "--input", npy, "--k", "5", "--steps",
            "30", "--batch-size", "512", "--seed", "4", "--device", "cpu"]
    out1, out2 = str(tmp_path / "one.json"), str(tmp_path / "two.json")
    rc1, one, _, err1 = _cli_result(base + ["--out", out1])
    rc2, two, _, err2 = _cli_result(base + ["--mesh", "2", "--out", out2])
    assert rc1 == 0 and rc2 == 0, err1 + err2
    assert two.pop("mesh") == 2
    np.testing.assert_allclose(two.pop("inertia"), one.pop("inertia"),
                               rtol=1e-5)
    two.pop("wall_s"), one.pop("wall_s")
    assert two == one
    assert open(out2).read() == open(out1).read()


def test_train_elastic_preempt_and_resume(tmp_path):
    """``--mesh 2 --ckpt-dir D``: SIGTERM on both ranks at the second
    segment boundary exits 3 with the reference's resume hint and a bundle
    at that sweep; ``--resume D`` finishes at the sweep count and inertia
    of the same fit uninterrupted on one device (the same seeding; the
    classic update's elastic run is the fused one), and a missing resume
    directory is one line, exit 2."""
    from kmeans_tpu_torch import KMeansConfig, fit_lloyd
    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.utils.checkpoint import latest_step

    ck = str(tmp_path / "ck")
    base = MESH_BASE + ["--mesh", "2", "--update", "matmul", "--tol", "-1",
                        "--max-iter", "12", "--ckpt-every", "4"]
    x = make_blobs(2, 3000, 8, 5, cluster_std=0.6, device="cpu")[0]
    whole = fit_lloyd(x, 5, config=KMeansConfig(
        k=5, update="matmul", tol=-1.0, max_iter=12, seed=2), device="cpu")
    whole = {"n_iter": int(whole.n_iter), "inertia": float(whole.inertia)}
    env = dict(os.environ, KMEANS_TPU_FAULTS="engine.sweep_merge:sigterm@2")
    rc, _, _, err = _cli_result(base + ["--ckpt-dir", ck], env=env)
    assert rc == 3, err
    assert f"--ckpt-dir {ck} --resume {ck}" in err
    assert latest_step(ck) == 8
    rc, got, _, err = _cli_result(base + ["--ckpt-dir", ck, "--resume", ck])
    assert rc == 0, err
    assert f"resuming sharded fit from {ck} at sweep 8" in err
    assert got["n_iter"] == whole["n_iter"] == 12
    np.testing.assert_allclose(got["inertia"], whole["inertia"], rtol=1e-5)
    nope = str(tmp_path / "nope")
    rc, _, _, err = _cli_result(base + ["--ckpt-dir", nope, "--resume",
                                        nope])
    assert rc == 2 and err.strip().splitlines() == [
        f"error: no checkpoint found at {nope!r} to resume from"]


def _partition(doc):
    """A board document's card → zone assignment as a canonical partition
    (zones renumbered by first appearance)."""
    ids = {}
    return [ids.setdefault(c.get("assignedTo"), len(ids))
            for c in doc["cards"]]


def test_merge_k_matches_the_references(tmp_path, capsys):
    """``--merge-k``: the result line's keys and ``merged_k`` are the
    reference's, and the exported cards fall into the same merged groups
    (the k-means++ draws differ, so the groups are compared as a partition,
    not by number)."""
    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(33, 1500, 6, 6, std=0.2))
    docs = {}
    lines = {}
    for side in SIDES:
        out = str(tmp_path / f"{side}.json")
        rc, stdout, err = _run(side, capsys, [
            "train", "--input", npy, "--k", "6", "--merge-k", "3",
            "--max-cards", "400", "--out", out])
        assert rc in (0, None), err
        lines[side] = json.loads(stdout.splitlines()[0])
        docs[side] = json.load(open(out, encoding="utf-8"))
    assert list(lines["port"]) == list(lines["ref"])
    assert lines["port"]["merged_k"] == lines["ref"]["merged_k"] == 3
    np.testing.assert_allclose(lines["port"]["inertia"],
                               lines["ref"]["inertia"], rtol=INERTIA_RTOL)
    assert _partition(docs["port"]) == _partition(docs["ref"])
    assert len(set(_partition(docs["port"]))) == 3


# ---------------------------------------------------------------------------
# ROADMAP A9a: cli sweep and the spherical, bisecting and auto-k families
# ---------------------------------------------------------------------------

def _replay_inits(monkeypatch, port_module, ref_module, run_port):
    """Run ``run_port`` with the port's inner-fit starts recorded (wrapping
    ``port_module.fit_lloyd``), then wrap ``ref_module.fit_lloyd`` to
    replay them (``tests/torch_replay.py``); returns ``run_port()``."""
    from torch_replay import record_fit_lloyd, replay_fit_lloyd

    inits = []
    with monkeypatch.context() as m:
        record_fit_lloyd(m, port_module, inits)
        out = run_port()
    replay_fit_lloyd(monkeypatch, ref_module, inits)
    return out


@pytest.mark.parametrize("family", ["spherical", "bisecting", "xmeans",
                                    "gmeans"])
def test_train_families_match_the_references(family, tmp_path, capsys,
                                             monkeypatch):
    """``train --model F`` prints the reference's result line: the same
    keys, k (the discovered k for x-means and g-means, with ``--k`` as
    k_max), n_iter and inertia within ``INERTIA_RTOL``.  The splitting
    families' inner starts are the port's, replayed; spherical's k-means++
    draws differ, and on these blobs reach the same partition."""
    import kmeans_tpu.models.bisecting as ref_bisecting
    import kmeans_tpu.models.xmeans as ref_xmeans
    import kmeans_tpu_torch.models.bisecting as port_bisecting

    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(41, 1200, 6, 4, std=0.25))
    argv = ["train", "--input", npy, "--model", family, "--k",
            "8" if family in ("xmeans", "gmeans") else "4"]
    if family == "spherical":
        rc_p, out_p, err_p = _run("port", capsys, argv)
    else:
        ref_module = ref_bisecting if family == "bisecting" else ref_xmeans
        rc_p, out_p, err_p = _replay_inits(
            monkeypatch, port_bisecting, ref_module,
            lambda: _run("port", capsys, argv))
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert rc_r in (0, None) and rc_p == 0, err_p + err_r
    ref, got = json.loads(out_r), json.loads(out_p)
    assert list(got) == list(ref)
    same = ("n", "d", "k", "mode", "n_iter", "converged")
    assert {f: got[f] for f in same} == {f: ref[f] for f in same}
    np.testing.assert_allclose(got["inertia"], ref["inertia"],
                               rtol=INERTIA_RTOL)


@pytest.mark.parametrize("family", ["spherical", "bisecting", "fuzzy", "gmm",
                                    "balanced"])
def test_train_coreset_takes_the_new_families(family, tmp_path, capsys):
    """``--coreset M`` fits spherical, bisecting, fuzzy, gmm and balanced
    on the weighted coreset, as the reference's list allows; the result
    line carries ``coreset``."""
    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(42, 1500, 5, 3))
    argv = ["train", "--input", npy, "--model", family, "--k", "3",
            "--coreset", "300"]
    rc_p, out_p, err_p = _run("port", capsys, argv)
    rc_r, out_r, _ = _run("ref", capsys, argv)
    assert rc_p == 0 and rc_r in (0, None), err_p
    got, ref = json.loads(out_p), json.loads(out_r)
    assert list(got) == list(ref) and got["coreset"] == 300
    assert got["k"] == 3 and np.isfinite(got["inertia"])


def test_train_merge_k_takes_the_discovered_k(tmp_path, capsys,
                                              monkeypatch):
    """x-means' ``--k`` is k_max, so ``--merge-k`` is checked against the
    discovered k after the fit, as in the reference."""
    import kmeans_tpu.models.xmeans as ref_xmeans
    import kmeans_tpu_torch.models.bisecting as port_bisecting

    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(43, 1200, 6, 5, std=0.25))
    for merge in ("2", "8"):
        argv = ["train", "--input", npy, "--model", "xmeans", "--k", "8",
                "--merge-k", merge]
        rc_p, out_p, err_p = _replay_inits(
            monkeypatch, port_bisecting, ref_xmeans,
            lambda: _run("port", capsys, argv))
        rc_r, out_r, err_r = _run("ref", capsys, argv)
        monkeypatch.undo()
        assert (rc_p, err_p) == (rc_r or 0, err_r)
        if merge == "2":
            assert json.loads(out_p)["merged_k"] == 2
            assert list(json.loads(out_p)) == list(json.loads(out_r))


def test_comm_reaches_the_sharded_fit(monkeypatch, capsys):
    """``--comm`` is the sharded merge the fit runs: the config the ranks
    get carries it (the port dropped it before; the reference passes it)."""
    import kmeans_tpu_torch.config as port_config

    seen = []

    class Recording(port_config.KMeansConfig):
        def __init__(self, *a, **kw):
            seen.append(kw.get("comm"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(port_config, "KMeansConfig", Recording)
    monkeypatch.setattr(port_cli, "_launch_mesh", lambda args, n: 0)
    for model in ("lloyd", "spherical", "bisecting"):
        assert port_cli.main(["train", "--model", model, "--comm",
                              "scatter", "--mesh", "2", "--device",
                              "cpu"]) == 0
    assert seen == ["scatter"] * 3


@pytest.fixture()
def sweep_npy(tmp_path):
    # Six blobs swept at k = 2..6: from one start two packages' Lloyd fits
    # follow one path where every cluster is a union of blobs; above the
    # blob count a boundary row's near-tie can flip on the f32 sum order
    # and the paths part (n_iter differs), in either package alone too.
    rng = np.random.default_rng(44)
    centers = rng.uniform(-10, 10, size=(6, 6))
    lab = rng.integers(0, 6, size=900)
    x = (centers[lab] + 0.4 * rng.normal(size=(900, 6))).astype(np.float32)
    p = tmp_path / "sweep.npy"
    np.save(p, x)
    return str(p)


@pytest.mark.parametrize("criterion", ["silhouette", "elbow", "gap"])
def test_sweep_lines_match_the_references(criterion, sweep_npy, capsys,
                                          monkeypatch):
    """``sweep`` prints the reference's lines: one scored row per k with
    the same keys, k, ``n_iter`` and ``converged``, the floats within
    ``SWEEP_RTOL``, and the same ``suggested_k``.  Every fit starts where
    the port's did, and the silhouette samples and gap reference sets are
    the port's draws (``tests/torch_replay.py``)."""
    import kmeans_tpu.models as ref_models
    import kmeans_tpu_torch.models as port_models
    from kmeans_tpu_torch import metrics as port_metrics
    from kmeans_tpu_torch.models import selection as port_selection
    from torch_replay import record_calls, replay_jax_random

    argv = ["sweep", "--input", sweep_npy, "--k-min", "2", "--k-max", "6",
            "--criterion", criterion, "--silhouette-sample", "400",
            "--gap-refs", "2"]
    draws = []
    name, jax_name = (("uniform_rows", "uniform") if criterion == "gap"
                      else ("sample_rows", "choice"))
    with monkeypatch.context() as m:
        record_calls(m, port_selection if criterion == "gap"
                     else port_metrics, name, draws)
        rc_p, out_p, err_p = _replay_inits(
            monkeypatch, port_models, ref_models,
            lambda: _run("port", capsys, argv))
    replay_jax_random(monkeypatch, jax_name, draws)
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert rc_p == 0 and rc_r in (0, None), err_p + err_r
    got = [json.loads(ln) for ln in out_p.splitlines()]
    ref = [json.loads(ln) for ln in out_r.splitlines()]
    assert [list(r) for r in got] == [list(r) for r in ref]
    assert got[-1] == ref[-1] and list(got[-1]) == ["suggested_k"]
    # A row's inertia rounds each row's expanded distance at ‖x‖²'s scale.
    x = np.load(sweep_npy).astype(np.float64)
    inertia_atol = 1e-6 * float((x ** 2).sum())
    for g, r in zip(got[:-1], ref[:-1]):
        for key, want in r.items():
            if isinstance(want, float):
                atol = inertia_atol if key == "inertia" else SWEEP_ATOL
                np.testing.assert_allclose(g[key], want, rtol=SWEEP_RTOL,
                                           atol=atol, err_msg=key)
            else:
                assert g[key] == want, key


@pytest.mark.parametrize("model", ["kernel", "kmedoids", "spectral"])
def test_sweep_pairwise_lines_match_the_references(model, tmp_path, capsys,
                                                   monkeypatch):
    """``sweep --model F`` for the pairwise families: every fit's draws
    replayed through the reference, the same rows (spectral's silhouette
    scored in its embedding, the center-free rows without DB / CH) and
    the same suggestion."""
    from torch_replay import replay_pairwise

    npy = str(tmp_path / "x.npy")
    np.save(npy, np.round(_separated(48, 300, 4, 3, std=0.5) * 8.0) / 8.0)
    argv = ["sweep", "--input", npy, "--k-min", "2", "--k-max", "3",
            "--model", model, "--max-iter", "20"]
    rc_p, out_p, err_p = replay_pairwise(
        monkeypatch, model, lambda: _run("port", capsys, argv))
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert rc_p == 0 and rc_r in (0, None), err_p + err_r
    got = [json.loads(ln) for ln in out_p.splitlines()]
    ref = [json.loads(ln) for ln in out_r.splitlines()]
    assert [list(r) for r in got] == [list(r) for r in ref]
    assert got[-1] == ref[-1]
    for g, r in zip(got[:-1], ref[:-1]):
        assert (g["k"], g["n_iter"], g["converged"]) == (
            r["k"], r["n_iter"], r["converged"])
        for key, want in r.items():
            if isinstance(want, float):
                np.testing.assert_allclose(g[key], want, rtol=SWEEP_RTOL,
                                           atol=SWEEP_ATOL, err_msg=key)


# ---------------------------------------------------------------------------
# ROADMAP A9b: the soft, balanced and projected families
# ---------------------------------------------------------------------------

def _replay_fit_inputs(monkeypatch, family, run_port):
    """Run ``run_port`` with the port's seeding of ``family`` recorded,
    then have the reference's start from it; returns ``run_port()``."""
    import importlib

    from torch_replay import record_fit_inputs, replay_fit_inputs

    port_module = importlib.import_module(f"kmeans_tpu_torch.models.{family}")
    ref_module = importlib.import_module(f"kmeans_tpu.models.{family}")
    inits = []
    with monkeypatch.context() as m:
        record_fit_inputs(m, port_module, inits)
        out = run_port()
    replay_fit_inputs(monkeypatch, ref_module, inits)
    return out


@pytest.mark.parametrize("family,extra", [
    ("fuzzy", []), ("gmm", []), ("gmm", ["--covariance-type", "tied"]),
    ("gmm", ["--covariance-type", "spherical"]), ("balanced", [])],
    ids=["fuzzy", "gmm", "gmm-tied", "gmm-spherical", "balanced"])
def test_train_soft_families_match_the_references(family, extra, tmp_path,
                                                  capsys, monkeypatch):
    """``train --model F`` prints the reference's result line from the
    port's k-means++ start replayed through the reference: the same keys,
    n_iter and mode, the objective (J, the negated log-likelihood, the
    balanced inertia) within ``INERTIA_RTOL``."""
    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(45, 900, 5, 3, std=0.6))
    argv = ["train", "--input", npy, "--model", family, "--k", "3",
            "--max-iter", "20"] + extra
    module = "balanced" if family == "balanced" else family
    rc_p, out_p, err_p = _replay_fit_inputs(
        monkeypatch, module, lambda: _run("port", capsys, argv))
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert rc_r in (0, None) and rc_p == 0, err_p + err_r
    ref, got = json.loads(out_r), json.loads(out_p)
    assert list(got) == list(ref)
    same = ("n", "d", "k", "mode", "n_iter", "converged")
    assert {f: got[f] for f in same} == {f: ref[f] for f in same}
    np.testing.assert_allclose(got["inertia"], ref["inertia"],
                               rtol=INERTIA_RTOL)


@pytest.mark.parametrize("extra", [["--whiten"], []],
                         ids=["whiten", "plain"])
def test_train_pca_matches_the_references(extra, tmp_path, capsys,
                                          monkeypatch):
    """``train --pca 4 [--whiten]``: the reference's projection carried
    into the port (``convert.pca_from_numpy``: eigenvector signs are
    neither package's to fix), then the Lloyd fit from the port's
    k-means++ start replayed through the reference; the same result line
    (d is the projected width)."""
    import kmeans_tpu.models as ref_models
    import kmeans_tpu_torch.data.preprocess as port_pre
    import kmeans_tpu_torch.models as port_models
    from kmeans_tpu.data import pca_fit as ref_pca_fit
    from kmeans_tpu_torch.convert import pca_from_numpy

    npy = str(tmp_path / "x.npy")
    rng = np.random.default_rng(46)
    x = _separated(46, 900, 4, 3, std=0.4) @ rng.normal(size=(4, 10))
    np.save(npy, (x + 0.01 * rng.normal(size=x.shape)).astype(np.float32))
    monkeypatch.setattr(port_pre, "pca_fit", lambda x, m, whiten, device:
                        pca_from_numpy(ref_pca_fit(np.asarray(x), m,
                                                   whiten=whiten),
                                       device=device))
    argv = ["train", "--input", npy, "--k", "3", "--pca", "4"] + extra
    rc_p, out_p, err_p = _replay_inits(
        monkeypatch, port_models, ref_models,
        lambda: _run("port", capsys, argv))
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert rc_r in (0, None) and rc_p == 0, err_p + err_r
    ref, got = json.loads(out_r), json.loads(out_p)
    assert list(got) == list(ref) and got["d"] == 4
    same = ("n", "d", "k", "mode", "n_iter", "converged")
    assert {f: got[f] for f in same} == {f: ref[f] for f in same}
    np.testing.assert_allclose(got["inertia"], ref["inertia"],
                               rtol=INERTIA_RTOL)


@pytest.mark.parametrize("argv", [
    ["--whiten"], ["--pca", "2"], ["--pca", "0"],
    ["--stream", "--pca", "1"]], ids=lambda a: " ".join(a))
def test_pca_guards_equal_the_references(argv, tmp_path, capsys):
    npy = str(tmp_path / "x.npy")
    np.save(npy, _separated(47, 50, 2, 2))
    full = ["train", "--input", npy, "--k", "2"] + argv
    got = [_run(side, capsys, full) for side in SIDES]
    assert got[0][0] == 2
    if "--stream" in argv:
        # The reference names its own module in the hint.
        assert got[1][0] == 2 and "--pca projects" in got[1][2]
    else:
        assert (got[1][0], got[1][2]) == (2, got[0][2])


@pytest.mark.parametrize("criterion", ["bic", "aic"])
def test_sweep_gmm_criteria_match_the_references(criterion, sweep_npy,
                                                 capsys, monkeypatch):
    """``sweep --model gmm --criterion bic|aic``: every row carries the
    reference's ``bic`` / ``aic`` (the diag parameter count) within
    ``SWEEP_RTOL``, from the port's starts and silhouette samples replayed
    through the reference, and the same ``suggested_k``."""
    import kmeans_tpu.models.gmm as ref_gmm
    import kmeans_tpu_torch.models.gmm as port_gmm
    from kmeans_tpu_torch import metrics as port_metrics
    from torch_replay import (record_calls, record_fit_inputs,
                              replay_fit_inputs, replay_jax_random)

    argv = ["sweep", "--input", sweep_npy, "--k-min", "2", "--k-max", "6",
            "--model", "gmm", "--criterion", criterion,
            "--silhouette-sample", "400", "--max-iter", "30"]
    draws, inits = [], []
    with monkeypatch.context() as m:
        record_calls(m, port_metrics, "sample_rows", draws)
        record_fit_inputs(m, port_gmm, inits)
        rc_p, out_p, err_p = _run("port", capsys, argv)
    replay_fit_inputs(monkeypatch, ref_gmm, inits)
    replay_jax_random(monkeypatch, "choice", draws)
    rc_r, out_r, err_r = _run("ref", capsys, argv)
    assert rc_p == 0 and rc_r in (0, None), err_p + err_r
    got = [json.loads(ln) for ln in out_p.splitlines()]
    ref = [json.loads(ln) for ln in out_r.splitlines()]
    assert [list(r) for r in got] == [list(r) for r in ref]
    assert got[-1] == ref[-1]
    for g, r in zip(got[:-1], ref[:-1]):
        assert g["k"] == r["k"] and g["n_iter"] == r["n_iter"]
        for key in ("inertia", "bic", "aic", "silhouette"):
            np.testing.assert_allclose(g[key], r[key], rtol=SWEEP_RTOL,
                                       err_msg=key)
