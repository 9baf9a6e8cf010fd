"""The port's verified checkpoints and persistent registry against the JAX
package's, on the CPU.

Each behaviour test runs once per package (``pkg``: the reference's
``kmeans_tpu.utils.checkpoint`` and ``kmeans_tpu.continuous.registry``, the
port's copies), on npz bundles: the reference writes orbax where it can
import it, so its side runs with ``orbax.checkpoint`` hidden from
``sys.modules``, which sends it down its npz branch and changes nothing in
the package.  The cross-reading tests write with one package and read with
the other: arrays equal bit for bit, meta and generation equal.  The crash
matrix raises at each fault site in process: a raise leaves the same files
on disk as a kill at that point, since nothing below the site runs.
"""

import dataclasses
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

from kmeans_tpu.continuous.registry import ModelRegistry as RefRegistry
from kmeans_tpu.utils import checkpoint as ref_ckpt
from kmeans_tpu.utils import faults as ref_faults
from kmeans_tpu_torch.config import KMeansConfig
from kmeans_tpu_torch.continuous.registry import ModelRegistry
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils import faults


@pytest.fixture()
def npz_format(monkeypatch):
    """Hide orbax, so the reference writes and reads npz bundles."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


@pytest.fixture(params=["ref", "port"])
def pkg(request, npz_format):
    """One package's checkpoint layer, registry and fault harness."""
    if request.param == "ref":
        ns = types.SimpleNamespace(ckpt=ref_ckpt, Registry=RefRegistry,
                                   faults=ref_faults)
    else:
        ns = types.SimpleNamespace(ckpt=ckpt, Registry=ModelRegistry,
                                   faults=faults)
    yield ns
    ns.faults.clear()


def _save(pkg, path, value, step, **kw):
    pkg.ckpt.save_array_checkpoint(
        path, {"c": np.full((4, 3), float(value), np.float32)}, step=step,
        **kw)


def _c(arrays):
    return np.asarray(arrays["c"])


# ---------------------------------------------------------------------------
# Verify-on-load, fallback and retention, each package
# ---------------------------------------------------------------------------

def test_corrupt_final_falls_back_to_old(tmp_path, pkg, capsys):
    path = str(tmp_path / "ck")
    _save(pkg, path, 1, 1)
    stash = str(tmp_path / "stash")
    shutil.copytree(path, stash)
    _save(pkg, path, 2, 2)
    shutil.copytree(stash, path + ".old")      # the swap window's .old
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    arrays, meta = pkg.ckpt.load_array_checkpoint(path)
    assert meta["step"] == 1
    np.testing.assert_array_equal(_c(arrays), np.full((4, 3), 1.0,
                                                      np.float32))
    assert "fallback" in capsys.readouterr().err


def test_digest_mismatch_and_all_corrupt_raise(tmp_path, pkg):
    path = str(tmp_path / "ck")
    _save(pkg, path, 1, 1)
    # A valid npz with the wrong values: only the digest catches it.
    np.savez(os.path.join(path, "arrays.npz"),
             c=np.full((4, 3), 9.0, np.float32))
    with pytest.raises(pkg.ckpt.CorruptCheckpointError):
        pkg.ckpt.load_array_checkpoint(path)
    shutil.copytree(path, path + ".old")
    for d in (path, path + ".old"):
        with open(os.path.join(d, "meta.json"), "w") as f:
            f.write("{torn")
    with pytest.raises(pkg.ckpt.CorruptCheckpointError):
        pkg.ckpt.load_array_checkpoint(path)


def test_missing_and_empty_dirs_are_not_found(tmp_path, pkg):
    with pytest.raises(FileNotFoundError):
        pkg.ckpt.load_array_checkpoint(str(tmp_path / "nope"))
    path = tmp_path / "ck"
    path.mkdir()
    (path / "unrelated.txt").write_text("not a checkpoint")
    with pytest.raises(FileNotFoundError):
        pkg.ckpt.load_array_checkpoint(str(path))
    assert pkg.ckpt.latest_step(str(path)) is None


def test_keep_retention_and_fallback_chain(tmp_path, pkg):
    path = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        _save(pkg, path, step, step, keep=2)
    tagged = sorted(p for p in os.listdir(tmp_path)
                    if p.startswith("ck.step-"))
    assert tagged == ["ck.step-00000002", "ck.step-00000003"]
    assert pkg.ckpt.latest_step(path) == 4
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.write(b"\x00\x00\x00\x00")
    arrays, meta = pkg.ckpt.load_array_checkpoint(path)
    assert meta["step"] == 3
    np.testing.assert_array_equal(_c(arrays), np.full((4, 3), 3.0,
                                                      np.float32))


def test_stale_old_and_glob_metachars(tmp_path, pkg):
    # A stale .old must not outrank a newer step-tagged dir.
    path = str(tmp_path / "ck")
    _save(pkg, path, 10, 10)
    stash = str(tmp_path / "stash10")
    shutil.copytree(path, stash)
    _save(pkg, path, 15, 15)
    shutil.copytree(stash, path + ".old")
    os.rename(path, path + ".step-00000015")
    arrays, meta = pkg.ckpt.load_array_checkpoint(path)
    assert meta["step"] == 15 and pkg.ckpt.latest_step(path) == 15
    # Retention and fallback under a path with glob metacharacters.
    base = tmp_path / "run[1]"
    base.mkdir()
    path = str(base / "ck")
    for step in (1, 2, 3):
        _save(pkg, path, step, step, keep=2)
    assert sorted(p for p in os.listdir(base) if p.startswith("ck.step-")) \
        == ["ck.step-00000001", "ck.step-00000002"]
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.write(b"\x00\x00\x00\x00")
    assert pkg.ckpt.load_array_checkpoint(path)[1]["step"] == 2


def test_v1_digestless_checkpoint_still_loads(tmp_path, pkg):
    path = str(tmp_path / "ck")
    _save(pkg, path, 3, 5)
    mp = os.path.join(path, "meta.json")
    with open(mp) as f:
        meta = json.load(f)
    del meta["digests"], meta["version"]
    with open(mp, "w") as f:
        json.dump(meta, f)
    arrays, meta = pkg.ckpt.load_array_checkpoint(path)
    assert meta["step"] == 5
    np.testing.assert_array_equal(_c(arrays), np.full((4, 3), 3.0,
                                                      np.float32))


#: The surviving step when the second save dies at each site: before the
#: final rename step 1 survives (mid_swap through .old or the step-tagged
#: dir), after it step 2 has landed whole.
_MATRIX = [("ckpt.pre_write", 1), ("ckpt.pre_meta", 1),
           ("ckpt.pre_rename", 1), ("ckpt.mid_swap", 1),
           ("ckpt.post_rename", 2)]


@pytest.mark.parametrize("keep", [0, 1])
@pytest.mark.parametrize("site,want_step", _MATRIX)
def test_crash_at_every_checkpoint_site(tmp_path, pkg, site, want_step,
                                        keep):
    path = str(tmp_path / "ck")
    with pkg.faults.active(f"{site}:raise@2"):
        _save(pkg, path, 1, 1, keep=keep)
        with pytest.raises(pkg.faults.InjectedFault):
            _save(pkg, path, 2, 2, keep=keep)
    arrays, meta = pkg.ckpt.load_array_checkpoint(path)
    assert meta["step"] == want_step
    np.testing.assert_array_equal(
        _c(arrays), np.full((4, 3), float(want_step), np.float32))
    assert pkg.ckpt.latest_step(path) == want_step


def test_crash_during_first_save_is_not_found(tmp_path, pkg):
    path = str(tmp_path / "ck")
    with pkg.faults.active("ckpt.pre_meta:raise@1"):
        with pytest.raises(pkg.faults.InjectedFault):
            _save(pkg, path, 1, 1)
    with pytest.raises(FileNotFoundError):
        pkg.ckpt.load_array_checkpoint(path)
    assert pkg.ckpt.latest_step(path) is None


# ---------------------------------------------------------------------------
# The registry on disk, each package
# ---------------------------------------------------------------------------

def test_registry_persist_then_swap_order_under_fault(tmp_path, pkg):
    path = str(tmp_path / "model")
    reg = pkg.Registry(path=path)
    reg.publish(np.zeros((2, 2)), trigger="initial")
    with pkg.faults.active("registry.swap:raise@1"):
        with pytest.raises(pkg.faults.InjectedFault):
            reg.publish(np.ones((2, 2)), trigger="drift")
    assert reg.generation == 1           # memory untouched, disk ahead
    assert reg.load_latest() is not None
    assert reg.generation == 2
    np.testing.assert_array_equal(reg.current().centroids,
                                  np.ones((2, 2), np.float32))
    assert reg.load_latest() is not None and reg.generation == 2  # no-op


def test_registry_refuses_foreign_checkpoint(tmp_path, pkg):
    path = str(tmp_path / "notamodel")
    pkg.ckpt.save_array_checkpoint(path, {"centroids": np.ones((2, 2))},
                                   step=1)
    with pytest.raises(ValueError, match="continuous_model"):
        pkg.Registry(path=path).load_latest()


def test_fresh_registry_refuses_stale_newer_checkpoint(tmp_path, pkg):
    path = str(tmp_path / "m")
    old = pkg.Registry(path=path, keep=2)
    for g in range(5):
        old.publish(np.full((2, 2), float(g), np.float32))
    shutil.rmtree(path)                  # the retention siblings survive
    with pytest.raises(ValueError, match="already holds generation"):
        pkg.Registry(path=path).publish(np.zeros((2, 2), np.float32))
    resumed = pkg.Registry(path=path)
    assert resumed.load_latest() is not None and resumed.generation >= 3
    assert pkg.Registry(path=str(tmp_path / "m2")).publish(
        np.zeros((2, 2))).generation == 1


def test_resume_guard_message_is_the_reference_s(tmp_path, npz_format):
    path = str(tmp_path / "m")
    RefRegistry(path=path).publish(np.zeros((2, 2)), generation=3)
    msgs = []
    for cls in (RefRegistry, ModelRegistry):
        with pytest.raises(ValueError) as e:
            cls(path=path).publish(np.zeros((2, 2)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Each package reads the other's bundles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["ref", "port"])
def test_array_checkpoints_cross_read(tmp_path, npz_format, writer):
    rng = np.random.default_rng(0)
    arrays = {"centroids": rng.normal(size=(5, 3)).astype(np.float32),
              "labels": rng.integers(0, 5, size=17).astype(np.int32),
              "inertia": np.float32(3.5),
              "empty": np.zeros((0, 3), np.float32)}
    cfg = KMeansConfig(k=5, seed=3)
    key = np.array([0, 42], np.uint32)
    path = str(tmp_path / "ck")
    save, load = ((ref_ckpt.save_array_checkpoint, ckpt.load_array_checkpoint)
                  if writer == "ref" else
                  (ckpt.save_array_checkpoint, ref_ckpt.load_array_checkpoint))
    if writer == "ref":
        import jax

        save(path, arrays, step=7, config=cfg, key=jax.random.key(42),
             extra={"tag": "x"}, keep=1)
    else:
        save(path, arrays, step=7, config=cfg, key=key, extra={"tag": "x"},
             keep=1)
    got, meta = load(path)
    assert sorted(got) == sorted(arrays)
    for name, want in arrays.items():
        g = np.asarray(got[name])
        assert g.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(g, want)
    assert meta["step"] == 7 and meta["extra"] == {"tag": "x"}
    assert meta["format"] == "npz" and meta["digests"]
    assert meta["config"] == dataclasses.asdict(cfg)
    assert meta["config_obj"].k == 5 and meta["config_obj"].seed == 3
    np.testing.assert_array_equal(np.asarray(meta["key_data"], np.uint32),
                                  key)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_registry_bundles_cross_read(tmp_path, npz_format, writer):
    rng = np.random.default_rng(1)
    c1 = rng.normal(size=(4, 6)).astype(np.float32)
    c2 = rng.normal(size=(4, 6)).astype(np.float32)
    window = rng.normal(size=(9, 6)).astype(np.float32)
    path = str(tmp_path / "model")
    w_cls, r_cls = ((RefRegistry, ModelRegistry) if writer == "ref"
                    else (ModelRegistry, RefRegistry))
    w = w_cls(path=path)
    w.publish(c1, trigger="initial")
    w.publish(c2, trigger="drift", meta={"batch": 12, "note": "x"},
              extra_arrays={"window": window})
    gen, arrays, meta = r_cls(path=path).load_latest()
    ref_gen = w.current()
    assert gen.describe() == ref_gen.describe()
    np.testing.assert_array_equal(gen.centroids, c2)
    np.testing.assert_array_equal(np.asarray(arrays["window"]), window)
    assert meta["step"] == 2 and meta["extra"]["batch"] == 12
    # The reader's registry carries on over the writer's directory.
    reader = r_cls(path=path)
    reader.load_latest()
    assert reader.publish(c1).generation == 3
    assert w_cls(path=path).load_latest()[0].generation == 3


def test_port_refuses_an_orbax_bundle(tmp_path):
    """Where orbax imports, the reference writes an orbax bundle; the port
    names the format and the way out instead of serving nothing."""
    path = str(tmp_path / "model")
    RefRegistry(path=path).publish(np.ones((2, 3), np.float32))
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["format"] == "orbax"
    with pytest.raises(ckpt.UnsupportedFormatError,
                       match="'orbax' format.*npz"):
        ModelRegistry(path=path).load_latest()


def test_array_checkpoint_takes_tensors_the_way_state_checkpoints_do(
        tmp_path):
    """``save_array_checkpoint`` converts each array as ``save_checkpoint``
    does (detached, copied to the host), so the streamed GMM's parameters
    and statistics save from wherever they live: a card tensor, or here a
    tensor that ``numpy.asarray`` refuses (it requires grad).  The
    reference reads the bundle."""
    import torch

    path = str(tmp_path / "ck")
    means = torch.arange(6, dtype=torch.float32).view(2, 3).requires_grad_()
    ckpt.save_array_checkpoint(path, {"means": means,
                                      "log_pi": torch.zeros(2)}, step=3)
    arrays, meta = ref_ckpt.load_array_checkpoint(path)
    np.testing.assert_array_equal(arrays["means"],
                                  means.detach().numpy())
    assert meta["step"] == 3
