"""One rank of a gloo CPU world for the port's sharded-engine tests.

    python tests/torch_mesh_worker.py CASES.pkl OUT.pkl

runs under ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``
(set by :func:`run_world`), builds a CPU mesh over the world, runs every
case of ``CASES.pkl`` (a list of ``(name, op, kwargs)``) in order and, on
rank 0, pickles ``{name: result}`` to ``OUT.pkl``.  A case that raises gives
``{"error": "<type>: <message>"}``; the engine validates before its first
collective, identically on every rank, so such a case raises on every rank
and the world goes on.  Imports the port only (no JAX).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    import numpy as np
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _state(s):
    return {"centroids": _np(s.centroids), "labels": _np(s.labels),
            "inertia": float(s.inertia), "n_iter": int(s.n_iter),
            "converged": bool(s.converged), "counts": _np(s.counts)}


def _cfg(kw):
    from kmeans_tpu_torch.config import KMeansConfig

    return KMeansConfig(**kw) if kw is not None else None


def op_fit(mesh, x, k, config=None, **kw):
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded

    return _state(fit_lloyd_sharded(x, k, mesh=mesh, config=_cfg(config),
                                    **kw))


def op_minibatch(mesh, x, k, config=None, **kw):
    from kmeans_tpu_torch.parallel import fit_minibatch_sharded

    return _state(fit_minibatch_sharded(x, k, mesh=mesh, config=_cfg(config),
                                        **kw))


def op_minibatch_draws(mesh, n, d, k, batch_size, steps, seed):
    """Each rank's batch indices of a minibatch fit: ``(s_i, n_loc,
    [global index arrays, one a step])``, all ranks gathered."""
    import torch

    from kmeans_tpu_torch.parallel.engine import (_minibatch_shard,
                                                  minibatch_loop_seed,
                                                  minibatch_rank_generator)

    dp = mesh.size
    n_loc = -(-n // dp)
    out = []
    # The loop seed: the fit's first draw after an explicit init.
    loop_seed = minibatch_loop_seed(torch.Generator().manual_seed(seed),
                                    "cpu")
    for r in range(dp):
        n_valid, s_i = _minibatch_shard(n, n_loc, dp, r)
        g = minibatch_rank_generator(loop_seed, r, "cpu")
        idx = [_np(torch.randint(0, max(n_valid, 1), (batch_size // dp,),
                                 generator=g)) + r * n_loc
               for _ in range(steps)]
        out.append((s_i, n_valid, idx))
    return out


def op_assign(mesh, x, c, **kw):
    from kmeans_tpu_torch.parallel import sharded_assign

    labels, mind = sharded_assign(x, c, mesh=mesh, **kw)
    return {"labels": _np(labels), "mind": _np(mind)}


def op_init(mesh, x, k, method, seed, weights=None, **kw):
    """The engine's sharded seeding on the padded row blocks."""
    import torch

    from kmeans_tpu_torch.parallel.engine import _place
    from kmeans_tpu_torch.parallel.init_sharded import init_on_mesh

    x_loc, w_loc, _, n = _place(x, mesh, "data", weights=weights)
    gen = torch.Generator().manual_seed(seed)
    c = init_on_mesh(gen, x_loc, k, mesh=mesh, n=n, method=method,
                     weights=w_loc, user_weights=weights is not None, **kw)
    # The generator must stand where the single-device seeding leaves it.
    nxt = torch.rand(4, generator=gen)
    return {"centroids": _np(c), "next": _np(nxt)}


def op_kmpar(mesh, x, k, seed, **kw):
    """kmeans_parallel_sharded on the blocks (the reference's rounds /
    oversampling knobs)."""
    import torch

    from kmeans_tpu_torch.parallel import kmeans_parallel_sharded
    from kmeans_tpu_torch.parallel.engine import _place

    x_loc, w_loc, _, n = _place(x, mesh, "data")
    gen = torch.Generator().manual_seed(seed)
    return _np(kmeans_parallel_sharded(gen, x_loc, k, mesh=mesh, n=n,
                                       weights=w_loc, **kw))


def op_runner(mesh, x, k, config=None, init=None, model_axis=None, **kw):
    from kmeans_tpu_torch.models.runner import LloydRunner

    r = LloydRunner(x, k, config=_cfg(config), mesh=mesh,
                    model_axis=model_axis, device="cpu")
    r.init(init)
    return _state(r.run(**kw))


def op_accel(mesh, x, k, config=None, **kw):
    from kmeans_tpu_torch.parallel import fit_lloyd_accelerated_sharded

    return _state(fit_lloyd_accelerated_sharded(x, k, mesh=mesh,
                                                config=_cfg(config), **kw))


def op_trimmed(mesh, x, k, config=None, **kw):
    from kmeans_tpu_torch.parallel import fit_trimmed_sharded

    st = fit_trimmed_sharded(x, k, mesh=mesh, config=_cfg(config), **kw)
    return dict(_state(st), outlier_mask=_np(st.outlier_mask))


def op_sphere(mesh, x, k, config=None, **kw):
    from kmeans_tpu_torch.parallel import fit_spherical_sharded

    return _state(fit_spherical_sharded(x, k, mesh=mesh, config=_cfg(config),
                                        **kw))


def op_soft(mesh, family, x, k, config=None, **kw):
    """``fit_fuzzy_sharded`` / ``fit_gmm_sharded`` /
    ``fit_balanced_sharded``: the state's fields as numpy, and the mesh's
    all-reduce count over the fit."""
    import torch

    from kmeans_tpu_torch import parallel

    fit = getattr(parallel, f"fit_{family}_sharded")
    mesh.reset_stats()
    st = fit(x, k, mesh=mesh, config=_cfg(config), **kw)
    out = {name: _np(v) if isinstance(v, torch.Tensor) else v
           for name, v in st._asdict().items()}
    out["all_reduces"] = mesh.stats["all_reduce"][0]
    return out


def op_pairwise(mesh, family, x, k, config=None, **kw):
    """``fit_kmedoids_sharded`` / ``fit_kernel_kmeans_sharded`` (the ring
    passes): the state's fields as numpy, and the ring shifts and
    all-reduces of the fit."""
    import torch

    from kmeans_tpu_torch import parallel

    fit = {"kmedoids": parallel.fit_kmedoids_sharded,
           "kernel": parallel.fit_kernel_kmeans_sharded}[family]
    mesh.reset_stats()
    st = fit(x, k, mesh=mesh, config=_cfg(config), **kw)
    out = {name: _np(v) if isinstance(v, torch.Tensor) else v
           for name, v in st._asdict().items()}
    out["ring_shifts"] = mesh.stats["ring_shift"][0]
    out["all_reduces"] = mesh.stats["all_reduce"][0]
    return out


def op_kernel_pads(mesh, x, k, labels0, max_iter):
    """The ring loop of kernel k-means on the placed rows, its labels
    gathered with the padding rows kept."""
    import torch

    from kmeans_tpu_torch.models.kernel import _kernel_loop
    from kmeans_tpu_torch.parallel.engine import _place

    x_loc, w_loc, _, n = _place(x, mesh, "data")
    n_loc = x_loc.shape[0]
    lo = mesh.rank * n_loc
    real = (lo + torch.arange(n_loc)) < n
    lab0 = torch.zeros(n_loc, dtype=torch.int32)
    lab0[:max(min(n - lo, n_loc), 0)] = torch.from_numpy(
        labels0[lo:lo + n_loc])
    st = _kernel_loop(x_loc, lab0, w_loc, k=k, max_iter=max_iter,
                      chunk_size=64, compute_dtype=None, kernel="rbf",
                      gamma=1.0 / x.shape[1], degree=3, coef0=1.0, mesh=mesh,
                      real=real)
    return {"labels": _np(mesh.all_gather(st.labels)),
            "n_iter": int(st.n_iter)}


def op_spectral(mesh, x, k, landmarks, chunk_size):
    """``spectral_embedding_sharded``: the embedding; and every rank's top
    eigenvectors of the Gram, all-gathered, from the embedding's row math
    on the rank's placed rows."""
    import torch

    from kmeans_tpu_torch.models.spectral import embed_rows, landmark_ops
    from kmeans_tpu_torch.parallel import spectral_embedding_sharded
    from kmeans_tpu_torch.parallel.engine import _place

    emb = spectral_embedding_sharded(x, k, mesh=mesh, landmarks=landmarks,
                                     chunk_size=chunk_size)
    gamma = 1.0 / x.shape[1]
    ops = landmark_ops(torch.from_numpy(landmarks), gamma=gamma, degree=3,
                       coef0=1.0, reg=1e-4)
    x_loc, w_loc, _, _ = _place(x, mesh, "data")
    _, v = embed_rows(x_loc, (w_loc > 0).float(), ops, k=k, gamma=gamma,
                      cd=torch.float32, chunk_size=chunk_size, mesh=mesh)
    return {"embedding": _np(emb),
            "bases": _np(mesh.all_gather(v[None].contiguous()))}


def op_spectral_fit(mesh, x, k, config=None, **kw):
    """``fit_spectral(mesh=)``: labels, embedding and the k-means' result."""
    from kmeans_tpu_torch.models import fit_spectral

    st = fit_spectral(x, k, mesh=mesh, config=_cfg(config), **kw)
    return {"labels": _np(st.labels), "embedding": _np(st.embedding),
            "inertia": float(st.inertia), "n_iter": int(st.n_iter)}


def op_pca(mesh, x, n_components, **kw):
    from kmeans_tpu_torch.parallel import pca_fit_sharded

    st = pca_fit_sharded(x, n_components, mesh=mesh, **kw)
    return {"mean": _np(st.mean), "components": _np(st.components),
            "explained_variance": _np(st.explained_variance),
            "whiten": st.whiten}


def op_gmm_stream(mesh, path, k, config=None, **kw):
    """``fit_gmm_stream(mesh=)`` over the ``.npy`` at ``path``,
    memory-mapped."""
    import numpy as np

    from kmeans_tpu_torch.models.gmm_stream import fit_gmm_stream

    st = fit_gmm_stream(np.load(path, mmap_mode="r"), k, mesh=mesh,
                        config=_cfg(config), **kw)
    return {name: _np(v) for name, v in st._asdict().items()}


def op_family(mesh, family, x, k, config=None, **kw):
    """``fit_bisecting`` / ``fit_xmeans`` / ``fit_gmeans`` with ``mesh``:
    every inner fit and assign on the sharded engine."""
    import kmeans_tpu_torch.models as models

    fit = getattr(models, f"fit_{family}")
    return _state(fit(x, k, mesh=mesh, config=_cfg(config), **kw))


def op_cli(mesh, argv):
    """``cli.main(argv)`` joining this world as its mesh (``--mesh`` must
    be the world's size): rank 0's exit code and printed lines."""
    import contextlib
    import io

    from kmeans_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(list(argv))
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue()}


def _faults(mesh, fault, fault_rank):
    """``fault`` (a fault spec) installed on every rank, or on
    ``fault_rank`` alone."""
    import contextlib

    from kmeans_tpu_torch.utils import faults

    if fault is None or fault_rank not in (None, mesh.rank):
        return contextlib.nullcontext()
    return faults.active(fault)


def op_stream(mesh, path, k, config=None, fault=None, fault_rank=None,
              **kw):
    """``fit_minibatch_stream(mesh=)`` over the ``.npy`` at ``path``,
    memory-mapped, with ``fault`` (:func:`_faults`); a :class:`Preempted`
    is its result."""
    import numpy as np

    from kmeans_tpu_torch.models.streaming import fit_minibatch_stream
    from kmeans_tpu_torch.utils.preempt import Preempted

    data = np.load(path, mmap_mode="r")
    try:
        with _faults(mesh, fault, fault_rank):
            return _state(fit_minibatch_stream(data, k, mesh=mesh,
                                               config=_cfg(config), **kw))
    except Preempted as e:
        return {"preempted": e.step}


def op_elastic(mesh, x, k, config=None, fault=None, fault_rank=None, **kw):
    """``fit_lloyd_sharded`` with ``fault`` (:func:`_faults`); a
    :class:`Preempted` is its result.  Adds the resume outcomes this call
    counted."""
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded
    from kmeans_tpu_torch.parallel.engine import _ENGINE_RESUMES_TOTAL
    from kmeans_tpu_torch.utils.preempt import Preempted

    outcomes = ("ok", "finished", "refused", "error")
    before = {o: _ENGINE_RESUMES_TOTAL.value(outcome=o) for o in outcomes}
    try:
        with _faults(mesh, fault, fault_rank):
            out = _state(fit_lloyd_sharded(x, k, mesh=mesh,
                                           config=_cfg(config), **kw))
    except Preempted as e:
        out = {"preempted": e.step, "hint": e.resume_hint}
    except (ValueError, FileNotFoundError) as e:
        out = {"error": f"{type(e).__name__}: {e}"}
    out["resumes"] = {o: _ENGINE_RESUMES_TOTAL.value(outcome=o) - before[o]
                      for o in outcomes}
    return out


def op_block_storage(mesh, x):
    """Bytes of storage behind this rank's placed block, for numpy, host
    tensor and host-tensor-view inputs: ``[(rows, storage bytes)]``."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.parallel.engine import _place

    out = []
    big = torch.from_numpy(np.concatenate([x, x]))
    for xin in (x, torch.from_numpy(x), big[:x.shape[0]]):
        x_loc = _place(xin, mesh, "data")[0]
        out.append((x_loc.shape[0] * x_loc.shape[1] * x_loc.element_size(),
                    x_loc.untyped_storage().nbytes()))
    return out


def op_tp_tiled(mesh, x, c):
    """One TP sweep of ``c`` over the mesh's model ranks, untiled and with
    ``k_tile=128`` (the plain K5 / K6 route): labels, counts, the updated
    global centroids and the inertia of each."""
    import torch

    from kmeans_tpu_torch.parallel.engine import (_Axes, _gather_rows,
                                                  _global_centroids, _place,
                                                  _sharded_pass)

    ax = _Axes(mesh, "data", "model", None)
    x_loc, w_loc, _, n = _place(x, mesh, "data")
    k, d = c.shape
    k_loc = -(-k // ax.mp)
    c_full = torch.zeros(k_loc * ax.mp, d)
    c_full[:k] = torch.from_numpy(c)
    c_loc = c_full[ax.model.rank * k_loc:(ax.model.rank + 1) * k_loc]
    out = {"labels": [], "counts": [], "centroids": [], "inertia": []}
    for k_tile in (None, 128):
        new_c, _, inertia, counts, labels = _sharded_pass(
            ax, x_loc, w_loc, c_loc, k_real=k, route="plain", k_tile=k_tile,
            kw=dict(chunk_size=4096, compute_dtype=None, update="matmul",
                    weights_are_binary=True, backend="plain"))
        out["labels"].append(_np(_gather_rows(ax.rows, labels, n)))
        out["counts"].append(_np(ax.model.all_gather(counts)[:k]))
        out["centroids"].append(_np(_global_centroids(ax, new_c, k, d)))
        out["inertia"].append(float(inertia))
    return out


def op_mesh(mesh, shape, axis_names=("data", "model")):
    from kmeans_tpu_torch.parallel import make_mesh

    m = make_mesh(shape, axis_names, platform="cpu")
    return {"shape": m.shape, "rank": m.rank, "size": m.size}


def op_split(mesh, x, k, init, comm, sweeps):
    """A fit recorded by ``sweep_split``: its per-sweep summary."""
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded
    from kmeans_tpu_torch.parallel.engine import sweep_split

    with sweep_split(mesh) as sp:
        fit_lloyd_sharded(x, k, mesh=mesh, init=init, max_iter=sweeps,
                          tol=-1.0, config=_cfg(dict(k=k, comm=comm)))
    assert mesh.split is None
    return sp.summary()


def op_mesh_freed(mesh):
    """Whether a mesh (and a view of it) goes with its last reference,
    the cyclic collector off: a mesh that outlives its process group to
    the interpreter's teardown can abort the process's exit."""
    import gc
    import weakref

    from kmeans_tpu_torch.parallel import cpu_mesh

    gc.disable()
    try:
        m = cpu_mesh(mesh.shape, mesh.axis_names)
        view = m.sub(("data",))
        ref = weakref.ref(m)
        del m, view
        return ref() is None
    finally:
        gc.enable()


def op_stats(mesh, x, k, init, sweeps, **kw):
    """The mesh's collective counts over one fit: ``{op: [calls,
    bytes]}``."""
    from kmeans_tpu_torch.parallel import fit_lloyd_sharded

    mesh.reset_stats()
    fit_lloyd_sharded(x, k, mesh=mesh, init=init, max_iter=sweeps,
                      tol=-1.0, config=_cfg(dict(k=k, update="matmul")),
                      **kw)
    return {op: list(v) for op, v in mesh.stats.items()}


def op_winners(mesh, x, min_d2, k):
    """The sharded ranked-winner list on the padded row blocks."""
    import numpy as np
    import torch

    from kmeans_tpu_torch.parallel.engine import _place, _ranked_winners_dp

    x_loc, w_loc, _, n = _place(x, mesh, "data")
    n_loc = x_loc.shape[0]
    lo = mesh.rank * n_loc
    m = np.full(n_loc, -np.inf, np.float32)
    part = np.asarray(min_d2, np.float32)[lo:lo + n_loc]
    m[:part.shape[0]] = part
    return _np(_ranked_winners_dp(mesh, x_loc, torch.from_numpy(m), k))


def main(cases_path, out_path):
    sys.path.insert(0, _REPO)
    import torch

    torch.set_num_threads(1)
    from kmeans_tpu_torch.parallel import cpu_mesh

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    world = int(os.environ["WORLD_SIZE"])
    mesh = cpu_mesh((world, 1))
    # A case may ask for another mesh of the world: ``mesh_shape`` and
    # ``mesh_axes`` (every rank makes it, in case order).
    meshes = {}
    results = {}
    for name, op, kw in cases:
        shape = kw.pop("mesh_shape", None)
        axes = tuple(kw.pop("mesh_axes", ("data", "model")))
        if shape is None and len(axes) != 2:
            shape = (world,) + (1,) * (len(axes) - 1)
        m = mesh
        if shape is not None:
            key = (tuple(shape), axes)
            if key not in meshes:
                meshes[key] = cpu_mesh(tuple(shape), axes)
            m = meshes[key]
        try:
            results[name] = globals()[f"op_{op}"](m, **kw)
        except Exception as e:  # allow-silent-except: the case's error is its result, reported to the test
            results[name] = {"error": f"{type(e).__name__}: {e}"}
    if mesh.rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(world: int, cases, *, timeout: float = 240.0):
    """Run ``cases`` in a gloo world of ``world`` CPU processes; returns
    rank 0's ``{name: result}``.  Every rank is killed after ``timeout``
    seconds, so a hung collective fails the caller instead of the suite."""
    with tempfile.TemporaryDirectory() as tmp:
        cases_path = os.path.join(tmp, "cases.pkl")
        out_path = os.path.join(tmp, "out.pkl")
        with open(cases_path, "wb") as f:
            pickle.dump(list(cases), f)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
                   OMP_NUM_THREADS="1")
        env.pop("LOCAL_RANK", None)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), cases_path,
             out_path], env=dict(env, RANK=str(r)), cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        logs = []
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                logs.append(out.decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise RuntimeError("a rank failed:\n" + "\n".join(
                f"--- rank {r} rc={p.returncode}\n{log[-3000:]}"
                for r, (p, log) in enumerate(zip(procs, logs))))
        with open(out_path, "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
