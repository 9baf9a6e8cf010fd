"""The port's fit, init and state conversion against the JAX package.

Fits start from an explicit ``init`` array made with numpy: torch cannot
reproduce ``jax.random``'s k-means++ draws.  The data are well-separated
blobs, so labels and sweep counts must be equal; centroids and inertia
agree to rtol 1e-5 and atol 1e-4·max|want| because both packages sum the
same f32 terms in different orders.  The port runs with ``device="cpu"``,
where its kernels' plain versions run; the reference runs its default (XLA)
route on the CPU.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmeans_tpu
from kmeans_tpu.config import KMeansConfig as RefConfig
from kmeans_tpu_torch import (KMeans, KMeansConfig, delta_pass, fit_lloyd,
                              kmeans_plus_plus, lloyd_pass, make_blobs)
from kmeans_tpu_torch.convert import state_from_numpy, state_to_numpy
from kmeans_tpu_torch.models.lloyd import fit_plan
from kmeans_tpu_torch.ops.yinyang import AUTO_MIN_ROWS

CPU = "cpu"
#: fit_plan's reason for the plain route under backend="auto" on the CPU.
CPU_WHY = "not running on a CUDA device (cpu)"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = 1e-4 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _problem(seed=0, n=600, d=16, k=5):
    """Separated blobs and an explicit init of k data rows, two of them
    from one blob so the first sweeps move rows between clusters."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 6
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    pick = [int(np.flatnonzero(lab == j)[0]) for j in range(k - 1)]
    pick.append(int(np.flatnonzero(lab == 0)[1]))
    return x, x[pick].copy()


@pytest.mark.parametrize("update,cd,max_iter,tol", [
    ("delta", "float32", 20, -1.0),      # 20 sweeps: the refresh at 16 runs
    ("delta", "bfloat16", 20, -1.0),
    ("delta", "float32", 50, 1e-4),      # converges: n_iter must match
    ("matmul", "float32", 50, 1e-4),
    ("matmul", "bfloat16", 20, -1.0),
])
def test_fit_lloyd_matches_reference(update, cd, max_iter, tol):
    x, c0 = _problem()
    k = c0.shape[0]
    port = fit_lloyd(x, k, init=c0, device=CPU, max_iter=max_iter, tol=tol,
                     config=KMeansConfig(k=k, update=update,
                                         compute_dtype=cd))
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), k, init=jnp.asarray(c0),
                               max_iter=max_iter, tol=tol,
                               config=RefConfig(k=k, update=update,
                                                compute_dtype=cd))
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.n_iter) == int(ref.n_iter)
    assert bool(port.converged) == bool(ref.converged)
    _close(port.centroids, ref.centroids, "centroids")
    _close(port.inertia, ref.inertia, "inertia")
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))


def test_fit_farthest_reseed_and_float64_input():
    x, c0 = _problem(seed=1)
    c0[1] = 1e3                      # a centroid no row chooses: reseeded
    cfg = dict(k=5, update="delta", empty="farthest")
    port = fit_lloyd(x.astype(np.float64), 5, init=c0, device=CPU,
                     config=KMeansConfig(**cfg))
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), 5, init=jnp.asarray(c0),
                               config=RefConfig(**cfg))
    assert port.centroids.dtype == torch.float32
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(ref.labels))
    assert int(port.n_iter) == int(ref.n_iter)
    _close(port.centroids, ref.centroids, "centroids")


def test_kmeans_estimator_matches_reference():
    x, c0 = _problem(seed=2)
    port = KMeans(n_clusters=5, init=c0, update="delta", device=CPU).fit(x)
    ref = kmeans_tpu.KMeans(n_clusters=5, init=jnp.asarray(c0),
                            update="delta").fit(jnp.asarray(x))
    np.testing.assert_array_equal(port.labels_.numpy(),
                                  np.asarray(ref.labels_))
    assert port.n_iter_ == ref.n_iter_
    np.testing.assert_allclose(port.inertia_, ref.inertia_, rtol=1e-5)
    np.testing.assert_array_equal(port.predict(x[:50]).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(x[:50]))))
    np.testing.assert_allclose(port.score(x), ref.score(jnp.asarray(x)),
                               rtol=1e-5)
    _close(port.transform(x[:20]), ref.transform(jnp.asarray(x[:20])))


def test_kmeans_restarts_keep_the_best_and_repeat_under_a_seed():
    x, _ = _problem(seed=3)
    a = KMeans(n_clusters=5, n_init=3, seed=7, device=CPU).fit(x)
    b = KMeans(n_clusters=5, n_init=3, seed=7, device=CPU).fit(x)
    one = KMeans(n_clusters=5, n_init=1, seed=7, device=CPU).fit(x)
    assert torch.equal(a.cluster_centers_, b.cluster_centers_)
    assert a.inertia_ <= one.inertia_
    # One restart is a plain fit seeded with the estimator's seed.
    plain = fit_lloyd(x, 5, device=CPU, config=KMeansConfig(k=5, seed=7))
    assert torch.equal(one.cluster_centers_, plain.centroids)


def test_convert_round_trip():
    x, c0 = _problem(seed=4)
    ref = kmeans_tpu.fit_lloyd(jnp.asarray(x), 5, init=jnp.asarray(c0),
                               config=RefConfig(k=5, update="delta"))
    port = state_from_numpy(ref, device=CPU)
    back = state_to_numpy(port)
    for name in ("centroids", "labels", "counts", "inertia", "n_iter",
                 "converged"):
        want = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(back[name], want, err_msg=name)
        assert back[name].dtype == want.dtype, name
    again = state_from_numpy(back, device=CPU)
    for a, b in zip(again, port):
        assert torch.equal(a, b)
    # A port state continues as a port fit from the carried centroids.
    cont = fit_lloyd(x, 5, init=port.centroids, device=CPU,
                     config=KMeansConfig(k=5, update="delta"))
    np.testing.assert_array_equal(cont.labels.numpy(), back["labels"])


def test_kmeans_plus_plus_properties():
    x, _ = _problem(seed=5, n=400)
    xt = torch.from_numpy(x)
    seeds = kmeans_plus_plus(11, xt, 8, device=CPU)
    rows = {tuple(r) for r in x}
    assert seeds.shape == (8, 16) and seeds.dtype == torch.float32
    assert all(tuple(s) in rows for s in seeds.numpy())
    assert len({tuple(s) for s in seeds.numpy()}) == 8
    again = kmeans_plus_plus(torch.Generator().manual_seed(11), xt, 8,
                             device=CPU)
    assert torch.equal(seeds, again)
    assert not torch.equal(seeds, kmeans_plus_plus(12, xt, 8, device=CPU))
    # Zero-weight rows are never chosen.
    w = torch.zeros(400)
    w[:50] = 1.0
    chosen = kmeans_plus_plus(13, xt, 8, weights=w, device=CPU)
    allowed = {tuple(r) for r in x[:50]}
    assert all(tuple(s) in allowed for s in chosen.numpy())


def test_make_blobs_on_cpu():
    x, labels, centres = make_blobs(3, 1000, 7, 4, dtype=torch.bfloat16,
                                    device=CPU)
    assert x.shape == (1000, 7) and x.dtype == torch.bfloat16
    assert labels.dtype == torch.int32 and centres.shape == (4, 7)
    assert int(labels.min()) >= 0 and int(labels.max()) < 4
    resid = x.float() - centres[labels.long()]
    assert 0.8 < float(resid.std()) < 1.2
    again = make_blobs(3, 1000, 7, 4, dtype=torch.bfloat16, device=CPU)[0]
    assert torch.equal(x, again)


def test_unported_update_flavours_raise():
    """Every update flavour is ported; what raises is what the reference
    refuses: the pruned flavours with the farthest-reseed policy.  The
    plan reports the adaptive loop where the reference's does."""
    x, c0 = _problem()
    for update in ("hamerly", "yinyang"):
        cfg = dict(k=5, update=update, empty="farthest")
        with pytest.raises(ValueError, match="farthest"):
            fit_lloyd(x, 5, init=c0, device=CPU, config=KMeansConfig(**cfg))
        with pytest.raises(ValueError, match="farthest"):
            fit_plan(x, 5, config=KMeansConfig(**cfg), device=CPU)
        with pytest.raises(ValueError, match="farthest"):
            kmeans_tpu.fit_lloyd(jnp.asarray(x), 5, init=jnp.asarray(c0),
                                 config=RefConfig(**cfg))
        plan = fit_plan(x, 5, config=KMeansConfig(k=5, update=update),
                        device=CPU)
        assert plan == {"update": update, "backend": "plain",
                        "why": CPU_WHY,
                        "delta_backend": "plain", "adaptive": False,
                        "mode": "untiled", "k_tile": None}
    big = np.zeros((AUTO_MIN_ROWS, 2), np.float32)
    for n, adaptive in ((AUTO_MIN_ROWS, True), (AUTO_MIN_ROWS - 1, False)):
        assert fit_plan(big[:n], 3, device=CPU) == {
            "update": "delta", "backend": "plain", "why": CPU_WHY,
            "delta_backend": "plain",
            "adaptive": adaptive, "mode": "untiled", "k_tile": None}
        assert kmeans_tpu.models.lloyd.fit_plan(
            big[:n], 3)["adaptive"] is adaptive
    # "farthest" keeps "auto" off the adaptive loop, as in the reference.
    assert not fit_plan(big, 3, config=KMeansConfig(k=3, empty="farthest"),
                        device=CPU)["adaptive"]
    assert fit_plan(x, 5, device=CPU)["adaptive"] is False
    with pytest.raises(ValueError, match="unknown backend"):
        KMeansConfig(k=5, backend="pallas").validate()


def test_public_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    x, c0 = _problem()
    calls = [
        lambda: fit_lloyd(x, 5, init=c0),
        lambda: KMeans(n_clusters=5).fit(x),
        lambda: make_blobs(0, 10, 2, 2),
        lambda: kmeans_plus_plus(0, x, 3),
        lambda: lloyd_pass(x, c0),
        lambda: delta_pass(x, c0, np.full(600, -1, np.int32),
                           np.zeros((5, 16), np.float32),
                           np.zeros(5, np.float32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="do not take"):
        lloyd_pass(x, c0, backend="cuda", device=CPU)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, pkgutil, importlib\n"
        "import kmeans_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(kmeans_tpu_torch.__path__,"
        " 'kmeans_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'kmeans_tpu'"
        " or m.startswith('kmeans_tpu.'))\n"
        "walked = ['kmeans_tpu_torch.parallel.' + m for m in"
        " ('mesh', 'distributed', 'engine', 'init_sharded')]\n"
        "walked += ['kmeans_tpu_torch.metrics'] + ["
        "'kmeans_tpu_torch.models.' + m for m in ('selection',"
        " 'spherical', 'bisecting', 'xmeans', 'gmeans', 'gmm',"
        " 'gmm_stream', 'fuzzy', 'balanced')]\n"
        "walked += ['kmeans_tpu_torch.data.preprocess',"
        " 'kmeans_tpu_torch.parallel.preprocess']\n"
        "walked += ['kmeans_tpu_torch.' + m for m in ('models.medoids',"
        " 'models.kernel', 'models.spectral', 'parallel.medoids',"
        " 'parallel.kernel', 'parallel.spectral')]\n"
        "bad += [m + ' not walked' for m in walked if m not in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


#: Calls that sum floats in an order the card varies from run to run
#: (float atomics, or a float CUDA scan): each is allowed only inside the
#: one segment sum, ``ops/segment.py:segment_sum``.
_SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
             "index_reduce", "index_reduce_"}
_SEGMENT_SUM = ("segment.py", "segment_sum")


def _keyword(call, name, position):
    """The node of ``call``'s argument ``name`` (or its ``position``-th
    positional argument), or None."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return call.args[position] if len(call.args) > position else None


def _is_const(node, values):
    return isinstance(node, ast.Constant) and node.value in values


def _unordered_sums(source, filename="<source>"):
    """``(line, call)`` of each call in ``source`` that sums floats in an
    order that varies on the card, outside ``segment_sum``: ``index_add``,
    ``scatter_add``, ``index_reduce``, ``put_`` / ``index_put(_)`` with
    accumulate not a literal False, ``scatter_reduce`` with a reduce other
    than a literal ``"amin"`` / ``"amax"``, ``bincount`` with weights and
    ``multinomial`` with replacement not a literal False."""
    found = []

    def visit(node, inside):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside = inside or (os.path.basename(filename),
                                node.name) == _SEGMENT_SUM
        if isinstance(node, ast.Call) and not inside:
            f = node.func
            name = (f.attr if isinstance(f, ast.Attribute) else
                    f.id if isinstance(f, ast.Name) else "")
            # ``torch.f(t, ...)`` (or numpy's) takes the tensor ``t.f(...)``
            # is called on as its first argument.
            shift = int(isinstance(f, ast.Name) or (
                isinstance(f.value, ast.Name)
                and f.value.id in ("torch", "np", "numpy")))
            bad = name in _SCATTERS
            if name in ("put_", "index_put", "index_put_"):
                acc = _keyword(node, "accumulate", 2 + shift)
                bad = acc is not None and not _is_const(acc, (False,))
            if name in ("scatter_reduce", "scatter_reduce_"):
                red = _keyword(node, "reduce", 3 + shift)
                bad = not _is_const(red, ("amin", "amax"))
            if name == "bincount":
                wts = _keyword(node, "weights", shift)
                bad = wts is not None and not _is_const(wts, (None,))
            if name == "multinomial":
                rep = _keyword(node, "replacement", 1 + shift)
                bad = rep is not None and not _is_const(rep, (False,))
            if bad:
                found.append((node.lineno, name))
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(ast.parse(source, filename), False)
    return found


def _port_findings(scan):
    """``path:line call`` of each finding of ``scan(source, path)`` over
    the port's modules."""
    root = os.path.join(REPO, "kmeans_tpu_torch")
    bad = []
    for dirpath, _, files in os.walk(root):
        for name in sorted(files):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    bad += [f"{os.path.relpath(path, REPO)}:{line} {call}"
                            for line, call in scan(f.read(), path)]
    return bad


def test_port_sums_floats_by_label_only_in_segment_sum():
    """No module of the port sums floats by label with float atomics or a
    float scan on the card (ROADMAP C11): every such sum is
    ``ops.segment.segment_sum``, which sums in a fixed order there."""
    bad = _port_findings(_unordered_sums)
    assert not bad, bad


@pytest.mark.parametrize("source,caught", [
    ("t.index_add_(0, i, v)", True),
    ("torch.index_add(t, 0, i, v)", True),
    ("t.scatter_add_(0, i, v)", True),
    ("t.index_reduce_(0, i, v, 'prod')", True),
    ("t.index_put_((i,), v, accumulate=True)", True),
    ("t.index_put_((i,), v, True)", True),
    ("t.put_(i, v, accumulate=flag)", True),
    ("t.index_put_((i,), v)", False),
    ("t.index_put_((i,), v, accumulate=False)", False),
    ("t.scatter_reduce(0, i, v, 'sum')", True),
    ("t.scatter_reduce_(0, i, v, reduce=how)", True),
    ("t.scatter_reduce(0, i, v, 'amin', include_self=False)", False),
    ("t.scatter_reduce_(0, i, v, reduce='amax')", False),
    ("torch.bincount(i, w)", True),
    ("torch.bincount(i, weights=w, minlength=3)", True),
    ("torch.bincount(i, minlength=3)", False),
    ("torch.multinomial(p, 4, replacement=True)", True),
    ("torch.multinomial(p, 4, True)", True),
    ("p.multinomial(4, True)", True),
    ("i.bincount(w)", True),
    ("torch.index_put(t, (i,), v, True)", True),
    ("torch.multinomial(p, 4, replacement=False)", False),
    ("def segment_sum(v, i, k):\n    return t.index_add_(0, i, v)", False),
    ("def other(v, i, k):\n    return t.index_add_(0, i, v)", True),
])
def test_unordered_sum_guard_catches_each_form(source, caught):
    """The guard above flags each call it names, passes the orderly forms,
    and allows the scatter inside ``segment_sum`` alone."""
    assert bool(_unordered_sums(source, "segment.py")) == caught


def _unordered_selections(source, filename="<source>"):
    """``(line, call)`` of each selection by value whose order among equal
    values is not ``lax.top_k``'s (ROADMAP C13): a ``topk`` call, and a
    torch ``sort`` / ``argsort`` whose indices are used without a literal
    ``stable=True``.  A sort whose values alone are read (``.values``,
    ``[0]``), a statement ``xs.sort(...)`` (a list in place) and numpy's
    sorts (which mirror the reference's own numpy calls) pass."""
    tree = ast.parse(source, filename)
    parent = {child: node for node in ast.walk(tree)
              for child in ast.iter_child_nodes(node)}
    found = []

    def indices_used(call, name):
        up = parent.get(call)
        if isinstance(up, ast.Expr):
            return False
        if name == "argsort":
            return True
        if isinstance(up, ast.Attribute):
            return up.attr != "values"
        if isinstance(up, ast.Subscript) and up.value is call:
            return not _is_const(up.slice, (0,))
        return True

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = (f.attr if isinstance(f, ast.Attribute) else
                f.id if isinstance(f, ast.Name) else "")
        on_numpy = (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy"))
        bad = name == "topk"
        if name in ("sort", "argsort") and not on_numpy:
            stable = _keyword(node, "stable", len(node.args))
            bad = (not _is_const(stable, (True,))
                   and indices_used(node, name))
        if bad:
            found.append((node.lineno, name))
    return sorted(found)


def test_port_selects_by_value_only_in_lax_top_k_order():
    """No module of the port picks rows by value in an order of its own on
    a tie (ROADMAP C13): every top-m is ``ops.select.top_stable`` (a stable
    sort), no module calls ``topk``, and every sort whose indices are used
    is stable."""
    bad = _port_findings(_unordered_selections)
    assert not bad, bad


@pytest.mark.parametrize("source,caught", [
    ("torch.topk(v, 3)", True),
    ("v.topk(3).indices", True),
    ("_, i = torch.topk(v, k=3, sorted=True)", True),
    ("def top_stable(v, m):\n    return torch.topk(v, m)", True),
    ("i = torch.sort(x, descending=True, stable=True).indices", False),
    ("v, i = torch.sort(x, descending=True)", True),
    ("i = torch.sort(x).indices", True),
    ("i = torch.sort(x)[1]", True),
    ("v, i = torch.sort(x, descending=True, stable=True)", False),
    ("v, i = x.sort(stable=True)", False),
    ("v, i = torch.sort(x, stable=flag)", True),
    ("v = torch.sort(x, descending=True).values", False),
    ("v = torch.sort(x)[0]", False),
    ("i = torch.argsort(x)", True),
    ("i = x.argsort(descending=True)", True),
    ("i = torch.argsort(x, stable=True)", False),
    ("events.sort(key=lambda e: e['ts'])", False),
    ("i = np.argsort(-d2)", False),
    ("v = np.sort(x)", False),
])
def test_unordered_selection_guard_catches_each_form(source, caught):
    """The guard above flags each unordered selection and passes the
    stable and value-only forms."""
    assert bool(_unordered_selections(source)) == caught


def test_soft_balanced_and_pca_entry_points_default_to_the_card(tmp_path):
    """The families of ROADMAP A9b run on the card unless the caller asks
    for the CPU: without a card each entry point raises, with no quiet
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import kmeans_tpu_torch as kt
    from kmeans_tpu_torch.data import pca_fit, pca_fit_stream
    from kmeans_tpu_torch.models import fuzzy_memberships

    x, c0 = _problem()
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    data = np.load(path, mmap_mode="r")
    calls = [
        lambda: kt.fit_gmm(x, 5, init=c0),
        lambda: kt.GaussianMixture(n_components=5).fit(x),
        lambda: kt.fit_gmm_stream(data, 5, init=c0, steps=2),
        lambda: kt.fit_fuzzy(x, 5, init=c0),
        lambda: kt.FuzzyCMeans(n_clusters=5).fit(x),
        lambda: fuzzy_memberships(x, c0),
        lambda: kt.fit_balanced(x, 5, init=c0),
        lambda: kt.BalancedKMeans(n_clusters=5).fit(x),
        lambda: pca_fit(x, 2),
        lambda: pca_fit_stream(data, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


PAIRWISE_ENTRIES = {
    "fit_kmedoids": lambda kt, x: kt.fit_kmedoids(x, 3, init=[0, 1, 2]),
    "KMedoids": lambda kt, x: kt.KMedoids(n_clusters=3).fit(x),
    "fit_kernel_kmeans": lambda kt, x: kt.fit_kernel_kmeans(x, 3),
    "KernelKMeans": lambda kt, x: kt.KernelKMeans(n_clusters=3).fit(x),
    "kernel_assign": lambda kt, x: kt.models.kernel_assign(
        x, x, np.zeros(len(x), np.int32), k=3),
    "nystrom_features": lambda kt, x: kt.models.nystrom_features(x, 8),
    "spectral_embedding": lambda kt, x: kt.models.spectral_embedding(x, 3),
    "fit_spectral": lambda kt, x: kt.fit_spectral(x, 3),
    "SpectralClustering": lambda kt, x: kt.SpectralClustering(
        n_clusters=3).fit(x),
    "make_rings": lambda kt, x: kt.data.make_rings(0, 10),
    "make_moons": lambda kt, x: kt.data.make_moons(0, 10),
}


@pytest.mark.parametrize("entry", list(PAIRWISE_ENTRIES))
def test_pairwise_entry_points_default_to_the_card(entry):
    """The pairwise families and the rings / moons generators run on the
    card unless the caller passes ``device="cpu"``: without a card each
    raises, with no quiet fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import kmeans_tpu_torch as kt
    import kmeans_tpu_torch.data  # noqa: F401
    import kmeans_tpu_torch.models  # noqa: F401

    x, _ = _problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PAIRWISE_ENTRIES[entry](kt, x[:60])
