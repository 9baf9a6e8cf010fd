"""The port's sweep operators against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
reference's Pallas kernels run in interpret mode (as ``tests/test_pallas.py``
runs them) and its XLA route as it is; the port runs with ``device="cpu"``,
where every kernel wrapper takes its plain PyTorch version.

Tolerances: labels must be equal (the inputs are tie-free, or tie exactly
where a test pins the lowest-index rule); f32 outputs agree to rtol 1e-5 and
atol 1e-4·max|want| because the two packages sum the same f32 terms in
different orders (XLA:CPU splits long contractions, the port chunks rows and
folds with ``index_add_``); counts of binary weights are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops.delta import delta_pass as ref_delta_pass
from kmeans_tpu.ops.distance import assign as ref_assign
from kmeans_tpu.ops.distance import chunk_tiles as ref_chunk_tiles
from kmeans_tpu.ops.distance import pairwise_sq_dists as ref_pairwise
from kmeans_tpu.ops.lloyd import lloyd_pass as ref_lloyd_pass
from kmeans_tpu.ops.lloyd import resolve_update as ref_resolve_update
from kmeans_tpu.ops.pallas_lloyd import (accumulate_pallas,
                                         lloyd_delta_pallas,
                                         lloyd_pass_pallas)
from kmeans_tpu.ops.update import apply_update as ref_apply_update
from kmeans_tpu.ops.update import \
    reseed_empty_farthest as ref_reseed_empty_farthest
from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops.delta import (DELTA_REFRESH, default_cap,
                                        delta_kernel_plan, delta_pass)
from kmeans_tpu_torch.ops.distance import (assign, chunk_tiles,
                                           pairwise_sq_dists)
from kmeans_tpu_torch.ops.lloyd import (lloyd_pass, resolve_backend,
                                        resolve_update)
from kmeans_tpu_torch.ops.update import apply_update, reseed_empty_farthest

CPU = "cpu"


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=1e-5, what=""):
    got = _np(got).astype(np.float64)
    want = _np(want).astype(np.float64)
    atol = 1e-4 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _blobs(seed, n, d, k, spread=3.0):
    """Tie-free data: k well-separated centres, points near them, and
    centroids a small step off the centres."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    c = (centres + 0.1 * rng.normal(size=(k, d))).astype(np.float32)
    return x, c


def _pass_outputs_match(port, ref, what):
    names = ("labels", "min_d2", "sums", "counts", "inertia")
    np.testing.assert_array_equal(_np(port[0]), _np(ref[0]),
                                  err_msg=f"{what} labels")
    for p, r, name in zip(port[1:], ref[1:], names[1:]):
        _close(p, r, what=f"{what} {name}")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(300, 128, 3), (1030, 100, 7)])
def test_lloyd_pass_matches_pallas_and_xla(n, d, k, cd):
    x, c = _blobs(0, n, d, k)
    w = (np.random.default_rng(1).random(n) > 0.3).astype(np.float32)
    port = lloyd_pass(x, c, weights=w, weights_are_binary=True,
                      compute_dtype=cd, device=CPU)
    pallas = lloyd_pass_pallas(jnp.asarray(x), jnp.asarray(c),
                               weights=jnp.asarray(w), compute_dtype=cd,
                               interpret=True)
    xla = ref_lloyd_pass(jnp.asarray(x), jnp.asarray(c),
                         weights=jnp.asarray(w), weights_are_binary=True,
                         compute_dtype=cd)
    _pass_outputs_match(port, pallas, "vs pallas")
    _pass_outputs_match(port, xla, "vs xla")
    np.testing.assert_array_equal(_np(port[3]), np.asarray(xla[3]))


def test_lloyd_pass_assignment_only_and_segment_demotion():
    x, c = _blobs(2, 257, 16, 5)
    lab, mind, sums, counts, _ = lloyd_pass(x, c, with_update=False,
                                            device=CPU)
    want = ref_lloyd_pass(jnp.asarray(x), jnp.asarray(c), with_update=False)
    np.testing.assert_array_equal(_np(lab), np.asarray(want[0]))
    _close(mind, want[1])
    assert not sums.any() and not counts.any()
    # Fractional weights in bf16 demote the cd fold to the f32 segment sum.
    w = np.random.default_rng(3).random(257).astype(np.float32)
    port = lloyd_pass(x, c, weights=w, compute_dtype="bfloat16", device=CPU)
    ref = ref_lloyd_pass(jnp.asarray(x), jnp.asarray(c),
                         weights=jnp.asarray(w), compute_dtype="bfloat16")
    _pass_outputs_match(port, ref, "segment")


def _swap_sweep(cd):
    """A first (sentinel) sweep at c0 and an incremental one at c1, where c1
    swaps two centroids so the rows of two blobs change label."""
    n, d, k = 1030, 128, 6
    x, c0 = _blobs(4, n, d, k)
    c1 = c0.copy()
    c1[[0, 1]] = c0[[1, 0]]
    w = np.ones(n, np.float32)
    w[::7] = 0.0                       # zero-weight rows never "change"
    return x, c0, c1, w, cd


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_delta_pass_matches_pallas_and_xla(cd):
    x, c0, c1, w, cd = _swap_sweep(cd)
    n, k = x.shape[0], c0.shape[0]
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    kw = dict(weights=w, compute_dtype=cd, device=CPU)
    rkw = dict(weights=jw, compute_dtype=cd, cap=default_cap(n))
    # Sentinel first sweep: the delta over zero sums is the full reduction.
    sentinel = np.full(n, -1, np.int32)
    zs, zc = np.zeros((k, x.shape[1]), np.float32), np.zeros(k, np.float32)
    first = delta_pass(x, c0, sentinel, zs, zc, **kw)
    ref_first = ref_delta_pass(jx, jnp.asarray(c0), jnp.asarray(sentinel),
                               jnp.asarray(zs), jnp.asarray(zc), **rkw)
    _pass_outputs_match(first[:5], ref_first[:5], "sentinel")
    assert int(first[5]) == int(ref_first[5]) == int((w > 0).sum())
    # Incremental sweep at the swapped centroids.
    lab0, s0, c0n = _np(first[0]), _np(first[2]), _np(first[3])
    inc = delta_pass(x, c1, lab0, s0, c0n, **kw)
    ref_inc = ref_delta_pass(jx, jnp.asarray(c1), jnp.asarray(lab0),
                             jnp.asarray(s0), jnp.asarray(c0n), **rkw)
    _pass_outputs_match(inc[:5], ref_inc[:5], "incremental vs xla")
    assert int(inc[5]) == int(ref_inc[5]) > 0
    pal = lloyd_delta_pallas(jx, jnp.asarray(c1), jnp.asarray(lab0),
                             weights=jw, compute_dtype=cd, interpret=True)
    plain = K.lloyd_delta_plain(torch.from_numpy(x), torch.from_numpy(c1),
                                torch.from_numpy(lab0),
                                weights=torch.from_numpy(w), compute_dtype=cd)
    np.testing.assert_array_equal(_np(plain[0]), np.asarray(pal[0]))
    for i, name in ((1, "min_d2"), (2, "dsums"), (3, "dcounts"),
                    (4, "inertia")):
        _close(plain[i], pal[i], what=f"delta kernel {name}")
    assert int(plain[5]) == int(pal[5])
    assert int(plain[6]) == int(pal[6]) == 1     # one tile over 128 changed
    # force_full recomputes the sums from scratch; same as the reference.
    full = delta_pass(x, c1, lab0, s0 * 0, c0n * 0, force_full=True, **kw)
    ref_full = ref_delta_pass(jx, jnp.asarray(c1), jnp.asarray(lab0),
                              jnp.asarray(s0), jnp.asarray(c0n),
                              force_full=jnp.asarray(True), **rkw)
    _pass_outputs_match(full[:5], ref_full[:5], "force_full")
    _close(full[2], inc[2], what="force_full sums vs incremental")


def test_delta_pass_without_mind_poisons_and_kernel_returns_raw_scores():
    x, c0, c1, w, cd = _swap_sweep("float32")
    n = x.shape[0]
    lab0 = _np(lloyd_pass(x, c0, device=CPU)[0])
    out = delta_pass(x, c1, lab0, np.zeros((6, 128), np.float32),
                     np.zeros(6, np.float32), with_mind=False, device=CPU)
    ref = ref_delta_pass(jnp.asarray(x), jnp.asarray(c1), jnp.asarray(lab0),
                         jnp.zeros((6, 128)), jnp.zeros(6), cap=n // 8,
                         with_mind=False)
    assert torch.isnan(out[1]).all() and torch.isnan(out[4])
    assert np.isnan(np.asarray(ref[1])).all()
    raw = K.lloyd_delta_plain(torch.from_numpy(x), torch.from_numpy(c1),
                              torch.from_numpy(lab0), with_mind=False)[1]
    pal_raw = lloyd_delta_pallas(jnp.asarray(x), jnp.asarray(c1),
                                 jnp.asarray(lab0), with_mind=False,
                                 interpret=True)[1]
    _close(raw, pal_raw, what="raw scores")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_exact_ties_go_to_the_lowest_index(cd):
    x, c = _blobs(5, 300, 128, 6)
    c[1], c[3] = c[0], c[2]             # exact duplicates: scores tie
    x[:40] = c[0]                        # rows sitting on the tied centroid
    port = lloyd_pass(x, c, compute_dtype=cd, device=CPU)[0]
    pallas = lloyd_pass_pallas(jnp.asarray(x), jnp.asarray(c),
                               compute_dtype=cd, interpret=True)[0]
    xla = ref_lloyd_pass(jnp.asarray(x), jnp.asarray(c), compute_dtype=cd)[0]
    np.testing.assert_array_equal(_np(port), np.asarray(pallas))
    np.testing.assert_array_equal(_np(port), np.asarray(xla))
    assert not np.isin(_np(port), [1, 3]).any()
    prev = np.full(300, -1, np.int32)
    delta = K.lloyd_delta_plain(torch.from_numpy(x), torch.from_numpy(c),
                                torch.from_numpy(prev), compute_dtype=cd)[0]
    np.testing.assert_array_equal(_np(delta), _np(port))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_accumulate_matches_pallas_with_out_of_range_labels(cd):
    n, d, k = 300, 100, 5
    x, _ = _blobs(6, n, d, k)
    rng = np.random.default_rng(7)
    labels = rng.integers(-2, k + 4, size=n).astype(np.int32)
    scores = rng.normal(size=n).astype(np.float32) * 10
    w = (rng.random(n) > 0.25).astype(np.float32)
    port = K.accumulate_cuda(torch.from_numpy(x), torch.from_numpy(labels), k,
                             scores=torch.from_numpy(scores),
                             weights=torch.from_numpy(w), compute_dtype=cd)
    ref = accumulate_pallas(jnp.asarray(x), jnp.asarray(labels), k,
                            scores=jnp.asarray(scores),
                            weights=jnp.asarray(w), compute_dtype=cd,
                            interpret=True)
    for p, r, name in zip(port, ref, ("sums", "counts", "min_d2")):
        _close(p, r, what=name)
    np.testing.assert_array_equal(_np(port[1]), np.asarray(ref[1]))


def test_wrappers_run_plain_versions_on_cpu_and_count_nothing():
    x, c = _blobs(8, 200, 12, 4)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    K.reset_launch_counts()
    got = K.lloyd_pass_cuda(xt, ct)
    want = K.lloyd_pass_plain(xt, ct)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    sentinel = torch.full((200,), -1, dtype=torch.int32)
    K.lloyd_delta_cuda(xt, ct, sentinel)
    K.accumulate_cuda(xt, got[0], 4)
    need = torch.ones(200, dtype=torch.bool)
    zeros = torch.zeros(200)
    got = K.lloyd_hamerly_cuda(xt, ct, sentinel, need, zeros, zeros)
    want = K.lloyd_hamerly_plain(xt, ct, sentinel, need, zeros, zeros)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert K.launch_counts() == {"lloyd_pass_cuda": 0, "lloyd_delta_cuda": 0,
                                 "accumulate_cuda": 0,
                                 "lloyd_hamerly_cuda": 0}


def test_cuda_input_checks_refuse_what_the_kernels_do_not_take():
    """The checks a CUDA wrapper makes before it passes pointers."""
    x, w = torch.zeros(10, 4), torch.ones(10)
    lab, c = torch.zeros(10, dtype=torch.int32), torch.zeros(3, 4)
    K._check_cuda_inputs("t", x, 3, torch.float32, w, c, lab)
    bad = [
        ((x.T, 3, torch.float32, w, c), "contiguous"),
        ((x.half(), 3, torch.float32, w, c), "dtype"),
        ((x, 3, torch.float16, w, c), "dtype"),
        ((x, 3, torch.float32, w, torch.zeros(3, 5)), "centroids shape"),
        ((x, 3, torch.float32, torch.ones(9), c), "per-row"),
        ((x, 3, torch.float32, w, None, lab[:9]), "per-row"),
        ((x, 3, torch.float32, w, torch.zeros(4, 3).T), "contiguous"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            K._check_cuda_inputs("t", *args)


def test_kernel_plan_and_backend_resolution():
    x = np.zeros((10, 4), np.float32)
    assert K.kernel_plan(x, 3, device="cuda").mode == "cuda"
    assert K.kernel_plan(torch.zeros(10, 4), 3).mode == "refuse"
    frac = K.kernel_plan(x, 3, weights=np.full(10, 0.5),
                         compute_dtype="bfloat16", device="cuda")
    assert frac.mode == "refuse" and "fractional" in frac.why
    assert K.kernel_plan(x, 3, weights=np.full(10, 0.5),
                         weights_are_binary=True, compute_dtype="bfloat16",
                         device="cuda").mode == "cuda"
    assert K.kernel_plan(x.astype(np.float16), 3,
                         device="cuda").mode == "refuse"
    assert resolve_backend("auto", torch.zeros(10, 4), 3) == "plain"
    assert resolve_backend("plain", x, 3, device="cuda") == "plain"
    assert resolve_backend("auto", x, 3, device="cuda") == "cuda"
    with pytest.raises(ValueError, match="do not take"):
        resolve_backend("cuda", torch.zeros(10, 4), 3)
    with pytest.raises(ValueError, match="do not take"):
        resolve_backend("auto", x, 3, weights=np.full(10, 0.5),
                        compute_dtype="bfloat16", device="cuda")
    with pytest.raises(ValueError, match="no counterpart"):
        resolve_backend("pallas_interpret", x, 3)


@pytest.mark.parametrize("update", ["auto", "matmul", "segment", "delta",
                                    "hamerly", "yinyang"])
@pytest.mark.parametrize("w_exact", [True, False])
def test_resolve_update_matches_reference(update, w_exact):
    try:
        want = ref_resolve_update(update, w_exact=w_exact)
    except ValueError:
        with pytest.raises(ValueError):
            resolve_update(update, w_exact=w_exact)
        return
    assert resolve_update(update, w_exact=w_exact) == want


def test_distance_and_update_match_reference():
    x, c = _blobs(9, 97, 5, 7, spread=3.0)
    _close(pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(c)),
           ref_pairwise(jnp.asarray(x), jnp.asarray(c)))
    lab, mind = assign(x, c, chunk_size=16, device=CPU)
    rlab, rmind = ref_assign(jnp.asarray(x), jnp.asarray(c), chunk_size=16)
    np.testing.assert_array_equal(_np(lab), np.asarray(rlab))
    _close(mind, rmind)
    sums = np.random.default_rng(10).normal(size=(7, 5)).astype(np.float32)
    counts = np.array([3, 0, 1, 0, 2, 5, 1], np.float32)
    new = apply_update(torch.from_numpy(c), torch.from_numpy(sums),
                       torch.from_numpy(counts))
    ref_new = ref_apply_update(jnp.asarray(c), jnp.asarray(sums),
                               jnp.asarray(counts))
    _close(new, ref_new)
    reseeded = reseed_empty_farthest(new, torch.from_numpy(counts),
                                     torch.from_numpy(x), mind)
    ref_reseeded = ref_reseed_empty_farthest(ref_new, jnp.asarray(counts),
                                             jnp.asarray(x), rmind)
    _close(reseeded, ref_reseeded)


@pytest.mark.parametrize("with_w", [False, True])
def test_chunk_tiles_match_reference(with_w):
    x, _ = _blobs(11, 37, 3, 2)
    w = np.random.default_rng(12).random(37).astype(np.float32)
    got = chunk_tiles(torch.from_numpy(x),
                      torch.from_numpy(w) if with_w else None, 16)
    want = ref_chunk_tiles(jnp.asarray(x), jnp.asarray(w) if with_w else None,
                           16)
    assert got[0].shape == (3, 16, 3) and got[2] == want[2] == 37
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))


def test_delta_kernel_plan_is_the_classic_plan():
    x = np.zeros((10, 4), np.float32)
    for kw in (dict(device="cuda"), dict(device="cpu"),
               dict(device="cuda", weights=np.full(10, 0.5),
                    compute_dtype="bfloat16")):
        assert delta_kernel_plan(x, 3, **kw) == K.kernel_plan(x, 3, **kw)


def test_delta_constants_match_reference():
    from kmeans_tpu.ops import delta as ref_delta

    assert DELTA_REFRESH == ref_delta.DELTA_REFRESH == 16
    for n in (1, 7, 8, 1_280_000):
        assert default_cap(n) == ref_delta.default_cap(n)
