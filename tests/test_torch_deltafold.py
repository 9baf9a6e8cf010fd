"""K2's and K4's delta on the fold core against the JAX package, on the CPU.

On the card K2 (``lloyd_delta_cuda``) and K4 (``lloyd_hamerly_cuda``) write
each row's fold weight in their scoring launch -- ``w`` on a changed row,
0 elsewhere (``delta_fold_weights``) -- and fold the changed rows with the
fold core's dual fold: +w at the new label, −w at the old one.  Their
``(dsums, dcounts)`` are ``fold_core_plain`` over those inputs bit for bit
(``tests/test_torch_cuda.py`` holds the kernels to it on the card).  Here
``fold_core_plain`` over the same inputs is held to the reference's
``lloyd_delta_pallas`` and ``lloyd_hamerly_pallas`` in interpret mode, as
``tests/test_pallas.py`` runs them, from inputs made with numpy from a
seed.

Tolerances: labels, counts of binary weights and the changed-row count are
exact; the sums agree to rtol 1e-5 and atol 1e-5·max|want|, because the
fold core sums each bucket's rows in row order and the reference folds
them with a signed one-hot product in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.ops.pallas_lloyd import (lloyd_delta_pallas,
                                         lloyd_hamerly_pallas)
from kmeans_tpu_torch.ops import cuda_lloyd as K

N, D, K_ = 700, 128, 12


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _inputs(seed):
    """Tie-free blobs, centroids a small step off their centres, binary
    weights with zeros, and the labels the centroids give."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(K_, D)).astype(np.float32) * 3
    x = (centres[rng.integers(0, K_, N)]
         + rng.normal(size=(N, D))).astype(np.float32)
    c = (centres + 0.1 * rng.normal(size=(K_, D))).astype(np.float32)
    w = (rng.random(N) > 0.2).astype(np.float32)
    lab = _np(K.lloyd_pass_plain(torch.from_numpy(x), torch.from_numpy(c),
                                 with_update=False)[0])
    return x, c, w, lab, rng


def _prev(case, lab, rng):
    """The previous labelling of each case: all −1 sentinels, none
    changed, every row changed, or a third perturbed (some to −1)."""
    if case == "sentinels":
        return np.full(N, -1, np.int32)
    if case == "none changed":
        return lab.copy()
    if case == "all changed":
        return ((lab + 1) % K_).astype(np.int32)
    prev = lab.copy()
    pert = rng.random(N) < 0.33
    prev[pert] = rng.integers(-1, K_, int(pert.sum()))
    return prev


def _fold(x, w, lab, prev, cd):
    """The fold core's delta at the port's labels: ``fold_core_plain``
    over ``delta_fold_weights``, as K2 and K4 fold on the card."""
    lab_t, prev_t = torch.from_numpy(lab), torch.from_numpy(prev)
    fold_w = K.delta_fold_weights(lab_t, prev_t, torch.from_numpy(w))
    sums, counts = K.fold_core_plain(torch.from_numpy(x), fold_w, lab_t,
                                     prev_t, K_, compute_dtype=cd)
    return sums, counts, fold_w


def _held(got, want):
    """The fold core's (sums, counts) against the reference's delta."""
    sums, counts = _np(got[0]), _np(got[1])
    want_s, want_c = np.asarray(want[0]), np.asarray(want[1])
    atol = 1e-5 * max(float(np.abs(want_s).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(sums, want_s, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(counts, want_c)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["sentinels", "perturbed", "none changed",
                                  "all changed"])
def test_delta_fold_matches_the_delta_kernel(case, cd):
    x, c, w, lab, rng = _inputs(1)
    prev = _prev(case, lab, rng)
    want = lloyd_delta_pallas(jnp.asarray(x), jnp.asarray(c),
                              jnp.asarray(prev), weights=jnp.asarray(w),
                              compute_dtype=cd, interpret=True)
    port = K.lloyd_delta_plain(*(torch.from_numpy(a) for a in (x, c, prev)),
                               weights=torch.from_numpy(w), compute_dtype=cd)
    np.testing.assert_array_equal(_np(port[0]), np.asarray(want[0]))
    sums, counts, fold_w = _fold(x, w, _np(port[0]), prev, cd)
    _held((sums, counts), want[2:4])
    changed = int((fold_w > 0).sum())
    assert changed == int(want[5]) == int(port[5])
    if case == "none changed":
        assert changed == 0 and not sums.any() and not counts.any()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("frac", [0.0, 0.1, 1.0])
def test_delta_fold_matches_the_hamerly_kernel(frac, cd):
    x, c, w, lab, rng = _inputs(2)
    prev = _prev("perturbed", lab, rng)
    if frac == 0.0:
        prev = np.maximum(prev, 0)
    need = (rng.random(N) < frac) | (prev < 0)
    sb = rng.normal(size=N).astype(np.float32)
    args = [prev, need, sb, sb + 1]
    want = lloyd_hamerly_pallas(jnp.asarray(x), jnp.asarray(c),
                                *map(jnp.asarray, args),
                                weights=jnp.asarray(w), compute_dtype=cd,
                                interpret=True)
    port = K.lloyd_hamerly_plain(*(torch.from_numpy(a)
                                   for a in [x, c, *args]),
                                 weights=torch.from_numpy(w),
                                 compute_dtype=cd)
    labels = _np(port[0])
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    np.testing.assert_array_equal(labels[~need], prev[~need])
    sums, counts, fold_w = _fold(x, w, labels, prev, cd)
    _held((sums, counts), want[3:5])
    assert int(want[5]) == int(need.sum())
    assert not _np(fold_w)[~need].any()
