"""The port's sums by label against the JAX package's, on the CPU.

Every float sum by label in ``kmeans_tpu_torch`` goes through
``ops.segment.segment_sum`` (``tests/test_torch_fit.py`` guards the
sources), which on the CPU is ``index_add_`` and on the card sums in a
fixed order (``tests/test_torch_cuda.py`` runs each path twice there).
Here, from numpy-seeded inputs: the segment sum against
``jax.ops.segment_sum`` to rtol 1e-6 and bit for bit against the
``index_add_`` it replaced; the plain fold against the same ``index_add_``
bit for bit; silhouette's one-hot sums against the reference's
``_silhouette_samples`` to the tolerances of ``tests/test_torch_metrics.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu import metrics as ref_metrics
from kmeans_tpu_torch import metrics as port_metrics
from kmeans_tpu_torch.ops import cuda_lloyd as K
from kmeans_tpu_torch.ops.segment import segment_sum

RTOL = 1e-6

SEGMENT_CASES = {
    "1-D": dict(n=500, shape=(), k=7, lo=0),
    "2-D": dict(n=700, shape=(5,), k=11, lo=0),
    "3-D": dict(n=300, shape=(2, 3), k=4, lo=0),
    "outside [0, k)": dict(n=600, shape=(3,), k=6, lo=-3),
    "empty k": dict(n=50, shape=(4,), k=0, lo=-2),
    "no rows": dict(n=0, shape=(3,), k=5, lo=0),
}


def _segment_inputs(seed, n, shape, k, lo):
    """Fractional values (weights-like, uniform in [0.25, 1.25), times a
    normal draw past 1-D) and indices in ``[lo, k + 2)``."""
    rng = np.random.default_rng(seed)
    w = rng.random(n) + 0.25
    v = w.reshape((n,) + (1,) * len(shape)) * (
        rng.normal(size=(n,) + shape) if shape else 1.0)
    idx = rng.integers(lo, k + 2 if lo < 0 else max(k, 1), size=n)
    return v.astype(np.float32), idx.astype(np.int32)


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_sum_matches_jax_segment_sum(case):
    c = SEGMENT_CASES[case]
    v, idx = _segment_inputs(sorted(SEGMENT_CASES).index(case),
                             c["n"], c["shape"], c["k"], c["lo"])
    got = segment_sum(torch.from_numpy(v), torch.from_numpy(idx), c["k"])
    want = jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(idx),
                               num_segments=c["k"])
    assert got.shape == tuple(want.shape) and got.dtype == torch.float32
    scale = max(1.0, float(np.abs(v).max(initial=0.0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=RTOL * scale)
    # On the CPU it is the index_add_ it replaced, bit for bit, and it adds
    # into a given ``out``.
    keep = (idx >= 0) & (idx < c["k"])
    old = torch.zeros(got.shape).index_add_(
        0, torch.from_numpy(idx[keep]).long(), torch.from_numpy(v[keep]))
    assert torch.equal(got, old)
    base = torch.ones(got.shape)
    assert segment_sum(torch.from_numpy(v), torch.from_numpy(idx), c["k"],
                       out=base) is base
    assert torch.equal(base, torch.ones(got.shape).index_add_(
        0, torch.from_numpy(idx[keep]).long(), torch.from_numpy(v[keep])))


@pytest.mark.parametrize("update,cd", [("segment", torch.bfloat16),
                                       ("matmul", torch.bfloat16),
                                       ("matmul", torch.float32)])
def test_plain_fold_on_the_cpu_is_the_index_add_it_was(update, cd):
    """``lloyd_pass_plain``'s fold on the CPU sums each chunk's rows with
    ``index_add_`` in row order, chunk after chunk, as before: its sums
    and counts equal that loop bit for bit."""
    rng = np.random.default_rng(30)
    n, d, k, chunk = 1500, 9, 6, 512
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cd)
    c = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32))
    w = torch.from_numpy((rng.random(n) + 0.25).astype(np.float32))
    labels, _, sums, counts, _ = K.lloyd_pass_plain(
        x, c, weights=w, compute_dtype=cd, update=update, chunk_size=chunk)
    fold = torch.float32 if update == "segment" else cd
    want_s, want_c = torch.zeros(k, d), torch.zeros(k)
    for lo in range(0, n, chunk):
        lab = labels[lo:lo + chunk].long()
        wr = w[lo:lo + chunk]
        want_s.index_add_(0, lab, x[lo:lo + chunk].to(fold).float()
                          * wr[:, None])
        want_c.index_add_(0, lab, wr)
    assert torch.equal(sums, want_s) and torch.equal(counts, want_c)


@pytest.mark.parametrize("compute_dtype,rtol", [(None, 1e-5),
                                                ("bfloat16", 1e-4)])
@pytest.mark.parametrize("chunk", [64, 500])
def test_one_hot_silhouette_matches_the_reference(compute_dtype, rtol,
                                                  chunk):
    """Silhouette's per-cluster sums as the reference forms them (a
    one-hot product a chunk at a time), over rows some of which are
    invalid or unlabelled and a cluster left empty: each row's score
    against the reference's ``_silhouette_samples``."""
    rng = np.random.default_rng(31)
    n, d, k = 700, 5, 6
    centres = rng.normal(size=(k, d)) * 4
    lab = rng.integers(0, k - 1, size=n)              # cluster k-1 empty
    x = (centres[lab] + 0.6 * rng.normal(size=(n, d))).astype(np.float32)
    valid = rng.random(n) > 0.1
    lab = np.where(rng.random(n) < 0.05, -1, lab).astype(np.int32)
    ev = np.flatnonzero(valid & (lab >= 0))[:150]
    want = ref_metrics._silhouette_samples(
        jnp.asarray(x[ev]), jnp.asarray(lab[ev]), jnp.asarray(x),
        jnp.asarray(np.maximum(lab, 0)), jnp.asarray(valid & (lab >= 0)),
        k=k, chunk_size=chunk, compute_dtype=compute_dtype)
    got = port_metrics._silhouette_samples(
        torch.from_numpy(x[ev]), torch.from_numpy(lab[ev]),
        torch.from_numpy(x), torch.from_numpy(lab), torch.from_numpy(valid),
        k=k, chunk_size=chunk, compute_dtype=compute_dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=rtol)
    np.testing.assert_allclose(float(got.mean()), float(np.mean(want)),
                               rtol=rtol)
