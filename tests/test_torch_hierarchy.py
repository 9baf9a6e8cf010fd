"""The port's dendrogram merge (``models/hierarchy.py``) against the JAX
package's, bit for bit.

The module is numpy on the host in both packages, so the linkage matrix,
the cut and the merged labels and centers must be equal to the last bit,
for every linkage method, with and without counts (zero counts included),
on reference states and on port states (tensors) alike.
"""

import numpy as np
import pytest
import torch

from kmeans_tpu.models import KMeansState as RefState
from kmeans_tpu.models import hierarchy as ref_h
from kmeans_tpu.models import state_counts as ref_state_counts
from kmeans_tpu_torch.models import hierarchy as port_h
from kmeans_tpu_torch.models import (KMeansState, TrimmedState, merge_to_k,
                                     state_counts)

METHODS = ["ward", "average", "single", "complete"]


def _centers(seed, k=12, d=5):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d)).astype(np.float32) * 4
    counts = rng.integers(1, 500, size=k).astype(np.float32)
    return c, counts


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("weighted", [False, True])
def test_linkage_and_cut_equal_the_reference(method, weighted):
    c, counts = _centers(1)
    if weighted:
        counts[[2, 7]] = 0.0          # empty clusters merge almost free
    w = counts if weighted else None
    z = port_h.centroid_linkage(c, w, method=method)
    want = ref_h.centroid_linkage(c, w, method=method)
    assert z.dtype == want.dtype and np.array_equal(z, want)
    for k in (1, 3, 7, 12):
        assert np.array_equal(port_h.cut_linkage(z, k),
                              ref_h.cut_linkage(want, k))


def test_errors_equal_the_reference():
    c, counts = _centers(2)
    cases = [
        lambda h: h.centroid_linkage(c[:1]),
        lambda h: h.centroid_linkage(c, -counts),
        lambda h: h.centroid_linkage(c, method="median"),
        lambda h: h.cut_linkage(h.centroid_linkage(c), 0),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(ref_h)
        with pytest.raises(ValueError) as got:
            case(port_h)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_merge_to_k_equals_the_reference_on_either_state(k):
    """A reference state and the same fields as a port state (tensors)
    merge to the same labels and centers; outliers (-1) pass through."""
    c, counts = _centers(3)
    counts[4] = 0.0
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 12, size=300).astype(np.int32)
    labels[::17] = -1
    ref = RefState(centroids=c, labels=labels, inertia=np.float32(1.0),
                   n_iter=np.int32(3), converged=np.bool_(True),
                   counts=counts)
    port = TrimmedState(
        centroids=torch.from_numpy(c), labels=torch.from_numpy(labels),
        inertia=torch.tensor(1.0), n_iter=torch.tensor(3),
        converged=torch.tensor(True), counts=torch.from_numpy(counts),
        outlier_mask=torch.from_numpy(labels < 0))
    want_l, want_c = ref_h.merge_to_k(ref, k)
    got_l, got_c = merge_to_k(port, k)
    assert got_l.dtype == want_l.dtype and np.array_equal(got_l, want_l)
    assert got_c.dtype == want_c.dtype and np.array_equal(got_c, want_c)
    assert (got_l[labels < 0] == -1).all()
    z = ref_h.centroid_linkage(c, counts)
    got_l2, _ = port_h.merge_to_k(ref, k, linkage=z)
    assert np.array_equal(got_l2, want_l)


def test_state_counts_label_histogram_fallback():
    """A state with labels but no counts: the label histogram (negative
    labels skipped), as the reference's mapping gives it."""
    c, _ = _centers(5, k=4)
    labels = np.array([0, 1, 1, 3, -1, 3, 3], np.int32)

    class NoCounts:
        centroids = c

    s = NoCounts()
    s.labels = labels
    want = ref_state_counts(s)
    s.labels = torch.from_numpy(labels)
    got = state_counts(s)
    assert np.array_equal(got, want) and got.tolist() == [1, 2, 0, 3]
    st = KMeansState(torch.from_numpy(c), torch.from_numpy(labels),
                     torch.tensor(0.0), torch.tensor(1), torch.tensor(True),
                     torch.ones(4))
    assert state_counts(st) is st.counts
