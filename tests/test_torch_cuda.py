"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (Hopper, ``sm_90a``) and ``nvcc``; it
skips without a card.  On the machine with the card, run from the root of a
checkout (that machine may have no JAX, which ``tests/conftest.py`` imports):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Inputs are tie-free blobs, so labels must be equal.  Sums agree to rtol
1e-4 and atol 1e-4·max|want|: the kernels fold with f32 atomics, in an
order that changes from run to run.  Counts of binary weights are exact.
"""

import numpy as np
import pytest
import torch

from kmeans_tpu_torch import KMeans, KMeansConfig, fit_lloyd
from kmeans_tpu_torch.ops import cuda_lloyd as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _blobs(seed, n, d, k, device):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(k, d)).astype(np.float32) * 4
    lab = rng.integers(0, k, size=n)
    x = (centres[lab] + rng.normal(size=(n, d))).astype(np.float32)
    c = (centres + 0.1 * rng.normal(size=(k, d))).astype(np.float32)
    w = (rng.random(n) > 0.2).astype(np.float32)
    prev = rng.integers(-1, k, size=n).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (x, c, w, prev)]


def _close(got, want):
    atol = 1e-4 * float(want.abs().max().clamp_min(1e-30))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("x_dtype,cd", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("n,d,k", [(1031, 64, 5), (2053, 100, 130)])
def test_kernels_match_plain_versions(card, n, d, k, x_dtype, cd):
    x, c, w, prev = _blobs(0, n, d, k, card)
    x = x.to(x_dtype)
    K.reset_launch_counts()
    got = K.lloyd_pass_cuda(x, c, weights=w, compute_dtype=cd)
    want = K.lloyd_pass_plain(x, c, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:], want[1:]):
        _close(g, e)
    got = K.lloyd_delta_cuda(x, c, prev, weights=w, compute_dtype=cd)
    want = K.lloyd_delta_plain(x, c, prev, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, e in zip(got[1:5], want[1:5]):
        _close(g, e)
    assert int(got[5]) == int(want[5]) and int(got[6]) == int(want[6])
    labels = torch.from_numpy(
        np.random.default_rng(1).integers(-2, k + 2, size=n).astype(np.int32)
    ).to(card)
    got = K.accumulate_cuda(x, labels, k, weights=w, compute_dtype=cd)
    want = K.accumulate_plain(x, labels, k, weights=w, compute_dtype=cd)
    torch.cuda.synchronize()
    for g, e in zip(got, want):
        _close(g, e)
    assert K.launch_counts() == {"lloyd_pass_cuda": 1, "lloyd_delta_cuda": 1,
                                 "accumulate_cuda": 1}


def test_fit_on_the_card_matches_the_plain_backend(card):
    x, c, _, _ = _blobs(2, 4099, 48, 7, card)
    states = {}
    for backend in ("auto", "plain"):
        cfg = KMeansConfig(k=7, update="delta", backend=backend)
        states[backend] = fit_lloyd(x, 7, init=c, config=cfg, max_iter=20,
                                    tol=-1.0)
    a, b = states["auto"], states["plain"]
    assert torch.equal(a.labels, b.labels)
    _close(a.centroids, b.centroids)
    _close(a.inertia, b.inertia)
    km = KMeans(n_clusters=7, update="delta", compute_dtype="bfloat16").fit(x)
    assert km.cluster_centers_.is_cuda and np.isfinite(km.inertia_)
