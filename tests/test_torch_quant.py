"""The port's compressed-codebook tier against the JAX package, on the CPU.

``quantize_codebook``, ``dequantize``, ``dequantize_matrix``,
``quant_candidates`` and ``quant_prune`` are NumPy copies: their outputs
must equal the reference's bit for bit.  ``quant_assign_device`` is a
PyTorch scan; the reference's runs under JAX on the CPU.  The two sum the
same f32 products in other orders, so labels are held equal on rows whose
two least upper bounds are more than ``GAP_RTOL`` apart (the other rows
must carry a label whose f64 distance is within ``GAP_RTOL`` of the least),
and ``ok`` equal on rows whose certificate is more than ``GAP_RTOL`` of the
row's bound away from its margin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmeans_tpu.quant import codebook as RQC
from kmeans_tpu.quant import score as RQS
from kmeans_tpu_torch.quant import (QUANT_MODES, dequantize,
                                    dequantize_matrix, quant_assign_device,
                                    quant_candidates, quant_prune,
                                    quantize_codebook)

MODES = sorted(QUANT_MODES)
#: Relative gap under which two f32 bounds or distances are a tie to
#: within the summation order of the two packages (f32 products of
#: d <= 64 terms err by ~1e-6 relative).
GAP_RTOL = 1e-4


def _separated(k, d, n, seed):
    """Centroids in meta-clusters (the closure tables' structure) and
    queries near their own centroid: tie-free nearest centroids."""
    rng = np.random.default_rng(seed)
    g = max(2, int(round(k ** 0.5)))
    meta = rng.normal(size=(g, d)) * 10
    c = meta[rng.integers(0, g, size=k)] + rng.normal(size=(k, d))
    lab = rng.integers(0, k, size=n)
    x = c[lab] + 0.1 * rng.normal(size=(n, d))
    return c.astype(np.float32), x.astype(np.float32)


def _codebooks(seed):
    """A wide dynamic range, all-zero rows and subnormal rows."""
    rng = np.random.RandomState(seed)
    wide = (rng.randn(40, 24) * np.exp(rng.uniform(-14, 14, (40, 24)))
            ).astype(np.float32)
    wide[3] = 0.0
    wide[7] = np.float32(1e-42) * rng.randn(24).astype(np.float32)
    wide[11, :5] = np.float32(3e-45)
    return wide


def _f64_dists(x, c):
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    return ((x64 * x64).sum(1)[:, None] - 2.0 * x64 @ c64.T
            + (c64 * c64).sum(1)[None, :])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_codebook_is_the_reference_bit_for_bit(mode, seed):
    c = _codebooks(seed)
    got, want = quantize_codebook(c, mode), RQC.quantize_codebook(c, mode)
    for name in ("q", "scale", "err", "csq_hat"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.mode == want.mode and got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(dequantize(got), RQC.dequantize(want))
    out = np.empty(c.shape, np.float32)
    np.testing.assert_array_equal(dequantize_matrix(got.q, mode, out=out),
                                  RQC.dequantize_matrix(want.q, mode))
    # The bound holds in float64 on the degenerate rows too.
    r = c.astype(np.float64) - dequantize(got).astype(np.float64)
    assert (got.err.astype(np.float64) >= np.sqrt((r * r).sum(1))).all()


@pytest.mark.parametrize("bad", ["mode", "shape", "nan"])
def test_quantize_codebook_refuses_as_the_reference(bad):
    c = np.ones((4, 3), np.float32)
    args = {"mode": (c, "int4"), "shape": (c[0], "int8"),
            "nan": (np.full((2, 2), np.nan, np.float32), "int8")}[bad]
    with pytest.raises(ValueError) as got:
        quantize_codebook(*args)
    with pytest.raises(ValueError) as want:
        RQC.quantize_codebook(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", MODES)
def test_host_prune_is_the_reference_bit_for_bit(mode):
    """Near-tie shells that force the exact rescore, beside far decoys."""
    rng = np.random.RandomState(7)
    d = 24
    u = rng.randn(d).astype(np.float32)
    c = np.concatenate([u + rng.randn(6, d).astype(np.float32) * 3e-4,
                        rng.randn(26, d).astype(np.float32) * 5 + 10])
    x = (u + rng.randn(200, d).astype(np.float32) * 0.15).astype(np.float32)
    c = c.astype(np.float32)
    qcb = quantize_codebook(c, mode)
    xsq = (x * x).sum(1)
    s = (qcb.csq_hat[None, :] - 2.0 * (x @ dequantize(qcb).T)
         ).astype(np.float32)
    dhat = np.sqrt(np.maximum(xsq[:, None] + s, 0.0))
    for a, b in zip(quant_candidates(dhat, qcb.err[None, :]),
                    RQS.quant_candidates(dhat, qcb.err[None, :])):
        np.testing.assert_array_equal(a, b)
    args = (x, xsq, s, np.broadcast_to(qcb.err, (200, 32)),
            np.broadcast_to(np.arange(32, dtype=np.int32), (200, 32)),
            c, (c * c).sum(1).astype(np.float32))
    got, want = quant_prune(*args), RQS.quant_prune(*args)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[3] == 200                       # every row rescored


def _ref_scan(x, qcb, k_tile):
    lab, ok = RQS.quant_assign_device(
        jnp.asarray(x), jnp.asarray(qcb.q), jnp.asarray(qcb.scale),
        jnp.asarray(qcb.err), jnp.asarray(qcb.csq_hat), qcb.mode,
        k_tile=k_tile)
    return np.asarray(lab), np.asarray(ok)


def _port_scan(x, qcb, k_tile):
    lab, ok = quant_assign_device(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in (
            qcb.q, qcb.scale, qcb.err, qcb.csq_hat)), qcb.mode,
        k_tile=k_tile)
    return lab.numpy(), ok.numpy()


def _bounds64(x, qcb):
    """f64 upper and lower bounds of every (row, centroid), and the margin
    slack, as the scan defines them."""
    dhat = np.sqrt(np.maximum(_f64_dists(x, dequantize(qcb)), 0.0))
    slack = RQS.QUANT_MARGIN_REL * (dhat + 1.0)
    err = qcb.err.astype(np.float64)[None, :]
    return dhat + err + slack, dhat - err - slack


def _check_scan(x, qcb, got, want):
    """Labels equal where the two least upper bounds are apart, ``ok``
    equal where the certificate is away from its margin."""
    up, lo = _bounds64(x, qcb)
    rows = np.arange(len(x))
    srt = np.sort(up, axis=1)
    clear = srt[:, 1] - srt[:, 0] > GAP_RTOL * srt[:, 1]
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[0][clear], want[0][clear])
    for lab in (got[0], want[0]):
        assert (up[rows, lab] - srt[:, 0] <= GAP_RTOL * srt[:, 1]).all()
    b = up[rows, want[0]]
    lo_excl = np.where(np.arange(up.shape[1])[None, :] == want[0][:, None],
                       np.inf, lo).min(axis=1)
    away = np.abs(lo_excl - b) > GAP_RTOL * np.abs(b)
    np.testing.assert_array_equal(got[1][away & clear],
                                  want[1][away & clear])
    return int(want[1].sum())


@pytest.mark.parametrize("k_tile", [None, 128, 100, 37, 1])
@pytest.mark.parametrize("mode", MODES)
def test_quant_scan_matches_the_reference_at_any_tile(mode, k_tile):
    c, x = _separated(300, 32, 240, seed=4)
    x[:40] = (np.random.default_rng(9).normal(size=(40, 32)) * 30
              ).astype(np.float32)        # far rows: bounds overlap
    qcb = quantize_codebook(c, mode)
    got = _port_scan(x, qcb, k_tile)
    want = _ref_scan(x, qcb, k_tile)
    certified = _check_scan(x, qcb, got, want)
    assert 0 < certified < len(x)
    # The scan's result does not depend on its tile.
    whole = _port_scan(x, qcb, None)
    np.testing.assert_array_equal(got[0], whole[0])
    np.testing.assert_array_equal(got[1], whole[1])
    # Certified rows carry the dense label.
    dense = _f64_dists(x, c).argmin(axis=1)
    np.testing.assert_array_equal(got[0][got[1]], dense[got[1]])


@pytest.mark.parametrize("k_tile", [None, 2, 3])
def test_quant_scan_ties_take_the_lowest_index_uncertified(k_tile):
    """Exact duplicate centroids (one on each side of a slice edge at
    ``k_tile`` 2 and 3): the label is the lowest index and the row is not
    certified, so the engine rescores it."""
    c = np.array([[1, 1], [5, 5], [1, 1], [9, 9], [5, 5]], np.float32)
    x = np.array([[1.0, 1.0], [5.0, 5.1], [9.0, 9.0]], np.float32)
    for mode in MODES:
        qcb = quantize_codebook(c, mode)
        lab, ok = _port_scan(x, qcb, k_tile)
        np.testing.assert_array_equal(lab, [0, 1, 3])
        np.testing.assert_array_equal(ok, [False, False, True])
        np.testing.assert_array_equal((lab, ok), _ref_scan(x, qcb, k_tile))


def test_quant_k_tile_bounds_the_scan_temporaries():
    """The engine's slice for the quant scan: a multiple of 128 that keeps
    one (rows, k_tile) f32 temporary within 2**26 elements, at least 128,
    at most k rounded up to 128."""
    from kmeans_tpu_torch.serve.assign import _DEV_SCAN_ELEMS, quant_k_tile

    assert quant_k_tile(8192, 65536) == 8192
    assert quant_k_tile(512, 65536) == 65536
    assert quant_k_tile(64, 1000) == 1024
    assert quant_k_tile(1 << 20, 65536) == 128
    for rows, k in ((8192, 65536), (3000, 65536), (700, 5000), (1, 1)):
        kt = quant_k_tile(rows, k)
        assert kt % 128 == 0 and 128 <= kt <= -(-k // 128) * 128
        assert rows * kt <= _DEV_SCAN_ELEMS or kt == 128
        assert kt == -(-k // 128) * 128 or rows * (kt + 128) > _DEV_SCAN_ELEMS
    assert QUANT_MODES == RQC.QUANT_MODES
