"""Synthetic datasets for tests and benchmarks.

Counterpart of ``kmeans_tpu/data/synthetic.py``: Gaussian blobs, concentric
rings and half-moons made on the device from an explicit
:class:`torch.Generator`, and the evaluation shapes of ``BASELINE.json``.
The draws differ from the reference's (``jax.random`` and torch
generators share no stream), so tests that compare the two packages make
their data with numpy.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from kmeans_tpu_torch.device import as_dtype, resolve_device

__all__ = ["make_blobs", "make_rings", "make_moons", "BENCH_CONFIGS",
           "bench_config", "generator_for"]

#: The evaluation shapes (data is synthetic with matching dimensions):
#: BASELINE.json's five configs plus ``codebook``, the extreme-k shape.
BENCH_CONFIGS = {
    "blobs2d": dict(n=500, d=2, k=3, minibatch=False),
    "mnist": dict(n=60_000, d=784, k=10, minibatch=False),
    "glove": dict(n=400_000, d=300, k=1000, minibatch=False),
    "cifar10": dict(n=50_000, d=3072, k=100, minibatch=True),
    "imagenet": dict(n=1_280_000, d=2048, k=1000, minibatch=True),
    "codebook": dict(n=1_280_000, d=2048, k=65536, minibatch=True),
}

#: Rows drawn per step, so the f32 noise of a bf16 dataset never needs a
#: full-size f32 copy on the device.
_CHUNK_ROWS = 65536


def bench_config(name: str) -> dict:
    if name not in BENCH_CONFIGS:
        raise KeyError(f"unknown bench config {name!r}; "
                       f"have {sorted(BENCH_CONFIGS)}")
    return dict(BENCH_CONFIGS[name])


def generator_for(seed: Union[int, torch.Generator],
                  device: torch.device) -> torch.Generator:
    """``seed`` itself when it is a generator, else a generator on
    ``device`` seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def make_blobs(
    generator: Union[int, torch.Generator],
    n: int,
    d: int,
    k: int,
    *,
    cluster_std: float = 1.0,
    center_box: float = 10.0,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gaussian blobs: returns ``(x [n, d] dtype, labels [n] int32,
    centers [k, d] f32)``, all on ``device`` (None is the card).
    ``generator`` is a :class:`torch.Generator` on that device or a seed."""
    dev = resolve_device(device)
    gen = generator_for(generator, dev)
    f32 = torch.float32
    centers = (torch.rand(k, d, generator=gen, device=dev, dtype=f32)
               * (2 * center_box) - center_box)
    labels = torch.randint(0, k, (n,), generator=gen, device=dev,
                           dtype=torch.int64)
    x = torch.empty(n, d, dtype=as_dtype(dtype), device=dev)
    for s in range(0, n, _CHUNK_ROWS):
        e = min(n, s + _CHUNK_ROWS)
        noise = torch.randn(e - s, d, generator=gen, device=dev, dtype=f32)
        x[s:e] = centers[labels[s:e]] + noise * cluster_std
    return x, labels.int(), centers


def make_rings(
    generator: Union[int, torch.Generator],
    n_per: int,
    *,
    radii=(1.0, 6.0),
    noise: float = 0.05,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Concentric 2-D rings, the canonical dataset Euclidean k-means cannot
    cut (use the kernel or spectral families).  Returns ``(x
    (len(radii)·n_per, 2), labels int32)`` on ``device`` (None is the
    card), one label per ring; each ring draws its angles, then its noise."""
    dev = resolve_device(device)
    gen = generator_for(generator, dev)
    f32 = torch.float32
    parts, labels = [], []
    for i, r in enumerate(radii):
        theta = torch.rand(n_per, generator=gen, device=dev,
                           dtype=f32) * (2.0 * math.pi)
        pts = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], 1)
        parts.append(pts + noise * torch.randn(n_per, 2, generator=gen,
                                               device=dev, dtype=f32))
        labels.append(torch.full((n_per,), i, dtype=torch.int32, device=dev))
    return torch.cat(parts).to(as_dtype(dtype)), torch.cat(labels)


def make_moons(
    generator: Union[int, torch.Generator],
    n_per: int,
    *,
    noise: float = 0.05,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two interleaved half-moon crescents (the other canonical non-convex
    shape).  Returns ``(x (2·n_per, 2), labels int32)`` on ``device``
    (None is the card)."""
    dev = resolve_device(device)
    gen = generator_for(generator, dev)
    f32 = torch.float32
    t1 = torch.rand(n_per, generator=gen, device=dev, dtype=f32) * math.pi
    t2 = torch.rand(n_per, generator=gen, device=dev, dtype=f32) * math.pi
    m1 = torch.stack([torch.cos(t1), torch.sin(t1)], 1)
    m2 = torch.stack([1.0 - torch.cos(t2), 0.5 - torch.sin(t2)], 1)
    x = torch.cat([m1, m2])
    x = x + noise * torch.randn(x.shape, generator=gen, device=dev, dtype=f32)
    labels = torch.cat([torch.zeros(n_per, dtype=torch.int32, device=dev),
                        torch.ones(n_per, dtype=torch.int32, device=dev)])
    return x.to(as_dtype(dtype)), labels
