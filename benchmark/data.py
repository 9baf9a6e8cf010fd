"""The cells' rows: the latent recipe, made on the device from the seed.

Real embedding matrices have a low intrinsic dimension, so the rows follow
a latent recipe (``bench.py``'s ``_make_data``): ``k_gen`` centres drawn in
an ``latent_r``-dimensional space, scaled by :data:`CENTER_SCALE`, each row
a centre plus isotropic noise of ``cluster_std`` there, and every row mapped
to the published width ``d`` by one fixed (latent_r, d) map with unit rows.  Every product and every
byte is still at the full (n, d) shape; only the clustering geometry is
latent_r-dimensional.  The rows are made :data:`TILE` at a time, so no f32
(n, d) intermediate exists, and stored in the configuration's dtype.

A warm-started traffic mix draws its rows from the centres moved by a
seeded drift (``drift`` x ``cluster_std`` a latent coordinate) and hands
the fit the unmoved centres mapped to ``d`` (``c_prev``: yesterday's
model).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Dataset", "make_dataset", "warm_init", "derive_seed", "full_f32"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from ``seed`` and a path of whole numbers (any
    size, negative ones folded into 64 bits)."""
    words = [int(v) % (1 << 64) for v in (seed, *path)]
    state = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


@contextlib.contextmanager
def full_f32():
    """f32 products in full f32 (TF32 off) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


class Dataset(NamedTuple):
    x: torch.Tensor                  # (n, d) in the configuration's dtype
    proj: torch.Tensor               # (latent_r, d) f32, unit rows
    c_prev: Optional[torch.Tensor]   # (k_gen, d) f32 or None


#: The centres' scale a latent coordinate, and the rows made at a time.
CENTER_SCALE = 3.0
TILE = 32768
#: Streams of the data generator (``derive_seed`` paths).
DATA_STREAM = 1
JITTER_STREAM = 2


def make_dataset(config: dict, traffic: dict, seed: int,
                 device) -> Dataset:
    """The rows of one run, from ``seed``: the same seed gives the same
    rows on the same device."""
    recipe = config["data"]
    n, d = int(config["n"]), int(config["d"])
    r = int(recipe["latent_r"])
    k_gen = int(recipe["k_gen"])
    std = float(recipe["cluster_std"])
    dtype = _DTYPES[config["storage_dtype"]]
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, DATA_STREAM))
    f32 = dict(dtype=torch.float32, device=device, generator=gen)
    centres = torch.randn(k_gen, r, **f32) * CENTER_SCALE
    proj = torch.randn(r, d, **f32)
    proj /= proj.norm(dim=1, keepdim=True)
    c_prev = None
    drift = float(traffic.get("drift", 0.0))
    with full_f32():
        if traffic.get("init") == "warm":
            c_prev = centres @ proj
            centres = centres + torch.randn(k_gen, r, **f32) * (drift * std)
        x = torch.empty(n, d, dtype=dtype, device=device)
        for s in range(0, n, TILE):
            e = min(n, s + TILE)
            lab = torch.randint(0, k_gen, (e - s,), device=device,
                                generator=gen)
            z = torch.randn(e - s, r, **f32)
            x[s:e] = ((centres[lab] + std * z) @ proj).to(dtype)
    return Dataset(x, proj, c_prev)


def warm_init(ds: Dataset, config: dict, traffic: dict, seed: int,
              index: int) -> torch.Tensor:
    """Fit ``index``'s starting centroids in a warm-started mix: ``c_prev``
    plus a seeded jitter of ``jitter`` x ``cluster_std`` a latent
    coordinate, mapped to ``d``, so that the window is not one fit
    replayed."""
    recipe = config["data"]
    dev = ds.c_prev.device
    gen = torch.Generator(device=dev).manual_seed(
        derive_seed(seed, JITTER_STREAM, index))
    z = torch.randn(ds.c_prev.shape[0], ds.proj.shape[0],
                    dtype=torch.float32, device=dev, generator=gen)
    scale = float(traffic["jitter"]) * float(recipe["cluster_std"])
    with full_f32():
        return ds.c_prev + (z * scale) @ ds.proj
