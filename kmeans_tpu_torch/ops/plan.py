"""The Hopper planner: how the sweep kernels run a shape on the card.

Counterpart of ``vmem_breakdown`` / ``max_k_tile`` / ``kernel_plan`` in
``kmeans_tpu/ops/pallas_lloyd.py``, with the card's L2 cache in the role the
TPU's VMEM plays there.  The port's untiled kernels (K1–K4) take any k: they
stream the centroids through shared memory (in 256-wide slices on the Hopper
core -- two 128-wide sub-slices on its f32 route --, 128-wide tiles in
``score_block``), and K2–K4 scatter their changed
rows with f32 atomics into the sums.  Both rest on L2: every row block
streams all of −2·C, and the atomics resolve in L2 while the sums fit
there.  Once −2·C and the f32 sums outgrow it, the plan switches to the
k-tiled pair: K5 (``tiled_argmin_cuda``) scores one centroid slice of
``k_tile`` columns at a time and merges the slices' partial argmins (on the
same core as K1–K4), and K6 (``tiled_fold_cuda``) folds by bucketing the
rows by label, without float atomics.

Two layers, as in the reference:

* :func:`kernel_plan` prices a shape alone (``kind``, d, k, the item sizes)
  against a :class:`Budget`: ``"untiled"`` while −2·C in the compute dtype
  plus the f32 sums fit 3/4 of L2 (the reference plans to 3/4 of VMEM);
  else ``"tiled"`` with the widest 128-multiple slice whose −2·C fits;
  ``"refuse"`` when not even one 128-column slice fits, or a block of the
  scoring core the shape runs (:func:`kernel_smem_bytes`: the Hopper core
  at bf16 with d % 8 == 0 or f32 with d % 4 == 0 on either route,
  ``score_block`` otherwise) does not fit the card's opt-in shared memory.
  On the core's f32 route −2·C is held as its three bf16 pieces
  (:func:`neg2c_bytes`).
* :func:`device_plan` adds the vetoes: fractional weights in a non-f32
  compute dtype, a device that is not a CUDA card, dtypes the kernels do not
  take, shapes out of range.

``padded_d`` has no counterpart: the kernels mask a ragged d, so d is never
padded.  With no card the budget is the H100's (50 MiB of L2, 227 KB of
shared memory a block): metadata callers and the CPU tests plan as on the
card, as the reference falls back to ``_VMEM_FALLBACK``.  That is a planning
constant only; no kernel runs without the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from kmeans_tpu_torch.device import as_dtype
from kmeans_tpu_torch.ops.distance import resolve_cd

__all__ = ["KernelPlan", "Budget", "card_budget", "l2_breakdown",
           "max_k_tile", "kernel_plan", "device_plan", "shape_plan",
           "core_takes", "kernel_smem_bytes", "KINDS", "LANE",
           "L2_FALLBACK_BYTES", "SMEM_FALLBACK_BYTES",
           "SCORE_BLOCK_SMEM_BYTES", "CORE_SMEM_BYTES",
           "CORE_F32_SMEM_BYTES", "CORE_KINDS", "neg2c_bytes"]

#: Kernel kinds, the reference's plus ``accumulate`` (the labeled fold).
KINDS = ("classic", "delta", "hamerly", "yinyang", "accumulate")
#: Column granularity of a centroid slice: the kernels' k-tile.
LANE = 128
#: The H100's L2 and opt-in shared memory a block: the no-card budget.
L2_FALLBACK_BYTES = 50 * 1024 * 1024
SMEM_FALLBACK_BYTES = 232_448
#: Dynamic shared memory of a ``score_block`` block (``csrc/lloyd.cu``): the
#: (128, 132) f32 score tile, which reuses the staging buffers of either
#: compute dtype.
SCORE_BLOCK_SMEM_BYTES = 128 * (128 + 4) * 4
#: Shared memory of the Hopper core (``core_score_kernel``, ``CORE_SMEM``
#: in ``csrc/lloyd.cu``): a ring of 4 stages, each a 128 x 64 bf16 x tile
#: and a 256 x 64 bf16 −2C tile, 1024 bytes of alignment slack, and the
#: ring's 8 mbarriers.
CORE_SMEM_BYTES = 4 * (128 + 256) * 64 * 2 + 1024 + 8 * 8
#: Shared memory of the core's f32 route (``CORE32_SMEM`` in
#: ``csrc/lloyd.cu``): a ring of 3 stages, each the three bf16 pieces of a
#: 128 x 32 x tile and of a 128 x 32 −2C tile; a ring of 4 f32 x tiles
#: (128 x 32) that the producer splits; 1024 bytes of alignment slack, and
#: the two rings' 14 mbarriers.
CORE_F32_SMEM_BYTES = (3 * 6 * 128 * 32 * 2 + 4 * 128 * 32 * 4 + 1024
                       + 14 * 8)
#: The kinds whose kernels take the Hopper core: K1, K2 and K4 untiled
#: (yinyang runs K4), K5 tiled.
CORE_KINDS = ("classic", "delta", "hamerly", "yinyang")

_F32_BF16 = (torch.float32, torch.bfloat16)


#: The weights veto's reason: the reference's exactness policy, the one
#: refusal under which ``backend="auto"`` takes the plain route on the card.
WEIGHTS_VETO = "fractional weights in a non-f32 compute dtype"


class KernelPlan(NamedTuple):
    """A dispatch decision: ``mode`` is ``"untiled"`` (K1–K4), ``"tiled"``
    (K5 + K6 over ``k_tile``-wide centroid slices) or ``"refuse"``;
    ``k_tile`` is set only when tiled; ``why`` says which rule decided."""

    mode: str
    k_tile: Optional[int]
    why: str


class Budget(NamedTuple):
    """What a plan may use: ``l2_bytes`` (3/4 of the card's L2) and the
    opt-in shared memory a block, and where they were read."""

    l2_bytes: int
    smem_per_block: int
    source: str


@functools.cache
def _card_properties(index: int):
    props = torch.cuda.get_device_properties(index)
    return (props.name, int(getattr(props, "L2_cache_size", 0)),
            int(getattr(props, "shared_memory_per_block_optin", 0)))


def card_budget(device=None) -> Budget:
    """The budget of the card (``device``, default the current one), or the
    H100's constants when no card is present."""
    if torch.cuda.is_available():
        dev = torch.device("cuda") if device is None else torch.device(device)
        if dev.type == "cuda":
            index = (torch.cuda.current_device() if dev.index is None
                     else dev.index)
            name, l2, smem = _card_properties(index)
            return Budget(3 * (l2 or L2_FALLBACK_BYTES) // 4,
                          smem or SMEM_FALLBACK_BYTES, name)
    return Budget(3 * L2_FALLBACK_BYTES // 4, SMEM_FALLBACK_BYTES,
                  "no card: the H100's L2 and shared memory")


def core_takes(kind: str, d: int, x_itemsize: int, cd_itemsize: int) -> bool:
    """Whether a sweep of ``kind`` scores with the Hopper core, on either
    route: every scoring kind on bf16 x in bf16 compute with d a multiple
    of 8, or f32 x in f32 compute with d a multiple of 4 -- TMA's 16-byte
    row stride, and K4's 16-byte ``cp.async`` chunks; the wrappers add
    16-byte-aligned bases.  f32 compute scores as the reference's
    ``Precision.HIGHEST`` does on its own chip: each f32 operand split
    exactly into three bf16 pieces and six bf16 products summed in f32
    (x split on chip, −2·C by the wrapper, padded with zero columns to a
    multiple of 8 so that TMA can stride it when d % 8 == 4).  The route
    runs 32-feature stages, so a narrow or ragged d pays for ⌈d/32⌉·32
    features; K2 on it still beat ``score_block`` at every d measured,
    4 to 512 (by 5–19% at d = 4, 2.6× at glove's 300, within 8% of the
    time of 296 and 304; ``chip_smoke.py``'s ``_f32_widths``).  f32 x
    in bf16 compute (TMA cannot cast on load), bf16 x in f32 compute and
    a d that breaks the stride rule run ``score_block``.  The labeled
    fold scores nothing."""
    if kind not in CORE_KINDS or x_itemsize != cd_itemsize:
        return False
    return (x_itemsize == 2 and d % 8 == 0) or (x_itemsize == 4
                                                 and d % 4 == 0)


def kernel_smem_bytes(kind: str, d: int, *, x_itemsize: int = 2,
                      cd_itemsize: int = 2) -> int:
    """Shared memory a block of the scoring core that ``kind`` runs at this
    shape needs, on either route (0 for the labeled fold, which scores
    nothing)."""
    if kind == "accumulate":
        return 0
    if core_takes(kind, d, x_itemsize, cd_itemsize):
        return CORE_F32_SMEM_BYTES if cd_itemsize == 4 else CORE_SMEM_BYTES
    return SCORE_BLOCK_SMEM_BYTES


def neg2c_bytes(kind: str, d: int, k: int, *, x_itemsize: int = 2,
                cd_itemsize: int = 2) -> int:
    """Bytes of the −2·C operand a sweep of ``kind`` reads for k
    centroids: k·d in the compute dtype, or on the core's f32 route its
    three bf16 pieces, k rows of d rounded up to 8 columns (6 bytes an
    element)."""
    if cd_itemsize == 4 and core_takes(kind, d, x_itemsize, cd_itemsize):
        return k * _round_up(d, 8) * 6
    return k * d * cd_itemsize


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; have {KINDS}")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def l2_breakdown(kind: str, d: int, k: int, *, cd_itemsize: int = 2,
                 k_tile: Optional[int] = None,
                 groups: Optional[int] = None,
                 x_itemsize: int = 2) -> dict:
    """Named bytes that a sweep of ``kind`` keeps in L2: untiled, −2·C in
    the compute dtype (its three bf16 pieces on the core's f32 route, which
    ``x_itemsize`` and ``cd_itemsize`` 4 select: :func:`neg2c_bytes`),
    ``||c||²``, the f32 sums and counts (the labeled fold has only the sums
    and counts); with ``k_tile``, the one centroid slice the resident
    blocks share (the labeled fold's slice of sums).  ``yinyang`` adds the
    centroid → group map and the per-group drift vectors (t = ``groups``,
    default ⌈k/10⌉).  x is streamed, not held, so it is not priced."""
    _check_kind(kind)
    cols = k if k_tile is None else min(k_tile, _round_up(k, LANE))
    c_bytes = functools.partial(neg2c_bytes, kind, d, cd_itemsize=cd_itemsize,
                                x_itemsize=x_itemsize)
    if kind == "accumulate":
        terms = {"sums": cols * d * 4, "counts": cols * 4}
    elif k_tile is None:
        terms = {"neg2c": c_bytes(k), "csq": k * 4,
                 "sums": k * d * 4, "counts": k * 4}
    else:
        terms = {"neg2c_slice": c_bytes(cols), "csq_slice": cols * 4}
    if kind == "yinyang":
        t = groups if groups is not None else -(-k // 10)
        terms["group_map"] = k * 4
        terms["group_drift"] = 2 * t * 4
    return terms


def _fits(kind, d, k, budget, *, cd_itemsize, k_tile=None, groups=None,
          x_itemsize=2):
    return sum(l2_breakdown(kind, d, k, cd_itemsize=cd_itemsize,
                            k_tile=k_tile, groups=groups,
                            x_itemsize=x_itemsize).values()
               ) <= budget.l2_bytes


def max_k_tile(kind: str, d: int, k: int, *, cd_itemsize: int = 2,
               groups: Optional[int] = None,
               budget: Optional[Budget] = None,
               x_itemsize: int = 2) -> Optional[int]:
    """The widest multiple of 128 (capped at k rounded up to 128) whose
    slice fits the budget, or None when one 128-column slice does not."""
    budget = budget or card_budget()
    kw = dict(cd_itemsize=cd_itemsize, groups=groups, x_itemsize=x_itemsize)
    if not _fits(kind, d, k, budget, k_tile=LANE, **kw):
        return None
    lo, hi = 1, _round_up(max(k, 1), LANE) // LANE
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _fits(kind, d, k, budget, k_tile=mid * LANE, **kw):
            lo = mid
        else:
            hi = mid - 1
    return lo * LANE


def kernel_plan(kind: str, d: int, k: int, *, x_itemsize: int = 2,
                cd_itemsize: int = 2, groups: Optional[int] = None,
                budget: Optional[Budget] = None) -> KernelPlan:
    """The shape-level plan of one kernel kind (see the module docstring).
    ``budget`` defaults to :func:`card_budget`."""
    _check_kind(kind)
    budget = budget or card_budget()
    if x_itemsize not in (2, 4) or cd_itemsize not in (2, 4):
        return KernelPlan("refuse", None,
                          "the kernels take float32 or bfloat16 x and compute")
    if not 1 <= d < 2 ** 31 or not 1 <= k < 2 ** 31:
        return KernelPlan("refuse", None, f"d={d}, k={k} out of range")
    kw = dict(cd_itemsize=cd_itemsize, groups=groups, x_itemsize=x_itemsize)
    mib = budget.l2_bytes / 2 ** 20
    mib_held = sum(l2_breakdown(kind, d, k, **kw).values()) / 2 ** 20
    held = ("the f32 sums" if kind == "accumulate" else
            "−2C and the f32 sums") + f" ({mib_held:.1f} MiB)"
    if _fits(kind, d, k, budget, **kw):
        plan = KernelPlan("untiled", None,
                          f"{held} fit 3/4 of L2 ({mib:.1f} MiB)")
    else:
        kt = max_k_tile(kind, d, k, budget=budget, **kw)
        if kt is None:
            return KernelPlan("refuse", None,
                              f"one 128-column slice overflows {mib:.1f} MiB")
        plan = KernelPlan(
            "tiled", kt, f"{held} overflow 3/4 of L2 ({mib:.1f} MiB): "
            f"{-(-k // kt)} slices of {kt} columns")
    smem = kernel_smem_bytes(kind, d, x_itemsize=x_itemsize,
                             cd_itemsize=cd_itemsize)
    if smem > budget.smem_per_block:
        core = ("score_block" if smem == SCORE_BLOCK_SMEM_BYTES
                else "the Hopper core")
        return KernelPlan(
            "refuse", None, f"a block of {core} needs {smem} B of shared "
            f"memory; the card offers {budget.smem_per_block}")
    return plan


def _dtypes(x_dtype, compute_dtype):
    x_dtype = as_dtype(x_dtype)
    if x_dtype == torch.float64:
        x_dtype = torch.float32          # float64 input computes in f32
    return x_dtype, resolve_cd(compute_dtype, x_dtype)


def shape_plan(kind: str, x, k: int, *, compute_dtype=None,
               groups: Optional[int] = None, device=None,
               budget: Optional[Budget] = None) -> KernelPlan:
    """:func:`kernel_plan` at the shape and dtypes of ``x`` (which needs
    only ``shape`` and ``dtype``), without the vetoes.  A sweep runs at its
    ``k_tile`` on either route, so the plain versions take the sub-route the
    kernels would; a shape it refuses runs untiled on the plain route (the
    card route has raised on it before)."""
    x_dtype, cd = _dtypes(x.dtype, compute_dtype)
    if x_dtype not in _F32_BF16 or cd not in _F32_BF16:
        return KernelPlan("refuse", None, f"x dtype {x_dtype} / compute "
                          f"dtype {cd}: the kernels take float32 or bfloat16")
    dev = device if device is not None else getattr(x, "device", None)
    return kernel_plan(kind, x.shape[1], k, x_itemsize=x_dtype.itemsize,
                       cd_itemsize=cd.itemsize, groups=groups,
                       budget=budget or card_budget(dev))


def device_plan(kind: str, x, k: int, *, weights=None,
                weights_are_binary: bool = False, compute_dtype=None,
                device=None, groups: Optional[int] = None,
                budget: Optional[Budget] = None) -> KernelPlan:
    """The full dispatch decision for ``kind`` at this input: the vetoes,
    then :func:`shape_plan`.  ``x`` needs only ``shape`` and ``dtype`` (a
    numpy array will do); ``device`` overrides ``x.device``.  The weights
    veto is the reference's exactness policy
    (:func:`kmeans_tpu_torch.ops.lloyd.weights_exact`)."""
    from kmeans_tpu_torch.ops.lloyd import weights_exact

    _, cd = _dtypes(x.dtype, compute_dtype)
    dev = torch.device(device) if device is not None else x.device
    if not weights_exact(cd, weights=weights,
                         weights_are_binary=weights_are_binary):
        return KernelPlan("refuse", None, WEIGHTS_VETO)
    if dev.type != "cuda":
        return KernelPlan("refuse", None,
                          f"not running on a CUDA device ({dev})")
    n, d = x.shape
    if n < 1 or 2 * n >= 2 ** 31 or n * max(d, k) >= 2 ** 62:
        return KernelPlan("refuse", None,
                          f"shape n={n}, d={d}, k={k} out of range")
    return shape_plan(kind, x, k, compute_dtype=compute_dtype, groups=groups,
                      device=dev, budget=budget)
