"""Device mesh of the sharded engine: one process per device.

Counterpart of ``kmeans_tpu/parallel/mesh.py``.  The reference builds a
``jax.sharding.Mesh`` over the local devices of one controlling process;
the port runs one process per device, joined by ``torch.distributed``
(NCCL between cards, gloo between CPU processes), and a :class:`Mesh` is
one rank's view of that group: its rank, the world size, its device and
the axis names.  Ranks lie on the mesh in row-major order (rank =
``np.ravel_multi_index(coords, shape)``, as the reference's devices
reshape), points shard over the ``data`` axis, centroids over k on the
``model`` axis and both over d on the ``feature`` axis.  Where more than
one axis is above 1, :func:`make_mesh` makes one process group for each
set of those axes (every rank calls ``new_group`` for every group, in one
order), and :meth:`Mesh.sub` is the view of the ranks this one shares
every other coordinate with: a reduction over ``model`` alone, or over
``data`` and ``feature`` together.

Every rank calls the engine with the same global data; each keeps only its
own block on its device, and the per-sweep merges are the collectives of
:class:`Mesh`.

A gloo mesh may also hold CUDA tensors: several ranks sharing one card,
which NCCL refuses.  Gloo takes card tensors for all three collectives the
engine uses (``all_reduce`` and the tensor forms of ``reduce_scatter`` and
``all_gather``; ``chip_smoke.py`` phase 15 checks it), so no collective is
staged by hand.  The one point-to-point operation, :meth:`Mesh.ring_shift`
(the reference's ``ppermute`` to ``(s + 1) % dp``, which the pairwise
families' ring passes take), moves card tensors over NCCL; on gloo it
stages them through pinned host buffers (gloo's send and receive read
and write host memory), and ``stats["ring_stage"]`` counts it.  Nothing
falls back from NCCL to gloo.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from kmeans_tpu_torch.config import MeshConfig
from kmeans_tpu_torch.parallel import distributed as _distributed

__all__ = ["Mesh", "make_mesh", "cpu_mesh", "mesh_from_config",
           "free_port"]

# The tensor forms of the two collectives (renamed ``*_single`` in newer
# torch releases; the older names remain there, deprecated).
_all_gather_tensor = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

#: ``Mesh.all_reduce``'s reductions.
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def free_port() -> int:
    """A free local TCP port for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Mesh:
    """One rank's view of a mesh of processes (one device each).

    ``group`` is the process group of the mesh, ``rank`` / ``size`` this
    process's place in it, ``device`` its device and ``backend`` the
    group's (``"nccl"`` or ``"gloo"``).  ``stats`` counts the calls and
    payload bytes (each call's input) of each collective, and of the ring
    shifts and their host staging, since the last :meth:`reset_stats`;
    ``split`` is the engine's per-sweep recorder while
    :func:`~kmeans_tpu_torch.parallel.engine.sweep_split` is active.
    """

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 group, device: torch.device, backend: str, *,
                 axis_groups=None, root=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.axis_sizes = dict(zip(self.axis_names, self.shape))
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.size = dist.get_world_size(group) if group is not None else 1
        self.device = device
        self.backend = backend
        # The whole mesh of a view (None: this one; no reference to itself,
        # so a mesh and its groups go when the last reference does).
        self._of = root
        self._axis_groups = axis_groups or {}
        if root is None:
            self._split = None
            self.coords = dict(zip(self.axis_names, (int(i) for i in (
                np.unravel_index(self.rank, self.shape)))))
            self.reset_stats()

    @property
    def _root(self) -> "Mesh":
        return self if self._of is None else self._of

    @property
    def split(self):
        return self._root._split

    @split.setter
    def split(self, value):
        self._root._split = value

    @property
    def stats(self):
        return self._root._stats

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` of the whole mesh."""
        return self._root.coords[axis]

    def sub(self, axes) -> "Mesh":
        """The view of the ranks that share this rank's coordinate on every
        axis outside ``axes`` (names; None entries are skipped): its
        collectives run over ``axes`` alone, in row-major order of their
        coordinates.  Axes of size 1 add nothing; a view of size 1 has no
        group and runs no collective at all (the mesh itself, even of one
        rank, runs every collective in its group)."""
        root = self._root
        live = frozenset(a for a in axes if a is not None
                         and root.axis_sizes[a] > 1)
        if live == frozenset(a for a, s in root.axis_sizes.items() if s > 1):
            return root
        shape = tuple(root.axis_sizes[a] for a in root.axis_names
                      if a in live)
        names = tuple(a for a in root.axis_names if a in live)
        group = root._axis_groups[live] if live else None
        return Mesh(shape or (1,), names or ("local",), group, root.device,
                    root.backend, root=root)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"rank={self.rank}, device={self.device}, "
                f"backend={self.backend!r})")

    def reset_stats(self) -> None:
        """Counters of every view of this mesh are the mesh's own."""
        self._root._stats = {op: [0, 0] for op in (
            "all_reduce", "reduce_scatter", "all_gather", "ring_shift",
            "ring_stage")}

    def _count(self, op: str, t: torch.Tensor) -> None:
        s = self.stats[op]
        s[0] += 1
        s[1] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the mesh (``op`` "sum", "min" or "max"), in
        place; returns ``t``."""
        if self.group is None:
            return t
        self._count("all_reduce", t)
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_reduce_packed(self, *ts: torch.Tensor):
        """Sum f32 tensors of any shapes over the mesh in ONE all-reduce of
        their packed concatenation; returns the sums, each in its own
        shape (views of the packed buffer)."""
        packed = self.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
        out, lo = [], 0
        for t in ts:
            out.append(packed[lo:lo + t.numel()].view(t.shape))
            lo += t.numel()
        return tuple(out)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` (``size · m`` rows) over the mesh and return this
        rank's block of ``m`` rows (the tiled ``psum_scatter``)."""
        if self.group is None:
            return t
        self._count("reduce_scatter", t)
        t = t.contiguous()
        m = t.shape[0] // self.size
        out = torch.empty((m,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _reduce_scatter_tensor(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's ``t`` along dim 0, in rank order (the
        tiled ``all_gather``)."""
        if self.group is None:
            return t
        self._count("all_gather", t)
        t = t.contiguous()
        shape = (self.size * t.shape[0],) + tuple(t.shape[1:])
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        _all_gather_tensor(out, t, group=self.group)
        return out

    def ring_shift(self, *ts: torch.Tensor):
        """Send each of ``ts`` to the next rank of the ring (``(rank + 1) %
        size``) and return the previous rank's, in one batch of sends and
        receives.  At size 1 (or in a view of one rank) the identity:
        nothing is sent or counted.  On gloo, card tensors go through
        pinned host buffers (counted under ``"ring_stage"``)."""
        if self.group is None or self.size == 1:
            return ts
        stage = self.backend == "gloo" and any(t.is_cuda for t in ts)
        nxt = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        prv = dist.get_global_rank(self.group, (self.rank - 1) % self.size)
        send = [t.contiguous() for t in ts]
        if stage:
            send = [torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t) for t in send]
        recv = [torch.empty_like(t) for t in send]
        ops = []
        for tag, (s, r) in enumerate(zip(send, recv)):
            ops.append(dist.P2POp(dist.isend, s, nxt, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, r, prv, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        nbytes = sum(t.numel() * t.element_size() for t in send)
        for op in ("ring_shift", "ring_stage") if stage else ("ring_shift",):
            self.stats[op][0] += 1
            self.stats[op][1] += nbytes
        if stage:
            recv = [r.to(t.device) for r, t in zip(recv, ts)]
        return tuple(recv)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def _axis_groups(shape, axis_names, backend):
    """One process group per set of mesh axes above 1 (short of all of
    them): ``{frozenset(axis names): the group holding this rank}``.
    Every rank makes every group, in one order, as ``new_group`` needs."""
    live = [i for i, s in enumerate(shape) if s > 1]
    groups = {}
    if len(live) < 2:
        return groups
    me = dist.get_rank()
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    timeout = datetime.timedelta(seconds=_distributed.INIT_TIMEOUT_S)
    for r in range(1, len(live)):
        for subset in itertools.combinations(live, r):
            others = [i for i in range(len(shape)) if i not in subset]
            size = int(np.prod([shape[i] for i in subset]))
            rows = np.transpose(ranks, others + list(subset)).reshape(
                -1, size)
            for row in rows:
                g = dist.new_group(row.tolist(), backend=backend,
                                   timeout=timeout)
                if me in row:
                    groups[frozenset(axis_names[i] for i in subset)] = g
    return groups


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("data", "model"),
    *,
    devices: Optional[Sequence] = None,
    platform: Optional[str] = None,
    backend: Optional[str] = None,
) -> Mesh:
    """This rank's mesh over ``devices`` (default: every card of the host;
    ``platform="cpu"``: one CPU device per rank).

    Joins the process group first (:func:`~kmeans_tpu_torch.parallel.
    distributed.ensure_initialized`, from ``WORLD_SIZE`` / ``RANK`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``); a process outside any group makes
    a group of one.  ``devices`` lists the host's devices in local-rank
    order; this rank takes ``devices[LOCAL_RANK]`` (``RANK`` without it).
    With no ``shape``, every rank lands on the first axis (pure DP).
    ``backend`` defaults to NCCL on the cards and gloo on the CPU; a gloo
    backend on the cards is allowed (several ranks may then share one
    card), NCCL on the CPU is refused.
    """
    if devices is not None:
        devices = [torch.device(dv) for dv in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        kind = devices[0].type
    else:
        kind = "cpu" if platform == "cpu" else "cuda"
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available for the mesh; pass "
                "platform='cpu' (cpu_mesh) to run the ranks as gloo CPU "
                "processes")
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; the mesh runs "
                         "'nccl' (cards) or 'gloo'")
    if backend == "nccl" and kind != "cuda":
        raise ValueError("NCCL runs between cards; a CPU mesh is gloo")
    _distributed.ensure_initialized(backend=backend)
    if not dist.is_initialized():
        # A lone process: a group of one over an in-process store (a TCP
        # rendezvous on a port picked beforehand can lose that port to
        # another process before it binds it).
        dist.init_process_group(
            backend=backend, store=dist.HashStore(), world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=_distributed.INIT_TIMEOUT_S))
    world = dist.get_world_size()
    if devices is None:
        devices = ([torch.device("cpu")] * world if kind == "cpu" else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    n_needed = int(np.prod(shape))
    if n_needed > len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n_needed} devices, have "
            f"{len(devices)}")
    if n_needed != world:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n_needed} processes, the "
            f"process group has {world}")
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local not in (None, "") else dist.get_rank()
    device = devices[idx]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = dist.group.WORLD
    if dist.get_backend() != backend:
        group = dist.new_group(backend=backend, timeout=datetime.timedelta(
            seconds=_distributed.INIT_TIMEOUT_S))
    return Mesh(tuple(shape), tuple(axis_names), group, device, backend,
                axis_groups=_axis_groups(tuple(shape), tuple(axis_names),
                                         backend))


def cpu_mesh(
    shape: Tuple[int, ...],
    axis_names: Tuple[str, ...] = ("data", "model"),
) -> Mesh:
    """Mesh of gloo CPU processes (tests and dry runs)."""
    return make_mesh(shape, axis_names, platform="cpu", backend="gloo")


def mesh_from_config(cfg: MeshConfig) -> Mesh:
    return make_mesh(cfg.shape, cfg.axis_names, platform=cfg.platform)
