"""Command line of the port: ``train`` (alias ``fit``), ``sweep``,
``continuous`` and ``serve``.

    python -m kmeans_tpu_torch.cli train --config imagenet [--model lloyd]
        [--progress] [--checkpoint DIR [--checkpoint-every N]] [--resume DIR]
        [--telemetry OUT.jsonl] [--trace OUT.json] [--out board.json]

fits on the card (``--device cpu`` runs the kernels' plain versions on the
CPU) and prints one JSON result line with the reference's keys.  The
families are the reference's ``lloyd`` (the fused :func:`fit_lloyd`, or
the step-paced :class:`~kmeans_tpu_torch.models.runner.LloydRunner`
under ``--progress/--checkpoint/--resume/--telemetry/--trace/--xla-trace/
--profile``), ``accelerated``, in-memory ``minibatch``, ``trimmed``
(``--trim-fraction``; its outliers export as unassigned cards),
``spherical``, ``bisecting``, ``xmeans`` / ``gmeans`` (``--k`` is
k_max; the result line reports the discovered k), ``fuzzy``, ``gmm``
(``--covariance-type``), ``balanced``, ``kmedoids``, ``kernel`` and
``spectral``, and
``--stream``: the out-of-core minibatch fit
(:func:`~kmeans_tpu_torch.models.streaming.fit_minibatch_stream`), or
with ``--model gmm`` online EM (:func:`~kmeans_tpu_torch.models.
gmm_stream.fit_gmm_stream`), over
``--input`` memory-mapped on the host, with ``--steps``, ``--batch-size``,
``--checkpoint`` / ``--resume`` in one directory, ``--telemetry`` and
``--trace``.  ``--coreset M`` fits lloyd, accelerated, spherical,
bisecting, fuzzy, gmm, kernel, kmedoids, trimmed or balanced on an
M-point lightweight coreset of the data, weighted.  ``--pca N
[--whiten]`` projects the in-memory data onto its top N principal
components on the device first
(:mod:`kmeans_tpu_torch.data.preprocess`).  A SIGTERM or SIGINT
during a runner or streamed fit cuts a checkpoint and exits 3 with a
"resume with: ..." line.  ``--xla-trace DIR`` writes a
:mod:`torch.profiler` Chrome trace into DIR (the reference writes a
``jax.profiler`` trace there).
Generated data (``--config`` or ``--n/--d/--k``) is the port's
``make_blobs`` on the chosen device from ``--seed``, so a resumed process
regenerates the same rows.  ``--merge-k K`` exports the fit's labels
merged to K groups along the centroid dendrogram (:func:`~kmeans_tpu_torch.
models.hierarchy.merge_to_k`) and adds ``merged_k`` to the result line
(refused for the center-free kernel and spectral fits).

``--mesh N`` (N > 1) fits every family on N ranks, one process per
device (``spherical`` on the sharded engine's sphere update; ``bisecting``,
``xmeans`` and ``gmeans`` with every inner fit and assign on it; fuzzy,
gmm and balanced on their DP bodies; kmedoids and kernel as ring passes;
spectral's embedding and its k-means sharded)
(:mod:`kmeans_tpu_torch.parallel`), and ``--stream --mesh N`` runs the
streamed fit's step sharded: the command starts N copies of itself, rank i
on ``cuda:i`` (NCCL) or, with ``--device cpu``, N gloo CPU processes,
joined over a free local port; rank 0 prints the result line and writes
``--out``.  The data stays on the host (``--input`` memory-mapped, shared
through the page cache; generated data moved off the card once made) and
each rank places only its own rows.  Under an existing
``torch.distributed`` environment (``WORLD_SIZE`` set, as ``torchrun``
sets it) the process joins that group as its rank instead.  ``--comm``
picks the sharded sweep's merge (lloyd, spherical, bisecting, xmeans and
gmeans), and the runner flags step the dense
reduction on the mesh.  ``--ckpt-dir D [--ckpt-every N]`` runs ``--model
lloyd --mesh N`` elastic: rank 0 saves the global centroids every N sweeps
and on SIGTERM / SIGINT (exit 3 with a resume line), and ``--resume D``
continues them, on any mesh size and ``--comm``.

    python -m kmeans_tpu_torch.cli continuous [--k 4] [--batches 60]
        [--model-dir DIR [--resume]] [--input X.npy] [--progress]

runs the drift-aware continuous pipeline
(:class:`~kmeans_tpu_torch.continuous.pipeline.ContinuousPipeline`) on the
card over the synthetic drifting stream (or ``--input`` in cycling chunks),
publishing each refit to the model registry in ``--model-dir``, with the
reference's JSON lines on stdout (``resumed``, ``generation``, ``done``)
and ``batch`` lines on stderr under ``--progress``.

    python -m kmeans_tpu_torch.cli sweep [--input X.npy] [--k-min 2]
        [--k-max 8] [--model lloyd] [--criterion silhouette|gap|elbow]

fits every k of the range on the card, prints one scored JSON line per k
(:func:`~kmeans_tpu_torch.models.selection.sweep_k`, or the gap statistic;
``--model gmm`` rows carry ``bic`` / ``aic`` for ``--criterion bic|aic``)
and then ``{"suggested_k": K}``, as the reference's ``sweep`` does.

    python -m kmeans_tpu_torch.cli serve [--model-dir DIR] [--port 8787]
        [--persist-dir DIR] [--workers N [--fleet-obs-port PORT]]

serves the board (``/``, ``/api/state``, ``/api/mutate``, ``/api/events``
and the rest: rooms kept in ``--persist-dir``, ``.kmeans_rooms`` by
default, ``''`` for none; the ``autoAssign`` and ``train`` ops fit on the
card) and ``POST /api/assign`` from the newest verified generation in the
model directory (a
:class:`~kmeans_tpu_torch.continuous.registry.ModelRegistry` directory of
either package), scored on the card; ``--device cpu`` runs the kernels'
plain versions on the CPU.  ``--workers N`` above 1 runs the fleet
(:mod:`kmeans_tpu_torch.serve.fleet`): N worker processes on the one port,
each with its own engine on ``--device``, a supervisor that respawns them,
pushes new generations to them, drains them on SIGTERM and replaces them
one by one on SIGHUP, and with ``--fleet-obs-port`` the fleet's aggregated
``/metrics`` and merged ``/api/trace``.  The flags are the reference's
(``kmeans_tpu/cli.py``) plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_npy(path):
    """``np.load`` with the CLI's one-line-error contract: a missing file
    or a corrupt or short ``.npy`` prints one line and returns None."""
    import numpy as np

    try:
        return np.load(path)
    except (OSError, ValueError, EOFError) as e:
        print(f"error: cannot load {path!r}: {e}", file=sys.stderr)
        return None


def _cmd_train(args) -> int:
    import os

    import numpy as np

    import kmeans_tpu_torch.models as models
    from kmeans_tpu_torch import obs
    from kmeans_tpu_torch.config import KMeansConfig
    from kmeans_tpu_torch.data.synthetic import bench_config, make_blobs
    from kmeans_tpu_torch.device import as_tensor, resolve_device
    from kmeans_tpu_torch.session import dataset_to_document, export_json

    if args.config:
        cfg = bench_config(args.config)
        n, d, k = cfg["n"], cfg["d"], cfg["k"]
        cfg_minibatch = cfg["minibatch"]
    else:
        n, d, k = args.n, args.d, args.k
        cfg_minibatch = False
    seed_v = args.seed if args.seed is not None else 0
    # Precedence: explicit --model > explicit --minibatch/--no-minibatch >
    # the named config's minibatch default.  Contradictory explicit flags
    # are an error, not a silent override.
    if args.model is not None and args.minibatch is not None and (
        (args.minibatch and args.model != "minibatch")
        or (not args.minibatch and args.model == "minibatch")
    ):
        print(
            f"error: --model {args.model} contradicts "
            f"--{'minibatch' if args.minibatch else 'no-minibatch'}",
            file=sys.stderr,
        )
        return 2
    if args.stream and args.minibatch is False and args.model is None:
        # --stream defaults to the minibatch path, which --no-minibatch
        # contradicts (an explicit --model gmm stream is the reference's).
        print("error: --stream defaults to the out-of-core minibatch "
              "path; --no-minibatch contradicts it (pass --model gmm for "
              "the streamed mixture)", file=sys.stderr)
        return 2
    runner_flagged = bool(args.progress or args.checkpoint or args.resume
                          or args.profile or args.telemetry or args.trace
                          or args.xla_trace)
    if args.model is not None:
        model = args.model
    elif args.stream:
        model = "minibatch"  # --stream defaults to out-of-core minibatch
    else:
        use_mb = args.minibatch if args.minibatch is not None else cfg_minibatch
        model = "minibatch" if use_mb else "lloyd"
    if args.accel and args.model is None and model == "lloyd" \
            and not runner_flagged:
        # --accel names the accelerated family; without an explicit
        # --model (and without the runner flags, which keep the lloyd
        # runner and accelerate its steps) it selects the fused loop.
        model = "accelerated"
    minibatch = model == "minibatch"
    stream_ok = ("minibatch", "gmm")
    if args.stream and model not in stream_ok:
        print("error: --stream is the out-of-core path; it supports "
              f"--model {'/'.join(stream_ok)}, not {model}",
              file=sys.stderr)
        return 2

    if args.stream and not args.input:
        print("error: --stream requires --input (a .npy to memory-map)",
              file=sys.stderr)
        return 2
    mesh_n = args.mesh if args.mesh and args.mesh > 1 else 0
    if args.input:
        if args.stream or mesh_n:
            # On a mesh too the rows stay mapped on the host, where every
            # rank shares them through the page cache.
            from kmeans_tpu_torch.data.stream import load_mmap

            try:
                x = load_mmap(args.input)
            except (OSError, ValueError, EOFError) as e:
                # A missing path, a corrupt or truncated .npy, or a non-2-D
                # array is one line, not a traceback.
                print(f"error: cannot load {args.input!r}: {e}",
                      file=sys.stderr)
                return 2
        else:
            x = _load_npy(args.input)
            if x is None:
                return 2
        if x.ndim != 2:
            print(f"error: {args.input} must be a 2-D array", file=sys.stderr)
            return 2
        n, d = x.shape

    if args.merge_k is not None:
        # The mistakes knowable before the fit fail before it.
        if model in ("kernel", "spectral"):
            print(f"error: --merge-k needs a center-based fit; "
                  f"{model} has no input-space centers", file=sys.stderr)
            return 2
        if args.merge_k < 1:
            print("error: --merge-k must be >= 1", file=sys.stderr)
            return 2
        if model not in ("xmeans", "gmeans") and args.merge_k >= k:
            print(f"error: --merge-k must be in [1, {k - 1}] for --k {k}",
                  file=sys.stderr)
            return 2
    if args.whiten and args.pca is None:
        print("error: --whiten requires --pca", file=sys.stderr)
        return 2
    if args.pca is not None:
        if args.stream:
            print("error: --pca projects in-memory data; for out-of-core "
                  "inputs fit with kmeans_tpu_torch.data.pca_fit_stream "
                  "and write the projection to disk first", file=sys.stderr)
            return 2
        if not 1 <= args.pca < d:
            print(f"error: --pca must be in [1, {d - 1}] for d={d}",
                  file=sys.stderr)
            return 2

    # --ckpt-dir turns on the sharded engine's elastic path: sweep-granular
    # mesh-agnostic checkpoints cut by fit_lloyd_sharded itself (distinct
    # from --checkpoint, which paces the step-wise runner and the streamed
    # fit).  With it, --resume resumes the engine from that directory,
    # possibly on another --mesh or --comm than the run that saved it.
    engine_ckpt = bool(args.ckpt_dir)
    if engine_ckpt:
        if args.stream or model != "lloyd" or not mesh_n:
            why = ("--stream" if args.stream
                   else f"--model {model}" if model != "lloyd"
                   else f"--mesh {args.mesh or 1}")
            print("error: --ckpt-dir is the sharded engine's elastic "
                  "checkpoint; it needs --model lloyd --mesh > 1 (no "
                  f"effect with {why}) — the step-paced and streamed "
                  "paths checkpoint via --checkpoint", file=sys.stderr)
            return 2
        if bool(args.progress or args.checkpoint or args.profile
                or args.telemetry or args.trace or args.xla_trace):
            print("error: --ckpt-dir rides the fused sharded fit; drop "
                  "the step-paced flags (--progress/--checkpoint/"
                  "--profile/--telemetry/--trace/--xla-trace) or use "
                  "--checkpoint with the runner instead", file=sys.stderr)
            return 2
        if args.resume and os.path.realpath(args.resume) != \
                os.path.realpath(args.ckpt_dir):
            print("error: an elastic --resume continues from (and keeps "
                  "saving into) one directory; --resume must match "
                  "--ckpt-dir", file=sys.stderr)
            return 2
        if args.resume:
            # A mistyped --resume dir must not silently train from scratch
            # (and overwrite it) with exit 0; checked before any rank
            # starts.
            from kmeans_tpu_torch.utils.checkpoint import latest_step

            if latest_step(args.ckpt_dir) is None:
                print(f"error: no checkpoint found at {args.ckpt_dir!r} "
                      "to resume from", file=sys.stderr)
                return 2
        # --resume belongs to the elastic engine, not the runner.
        runner_flagged = bool(args.progress or args.checkpoint
                              or args.profile or args.telemetry
                              or args.trace or args.xla_trace)
    if args.ckpt_every is not None:
        if not engine_ckpt:
            print("error: --ckpt-every paces the elastic engine "
                  "checkpoint; it needs --ckpt-dir", file=sys.stderr)
            return 2
        if args.ckpt_every < 1:
            print("error: --ckpt-every must be positive", file=sys.stderr)
            return 2

    # --accel / --schedule configure the accelerated-fit engine: --accel
    # anderson|beta picks the fused accelerated loop's extrapolation (or,
    # with runner flags, step-paced Anderson inside LloydRunner);
    # --schedule nested prepends the doubling subsample ladder (also for
    # the in-memory minibatch path).  Combinations that would be silently
    # ignored are rejected.
    if args.anderson_m is not None and args.accel != "anderson":
        print("error: --anderson-m tunes the Anderson history depth; it "
              "requires --accel anderson", file=sys.stderr)
        return 2
    if args.accel:
        if args.stream or model not in ("accelerated", "lloyd"):
            print(f"error: --accel runs the accelerated Lloyd family; it "
                  f"has no effect with --model {model}"
                  f"{' --stream' if args.stream else ''} (use --model "
                  "accelerated, or lloyd with the runner flags)",
                  file=sys.stderr)
            return 2
        if model == "lloyd" and not runner_flagged:
            print("error: --accel with --model lloyd needs the step-paced "
                  "runner (--progress/--checkpoint/--telemetry/…); the "
                  "fused loop is --model accelerated", file=sys.stderr)
            return 2
        if model == "lloyd" and args.accel != "anderson":
            print("error: the runner's step-paced acceleration is "
                  "anderson; --accel beta runs only the fused --model "
                  "accelerated loop", file=sys.stderr)
            return 2
        if model == "lloyd" and args.mesh and args.mesh > 1:
            print("error: --accel with runner flags steps single-device; "
                  "the sharded loop is --model accelerated --mesh N",
                  file=sys.stderr)
            return 2
    if args.schedule:
        if args.stream or model not in ("accelerated", "minibatch"):
            print(f"error: --schedule configures the in-memory "
                  f"accelerated/minibatch fits; it has no effect with "
                  f"--model {model}{' --stream' if args.stream else ''}",
                  file=sys.stderr)
            return 2
        if args.schedule == "nested" and args.mesh and args.mesh > 1:
            print("error: --schedule nested runs the single-device "
                  "subsample ladder; drop --mesh or use --schedule full",
                  file=sys.stderr)
            return 2
        if args.schedule == "nested" and model == "minibatch" and (
                args.steps is not None or args.batch_size is not None):
            print("error: --steps/--batch-size drive the Sculley "
                  "streaming loop; --schedule nested is ladder-paced "
                  "(promotes on the sampling noise floor, finishes "
                  "full-batch to --tol)", file=sys.stderr)
            return 2

    # --max-iter governs the Lloyd-family loop; the minibatch and stream
    # paths are step-based (a nested-schedule minibatch fit is ladder-paced:
    # it honours --max-iter per rung and --tol at the full-batch finish).
    step_based = (minibatch and args.schedule != "nested") \
        or (args.stream and model == "gmm")
    if step_based and args.max_iter is not None:
        print("error: --max-iter has no effect with the step-based "
              "minibatch/stream paths; use --steps/--batch-size",
              file=sys.stderr)
        return 2
    if not step_based and (args.steps is not None
                           or args.batch_size is not None):
        print(f"error: --steps/--batch-size are minibatch/stream flags; "
              f"--model {model} runs to --max-iter/--tol", file=sys.stderr)
        return 2
    if args.covariance_type and model != "gmm":
        print(f"error: --covariance-type is a GMM flag; --model {model} "
              "ignores it", file=sys.stderr)
        return 2
    # One copy of the GMM fit-kwarg plumbing for the mesh, stream and
    # in-memory dispatches.
    gmm_kw = ({"covariance_type": args.covariance_type}
              if model == "gmm" and args.covariance_type else {})

    # --update configures the Lloyd-family centroid reduction; paths that
    # never read it must reject it rather than mislead.
    if args.update:
        if model not in ("lloyd", "accelerated", "spherical", "trimmed") \
                or args.stream:
            print(f"error: --update configures the Lloyd-family reduction; "
                  f"it has no effect with --model {model}"
                  f"{' --stream' if args.stream else ''}", file=sys.stderr)
            return 2
        if args.update in ("delta", "hamerly", "yinyang") \
                and model != "lloyd":
            print(f"error: --update {args.update} (the incremental sweep) "
                  "runs only in the lloyd family; accelerated/spherical/"
                  "trimmed use the dense reduction (or --update auto to "
                  "let the policy decide)", file=sys.stderr)
            return 2
        if args.update in ("delta", "hamerly", "yinyang") \
                and runner_flagged and args.mesh and args.mesh > 1:
            print(f"error: --update {args.update} with runner flags "
                  "(--progress/--checkpoint/--resume/--profile/"
                  "--telemetry/--trace/--xla-trace) runs single-device "
                  "only; the mesh runner steps the dense reduction — drop "
                  "--mesh or the runner flags, or use --update auto",
                  file=sys.stderr)
            return 2
        if args.update in ("hamerly", "yinyang") and args.accel:
            print(f"error: --update {args.update} carries refresh-cadence "
                  "score bounds that do not compose with --accel's "
                  "between-sweep extrapolation; drop --accel or use "
                  "--update auto/delta", file=sys.stderr)
            return 2

    # --comm configures the sharded engine's sweep-merge collective; only
    # paths that reach fit_lloyd_sharded read it.
    if args.comm:
        comm_models = model in ("lloyd", "spherical", "xmeans", "gmeans",
                                "bisecting", "spectral")
        if args.stream or not comm_models or not (args.mesh
                                                  and args.mesh > 1):
            why = ("--stream" if args.stream
                   else f"--model {model}" if not comm_models
                   else f"--mesh {args.mesh or 1}")
            print("error: --comm configures the sharded sweep-merge "
                  "collective; it needs --mesh > 1 and a lloyd-family "
                  f"model (no effect with {why})", file=sys.stderr)
            return 2
        if runner_flagged:
            print("error: --comm rides the fused sharded fit; the "
                  "step-paced runner (--progress/--checkpoint/--resume/"
                  "--profile/--telemetry/--trace/--xla-trace) steps the "
                  "allreduce merge — drop those flags or --comm",
                  file=sys.stderr)
            return 2

    if args.profile and args.xla_trace and args.profile != args.xla_trace:
        # --profile is the legacy spelling of --xla-trace; two different
        # directories would silently drop one.
        print("error: --profile is the legacy spelling of --xla-trace; "
              "passing both with different directories is ambiguous — "
              "drop one", file=sys.stderr)
        return 2
    if args.steps is not None and args.steps < 1:
        print("error: --steps must be positive", file=sys.stderr)
        return 2
    if args.batch_size is not None and args.batch_size < 1:
        print("error: --batch-size must be positive", file=sys.stderr)
        return 2

    cfg_kw = {}
    if args.steps is not None:
        cfg_kw["steps"] = args.steps
    if args.batch_size is not None:
        cfg_kw["batch_size"] = args.batch_size
    if args.update:
        cfg_kw["update"] = args.update
    if args.comm:
        cfg_kw["comm"] = args.comm
    if args.yinyang_groups is not None:
        if args.yinyang_groups < 1:
            print("error: --yinyang-groups must be >= 1", file=sys.stderr)
            return 2
        if args.update not in (None, "auto", "yinyang"):
            print(f"error: --yinyang-groups configures the yinyang group "
                  f"bounds; it has no effect with --update {args.update}",
                  file=sys.stderr)
            return 2
        cfg_kw["yinyang_groups"] = args.yinyang_groups
    if args.accel:
        cfg_kw["accel"] = args.accel
    if args.schedule:
        cfg_kw["schedule"] = args.schedule
    if args.anderson_m is not None:
        cfg_kw["anderson_m"] = args.anderson_m
    kcfg = KMeansConfig(
        k=k, init=args.init,
        max_iter=args.max_iter if args.max_iter is not None else 100,
        tol=args.tol, seed=seed_v, compute_dtype=args.dtype, **cfg_kw,
    )

    # --checkpoint/--resume ride the step-paced Lloyd runner or the streamed
    # fit (both checkpoint natively); --progress/--profile are runner-only.
    # --telemetry and --trace/--xla-trace need a step-paced loop (runner or
    # streamed): the one-shot fused fits have no iteration boundary to emit
    # events or spans at.
    stream_ckpt = args.stream and (args.checkpoint or args.resume)
    want_runner = not args.stream and runner_flagged
    if args.stream and (args.progress or args.profile):
        print("error: --progress/--profile require the full-batch Lloyd "
              "runner; the streamed paths support --checkpoint/--resume/"
              "--telemetry/--trace/--xla-trace", file=sys.stderr)
        return 2
    if want_runner and model != "lloyd":
        print(
            "error: --progress/--checkpoint/--resume/--profile/--telemetry/"
            "--trace/--xla-trace "
            "require a step-paced loop (they would be silently ignored "
            f"with the one-shot --model {model}); use --model lloyd, "
            "--stream, or drop those flags",
            file=sys.stderr,
        )
        return 2
    if args.stream and args.resume and args.checkpoint \
            and os.path.realpath(args.resume) != \
            os.path.realpath(args.checkpoint):
        # The streamed fit uses one directory for both resume and saves.
        print("error: a streamed --resume continues from (and keeps "
              "saving into) one directory; --checkpoint must match "
              "--resume or be dropped", file=sys.stderr)
        return 2
    if args.trim_fraction is not None:
        if model != "trimmed":
            print("error: --trim-fraction requires --model trimmed",
                  file=sys.stderr)
            return 2
        if not 0.0 <= args.trim_fraction < 1.0:
            print("error: --trim-fraction must be in [0, 1)", file=sys.stderr)
            return 2
    trim_fraction = (args.trim_fraction if args.trim_fraction is not None
                     else 0.05)

    mesh_ok = ("lloyd", "accelerated", "minibatch", "spherical", "fuzzy",
               "gmm", "kernel", "kmedoids", "trimmed", "balanced",
               "xmeans", "gmeans", "spectral", "bisecting")
    if mesh_n and model not in mesh_ok:
        print(f"error: --mesh supports --model {'/'.join(mesh_ok)}, not "
              f"{model}", file=sys.stderr)
        return 2

    coreset_ok = ("lloyd", "accelerated", "spherical", "bisecting", "fuzzy",
                  "gmm", "kernel", "kmedoids", "trimmed", "balanced")
    fit_weights = None
    if args.coreset is not None:
        if args.coreset < 1:
            print("error: --coreset must be positive", file=sys.stderr)
            return 2
        if model not in coreset_ok or args.stream or mesh_n \
                or want_runner:
            print(
                "error: --coreset runs a weighted single-device fit; it "
                f"supports --model {'/'.join(coreset_ok)} without "
                "--stream/--mesh/runner flags",
                file=sys.stderr,
            )
            return 2

    # Past every flag validation: a usage error reports at once and leaves
    # nothing behind (the --trace probe creates the file if absent, so it
    # runs only now), and no usage error needs a card.
    if args.trace:
        try:
            obs.probe_writable(args.trace)
        except OSError as e:
            print(f"error: cannot write trace to {args.trace!r}: {e}",
                  file=sys.stderr)
            return 2
    mesh = None
    if mesh_n and not os.environ.get("WORLD_SIZE"):
        return _launch_mesh(args, mesh_n)
    try:
        if mesh_n:
            mesh = _join_mesh(args, mesh_n)
            dev = mesh.device
        else:
            dev = resolve_device(args.device)
    except RuntimeError:
        print(f"error: no CUDA device is available for --device "
              f"{args.device}; pass --device cpu to run the kernels' plain "
              "versions on the CPU", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # On a mesh every rank fits; rank 0 alone reports and writes files.
    main_rank = mesh is None or mesh.rank == 0
    if not main_rank:
        args.out = args.telemetry = args.trace = None
        args.xla_trace = args.profile = None
        args.progress = False
    obs.record_build_info(dev.type)     # kmeans_tpu_build_info{version,backend}

    if args.stream or (args.input and mesh is not None):
        pass                # the host memmap stays where it is
    elif args.input:
        x = as_tensor(x, dev)
    else:
        x, _, _ = make_blobs(seed_v, n, d, k, cluster_std=args.cluster_std,
                             device=dev)
        if mesh is not None:
            # Each rank places only its own rows: the generated data leaves
            # the card once made.
            x = x.cpu()
    if args.pca is not None:
        from kmeans_tpu_torch.data.preprocess import pca_fit, pca_transform

        # On the device, in f32; on a mesh every rank projects the same
        # rows and places its own block of the projection.
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = np.array(x)       # a read-only memmap
        pst = pca_fit(x, args.pca, whiten=args.whiten, device=dev)
        x = pca_transform(pst, x)
        if mesh is not None:
            x = x.cpu()
        d = args.pca

    t0 = time.perf_counter()
    if args.coreset is not None:
        import torch

        from kmeans_tpu_torch.data.coreset import lightweight_coreset

        x, fit_weights = lightweight_coreset(
            torch.Generator(device=dev).manual_seed(seed_v + 1), x,
            args.coreset, chunk_size=kcfg.chunk_size,
            compute_dtype=kcfg.compute_dtype, device=dev,
        )
    if want_runner:
        import contextlib

        from kmeans_tpu_torch.utils import capture
        from kmeans_tpu_torch.utils.checkpoint import CorruptCheckpointError

        runner = models.LloydRunner(
            x, k, config=kcfg, device=dev, mesh=mesh,
            accel="anderson" if args.accel == "anderson" else None,
        )
        if args.resume:
            try:
                step = runner.resume(args.resume)
            except (FileNotFoundError, CorruptCheckpointError,
                    ValueError) as e:
                # A missing, torn or foreign checkpoint dir is one line,
                # not a traceback.
                print(f"error: cannot resume from {args.resume!r}: {e}",
                      file=sys.stderr)
                return 2
            print(f"resumed from {args.resume} at iteration {step}",
                  file=sys.stderr)
        else:
            runner.init()

        def progress(info):
            if args.progress:
                print(json.dumps({"event": "iter", **info.as_dict()}),
                      file=sys.stderr)

        tw = None
        if args.telemetry:
            # Opened after resume validation: TelemetryWriter truncates its
            # file, and a failed --resume must not destroy a previous run's
            # telemetry on its way to exit 2.
            try:
                tw = obs.TelemetryWriter(args.telemetry)
            except OSError as e:
                print(f"error: cannot write telemetry to "
                      f"{args.telemetry!r}: {e}", file=sys.stderr)
                return 2

        # One flag captures both timelines: --trace writes the host span
        # timeline as Chrome trace-event JSON, --xla-trace (or the legacy
        # --profile) adds the torch.profiler device trace over the same
        # window.
        xla_dir = args.xla_trace or args.profile
        ctx = (capture(args.trace, xla_dir=xla_dir, name="cli.fit")
               if (args.trace or xla_dir) else contextlib.nullcontext())
        try:
            with ctx:
                state = runner.run(
                    callback=progress,
                    # A --resume run without --checkpoint keeps saving (and
                    # cuts its preemption checkpoint) into the resume dir;
                    # an explicit --checkpoint wins.
                    checkpoint_path=args.checkpoint or args.resume,
                    checkpoint_every=args.checkpoint_every,
                    checkpoint_keep=args.checkpoint_keep,
                    telemetry=tw,
                )
        finally:
            if tw is not None:
                tw.close()
    elif args.stream:
        state = _train_stream(args, x, k, kcfg, dev, stream_ckpt, mesh,
                              model, gmm_kw)
        if isinstance(state, int):
            return state
    elif mesh is not None and model in ("xmeans", "gmeans", "spectral",
                                        "bisecting"):
        # The families that take the mesh themselves: every inner fit and
        # assign rides the sharded engine (spectral's embedding-space
        # k-means does).
        fit = {"xmeans": models.fit_xmeans, "gmeans": models.fit_gmeans,
               "spectral": models.fit_spectral,
               "bisecting": models.fit_bisecting}[model]
        state = fit(x, k, config=kcfg, mesh=mesh)
        if model in ("xmeans", "gmeans"):
            k = int(state.centroids.shape[0])
    elif mesh is not None:
        from kmeans_tpu_torch import parallel

        fit = {"lloyd": parallel.fit_lloyd_sharded,
               "accelerated": parallel.fit_lloyd_accelerated_sharded,
               "minibatch": parallel.fit_minibatch_sharded,
               "spherical": parallel.fit_spherical_sharded,
               "fuzzy": parallel.fit_fuzzy_sharded,
               "gmm": parallel.fit_gmm_sharded,
               "kernel": parallel.fit_kernel_kmeans_sharded,
               "kmedoids": parallel.fit_kmedoids_sharded,
               "trimmed": parallel.fit_trimmed_sharded,
               "balanced": parallel.fit_balanced_sharded}[model]
        fit_kw = ({"trim_fraction": trim_fraction}
                  if model == "trimmed" else {}) | gmm_kw
        if engine_ckpt:
            if args.resume and main_rank:
                from kmeans_tpu_torch.utils.checkpoint import latest_step

                print(f"resuming sharded fit from {args.ckpt_dir} at sweep "
                      f"{latest_step(args.ckpt_dir)}", file=sys.stderr)
            fit_kw.update(ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          ckpt_keep=args.checkpoint_keep,
                          resume=bool(args.resume))
        state = fit(x, k, mesh=mesh, config=kcfg, **fit_kw)
    else:
        fit = {
            "lloyd": models.fit_lloyd,
            "accelerated": models.fit_lloyd_accelerated,
            "minibatch": models.fit_minibatch,
            "spherical": models.fit_spherical,
            "bisecting": models.fit_bisecting,
            "fuzzy": models.fit_fuzzy,
            "gmm": models.fit_gmm,
            "kernel": models.fit_kernel_kmeans,
            "kmedoids": models.fit_kmedoids,
            "trimmed": models.fit_trimmed,
            "balanced": models.fit_balanced,
            "spectral": models.fit_spectral,
            "xmeans": models.fit_xmeans,   # --k is k_max; k is discovered
            "gmeans": models.fit_gmeans,   # likewise (Anderson-Darling)
        }[model]
        fit_kw = ({"trim_fraction": trim_fraction}
                  if model == "trimmed" else {}) | gmm_kw
        if fit_weights is not None:
            fit_kw["weights"] = fit_weights
        state = fit(x, k, config=kcfg, device=dev, **fit_kw)
        if model in ("xmeans", "gmeans"):
            k = int(state.centroids.shape[0])
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    fit_s = time.perf_counter() - t0

    export_labels = state.labels
    merged_k = None
    if args.merge_k is not None:
        fitted_k = int(models.state_centers(state).shape[0])
        if fitted_k < 2:
            print("error: --merge-k: this fit has only 1 center; "
                  "nothing to merge", file=sys.stderr)
            return 2
        if args.merge_k >= fitted_k:
            print(f"error: --merge-k must be in [1, {fitted_k - 1}] "
                  "for this fit", file=sys.stderr)
            return 2
        export_labels, _ = models.merge_to_k(state, args.merge_k)
        merged_k = args.merge_k

    # One "inertia" field, lower is better for every family.
    result = {
        "n": int(n), "d": int(d), "k": int(k),
        "inertia": models.state_objective(state),
        "n_iter": int(state.n_iter),
        "converged": bool(state.converged),
        "wall_s": round(fit_s, 4),
        "mode": model,
    }
    if args.stream:
        result["stream"] = True
    if args.coreset is not None:
        result["coreset"] = args.coreset
    if merged_k is not None:
        result["merged_k"] = merged_k
    if mesh is not None:
        result["mesh"] = mesh.size
        if not main_rank:
            return 0
    print(json.dumps(result))

    if args.out:
        # Only the first max_cards rows are exported (sliced first, so a
        # --stream memmap never materializes); a trimmed fit's outliers
        # (label -1) become unassigned cards.
        rows = x[:args.max_cards]
        k_eff = merged_k if merged_k is not None else k
        doc = dataset_to_document(
            np.asarray(rows if isinstance(rows, np.ndarray)
                       else rows.float().cpu(), dtype=np.float32),
            np.asarray(export_labels[:args.max_cards].cpu()
                       if hasattr(export_labels, "cpu")
                       else export_labels[:args.max_cards]),
            max_cards=args.max_cards,
            enforce_limit=k_eff <= 3,
        )
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(export_json(doc))
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def _launch_mesh(args, n: int) -> int:
    """Run ``train`` as ``n`` ranks: ``n`` copies of this command with
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` and a free local rendezvous
    port; rank 0's output is the run's.  A rank that fails stops the
    others.  Returns the first failing rank's exit code, else 0."""
    import os
    import signal
    import subprocess

    import kmeans_tpu_torch
    from kmeans_tpu_torch.parallel.mesh import free_port

    if args.device != "cpu":
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            print(f"error: --mesh {n} runs one rank per card and this host "
                  f"has {have}; pass --device cpu to run the ranks as gloo "
                  "CPU processes", file=sys.stderr)
            return 2
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(kmeans_tpu_torch.__file__)))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.cli", *args.argv],
        env=dict(env, RANK=str(i), LOCAL_RANK=str(i))) for i in range(n)]
    first = 0
    try:
        while not first and any(p.poll() is None for p in procs):
            first = next((p.returncode for p in procs if p.returncode), 0)
            time.sleep(0.05)
        first = first or next((p.returncode for p in procs
                               if p.returncode), 0)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
    finally:
        # A failed rank stops the others; they get a moment to stop by
        # themselves first (a preempted mesh exits 3 on every rank).
        deadline = time.monotonic() + 10.0
        for p in procs:
            if p.poll() is None:
                if first:
                    try:
                        p.wait(timeout=max(0.1, min(
                            2.0, deadline - time.monotonic())))
                    except subprocess.TimeoutExpired:
                        p.terminate()
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    return first or next((p.returncode for p in procs if p.returncode), 0)


def _join_mesh(args, n: int):
    """This rank's mesh of ``n`` ranks from the ``torch.distributed``
    environment (``WORLD_SIZE`` / ``RANK`` / ``MASTER_*``): NCCL on the
    cards, gloo CPU processes with ``--device cpu``."""
    import os

    from kmeans_tpu_torch.parallel import make_mesh

    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise ValueError(f"--mesh {n} contradicts the process group's "
                         f"WORLD_SIZE={world}")
    if args.device == "cpu":
        return make_mesh((n, 1), ("data", "model"), platform="cpu")
    return make_mesh((n, 1), ("data", "model"))


def _train_stream(args, x, k, kcfg, dev, stream_ckpt, mesh, model, gmm_kw):
    """``train --stream``: the streamed minibatch fit, or online EM with
    ``--model gmm``, of the memory-mapped ``x`` (sharded over ``mesh`` when
    one is given); its state, or an exit code after a one-line error."""
    import contextlib

    from kmeans_tpu_torch import obs
    from kmeans_tpu_torch.models.gmm_stream import fit_gmm_stream
    from kmeans_tpu_torch.models.streaming import fit_minibatch_stream
    from kmeans_tpu_torch.utils import capture
    from kmeans_tpu_torch.utils.checkpoint import latest_step
    from kmeans_tpu_torch.utils.retry import RetryError

    ckpt_kw = {}
    if stream_ckpt:
        if args.resume and latest_step(args.resume) is None:
            # A mistyped --resume dir must not silently train from scratch
            # (and overwrite it) with exit 0.
            print(f"error: no checkpoint found at {args.resume!r} "
                  "to resume from", file=sys.stderr)
            return 2
        ckpt_kw = {"checkpoint_path": args.resume or args.checkpoint,
                   "checkpoint_every": args.checkpoint_every,
                   "checkpoint_keep": args.checkpoint_keep,
                   "resume": bool(args.resume)}
    # Explicit flags pass through as explicit arguments (None when the user
    # typed nothing), so the fit's refusal of a contradicted resume fires
    # for CLI flags too.
    stream_kw = dict(steps=args.steps, batch_size=args.batch_size,
                     seed=args.seed, mesh=mesh, **ckpt_kw, **gmm_kw)
    fit_stream = (fit_gmm_stream if model == "gmm"
                  else fit_minibatch_stream)
    model_label = "gmm_stream" if model == "gmm" else "minibatch_stream"
    tw_box = [None]
    if args.telemetry:
        try:
            # A probe that does not truncate: the resume parameters are
            # checked inside the fit, and a failed --resume must not
            # destroy a previous run's telemetry on its way to exit 2.  The
            # writer opens on the first step.
            obs.probe_writable(args.telemetry)
        except OSError as e:
            print(f"error: cannot write telemetry to "
                  f"{args.telemetry!r}: {e}", file=sys.stderr)
            return 2
        stepped = [False]

        def _stream_event(info):
            tw = tw_box[0]
            if tw is None:
                tw = tw_box[0] = obs.TelemetryWriter(args.telemetry, common={
                    "model": model_label, "device": dev.type})
            # The first step of this process carries the one-time costs
            # (on the card: the library's load), as the runner's does.
            phase = "step" if stepped[0] else "compile+step"
            stepped[0] = True
            tw.iteration(info, phase=phase)

        stream_kw["callback"] = _stream_event
    xla_dir = args.xla_trace or args.profile
    trace_ctx = (capture(args.trace, xla_dir=xla_dir,
                         name="cli.train_stream")
                 if (args.trace or xla_dir) else contextlib.nullcontext())
    try:
        try:
            with trace_ctx:
                return fit_stream(x, k, config=kcfg, device=dev,
                                  **stream_kw)
        except ValueError as e:
            # Predictable user errors (a foreign checkpoint, contradicted
            # sampling parameters, a step mismatch) are one line.
            print(f"error: {e}", file=sys.stderr)
            return 2
        except RetryError as e:
            # A permanent host-read fault: the budget is exhausted, and the
            # last periodic checkpoint (if any) stays resumable.
            print(f"error: streamed fit failed after retries: {e}",
                  file=sys.stderr)
            if stream_ckpt:
                ckpt = args.resume or args.checkpoint
                if latest_step(ckpt) is not None:
                    print(f"the last checkpoint at {ckpt!r} remains "
                          "resumable with --resume", file=sys.stderr)
            return 1
    finally:
        if tw_box[0] is not None:
            tw_box[0].close()


def _cmd_sweep(args) -> int:
    """Sweep k and print one scored JSON line per k, then a suggestion."""
    # Flag mismatches knowable before the data is loaded fail first.
    if args.criterion in ("bic", "aic") and args.model != "gmm":
        print(f"error: --criterion {args.criterion} requires --model gmm",
              file=sys.stderr)
        return 2
    if args.criterion == "gap" and args.model != "lloyd":
        print("error: --criterion gap runs Lloyd fits against uniform "
              "reference data; it requires --model lloyd", file=sys.stderr)
        return 2
    if args.criterion == "elbow" and \
            len(range(args.k_min, args.k_max + 1, args.k_step)) < 3:
        print("error: --criterion elbow needs at least 3 swept k values",
              file=sys.stderr)
        return 2
    if args.criterion == "elbow" and args.model == "spectral":
        print("error: --criterion elbow is meaningless for --model "
              "spectral (each k's objective lives in a different "
              "embedding space); use the default silhouette criterion",
              file=sys.stderr)
        return 2

    from kmeans_tpu_torch.data.synthetic import make_blobs
    from kmeans_tpu_torch.device import resolve_device
    from kmeans_tpu_torch.models import (gap_statistic, suggest_k,
                                         suggest_k_gap, sweep_k)

    if args.input:
        x = _load_npy(args.input)
        if x is None:
            return 2
        if x.ndim != 2:
            print(f"error: {args.input} must be a 2-D array", file=sys.stderr)
            return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        print(f"error: no CUDA device is available for --device "
              f"{args.device}; pass --device cpu to run the kernels' plain "
              "versions on the CPU", file=sys.stderr)
        return 2
    if not args.input:
        x, _, _ = make_blobs(args.seed, args.n, args.d, args.true_k,
                             cluster_std=args.cluster_std, device=dev)

    ks = list(range(args.k_min, args.k_max + 1, args.k_step))
    try:
        if args.criterion == "gap":
            rows = gap_statistic(
                x, ks, n_refs=args.gap_refs, max_iter=args.max_iter,
                compute_dtype=args.dtype, init=args.init, seed=args.seed,
                device=dev)
            suggestion = suggest_k_gap(rows)
        else:
            rows = sweep_k(
                x, ks, model=args.model, max_iter=args.max_iter,
                compute_dtype=args.dtype, init=args.init, seed=args.seed,
                silhouette_sample=args.silhouette_sample, device=dev)
            suggestion = suggest_k(rows, criterion=args.criterion)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"suggested_k": suggestion}))
    return 0


def _cmd_continuous(args) -> int:
    """Run the drift-aware continuous pipeline on ``--device``.

    Prints one JSON line per generation publish on stdout and a final
    ``done`` line; ``--progress`` adds one line per batch on stderr.  Exit 3
    on preemption with the resume hint, like every long-running fit.
    """
    import functools

    import numpy as np

    from kmeans_tpu_torch.continuous import (ContinuousConfig,
                                             ContinuousPipeline,
                                             ModelRegistry, drift_batch)
    from kmeans_tpu_torch.device import resolve_device

    if args.resume and not args.model_dir:
        print("error: --resume requires --model-dir (the registry "
              "checkpoint directory)", file=sys.stderr)
        return 2
    if args.batches < 1:
        print("error: --batches must be >= 1", file=sys.stderr)
        return 2

    if args.input:
        x = _load_npy(args.input)
        if x is None:
            return 2
        if x.ndim != 2:
            print(f"error: {args.input} must be a 2-D array",
                  file=sys.stderr)
            return 2
        n = x.shape[0]
        if n < args.batch_n:
            print(f"error: {args.input} has {n} rows < --batch-n "
                  f"{args.batch_n}", file=sys.stderr)
            return 2

        def source(t, _x=x, _n=n):
            # Sequential chunks, cycling: batch t is a pure function of t,
            # so --resume replays the stream exactly.
            lo = (t * args.batch_n) % _n
            idx = (np.arange(args.batch_n) + lo) % _n
            return np.ascontiguousarray(_x[idx], dtype=np.float32)
    else:
        source = functools.partial(
            drift_batch, n=args.batch_n, d=args.d,
            k=args.stream_k if args.stream_k is not None else args.k,
            seed=args.stream_seed, drift_at=args.drift_at,
            drift=args.drift, drift_len=args.drift_len,
            cluster_std=args.cluster_std,
        )

    cfg = ContinuousConfig(
        k=args.k, window_batches=args.window_batches,
        compact_above=args.compact_above, coreset_size=args.coreset,
        refit_iters=args.refit_iters, drift_ratio=args.drift_ratio,
        ewma_alpha=args.ewma_alpha, ewma_k_sigma=args.ewma_k_sigma,
        min_refit_batches=args.min_refit_batches,
        refit_every=args.refit_every,
        warmup_batches=args.warmup_batches, seed=args.seed,
    )
    try:
        cfg.validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        print(f"error: no CUDA device is available for --device "
              f"{args.device}; pass --device cpu to run the kernels' plain "
              "versions on the CPU", file=sys.stderr)
        return 2
    try:
        registry = ModelRegistry(path=args.model_dir or None,
                                 keep=args.checkpoint_keep)
        pipe = ContinuousPipeline(source, cfg, registry=registry,
                                  resume=args.resume, device=dev)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.resume:
        # The recovery clock stops at this line: the verified generation
        # is restored and serving could resume.
        print(json.dumps({
            "event": "resumed", "generation": registry.generation,
            "batch_idx": pipe.batch_idx, "ts": round(time.time(), 6),
        }), flush=True)

    seen = [registry.generation]

    def on_batch(info):
        if registry.generation != seen[0]:
            seen[0] = registry.generation
            print(json.dumps({
                "event": "generation", "generation": seen[0],
                "trigger": info.refit, "batch": info.batch,
                "inertia_pp": info.inertia_pp,
                "ts": round(time.time(), 6),
            }), flush=True)
        if args.progress:
            print(json.dumps({"event": "batch", **info.as_dict()}),
                  file=sys.stderr)

    tw = None
    if args.telemetry:
        from kmeans_tpu_torch import obs

        try:
            obs.probe_writable(args.telemetry)
        except OSError as e:
            print(f"error: cannot write telemetry to {args.telemetry!r}: "
                  f"{e}", file=sys.stderr)
            return 2
        tw = obs.TelemetryWriter(args.telemetry, append=True)
    try:
        try:
            gen = pipe.run(args.batches, callback=on_batch, telemetry=tw)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    finally:
        if tw is not None:
            tw.close()
    print(json.dumps({
        "event": "done", "batches": pipe.batch_idx,
        "generation": registry.generation,
        "trigger": gen.trigger if gen is not None else None,
        "ts": round(time.time(), 6),
    }), flush=True)
    return 0


def _cmd_serve(args) -> int:
    from kmeans_tpu_torch.serve.server import serve

    if args.workers > 1:
        return _serve_fleet(args)
    print(f"serving on http://{args.host}:{args.port}/ (Ctrl-C to stop)",
          file=sys.stderr)
    if args.metrics:
        print(f"metrics on http://{args.host}:{args.port}/metrics",
              file=sys.stderr)
    try:
        serve(args.host, args.port, background=False,
              persist_dir=args.persist_dir or None,
              metrics=args.metrics,
              telemetry_path=args.telemetry,
              model_dir=args.model_dir or None,
              assign_batching=args.assign_batching,
              assign_max_delay_s=(args.assign_max_delay_ms / 1000.0
                                  if args.assign_max_delay_ms is not None
                                  else None),
              assign_max_batch_rows=args.assign_max_batch,
              assign_max_points=args.assign_max_points,
              assign_quant=args.assign_quant,
              trace_dir=args.trace_dir or None,
              slo=args.slo,
              slo_latency_target_s=(args.slo_latency_target_ms / 1000.0
                                    if args.slo_latency_target_ms
                                    is not None else None),
              slo_min_samples=args.slo_min_samples,
              device=args.device)
    except KeyboardInterrupt:
        pass
    except (ValueError, RuntimeError) as e:
        # Config mistakes (an unwritable --telemetry path, no card without
        # --device cpu) surface at construction: one line.
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _serve_fleet(args) -> int:
    """``serve --workers N``: supervise N SO_REUSEPORT worker processes,
    each scoring on ``--device``, instead of serving in-process."""
    from kmeans_tpu_torch.config import ServeConfig
    from kmeans_tpu_torch.serve.fleet import FleetSupervisor

    overrides = {
        "host": args.host, "port": args.port,
        "persist_dir": args.persist_dir or None,
        "metrics": args.metrics,
        "telemetry_path": args.telemetry,
        "model_dir": args.model_dir or None,
        "assign_batching": args.assign_batching,
        "assign_max_delay_s": (args.assign_max_delay_ms / 1000.0
                               if args.assign_max_delay_ms is not None
                               else None),
        "assign_max_batch_rows": args.assign_max_batch,
        "assign_max_points": args.assign_max_points,
        "assign_quant": args.assign_quant,
        "trace_dir": args.trace_dir or None,
        "slo": args.slo,
        "slo_latency_target_s": (args.slo_latency_target_ms / 1000.0
                                 if args.slo_latency_target_ms
                                 is not None else None),
        "slo_min_samples": args.slo_min_samples,
        "fleet_obs_port": args.fleet_obs_port,
    }
    try:
        config = ServeConfig(**{k: v for k, v in overrides.items()
                                if v is not None})
        sup = FleetSupervisor(config, workers=args.workers,
                              device=args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(f"fleet: {args.workers} workers on "
          f"http://{args.host}:{args.port}/ (SIGTERM drains, "
          f"SIGHUP rolling-replaces, Ctrl-C to stop)", file=sys.stderr)
    try:
        return sup.run()
    except KeyboardInterrupt:
        # Second signal: hard stop.
        sup.stop(graceful=False)
        return 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kmeans_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", aliases=["fit"],
                       help="fit k-means and optionally export JSON")
    t.add_argument("--config", choices=[
        "blobs2d", "mnist", "glove", "cifar10", "imagenet"
    ], help="named BASELINE config (synthetic data at its shape)")
    t.add_argument("--input", help="path to a .npy (n, d) feature matrix")
    t.add_argument("--stream", action="store_true",
                   help="out-of-core minibatch fit: --input is memory-"
                        "mapped and batches stream from the host to the "
                        "device (online EM with --model gmm)")
    t.add_argument("--n", type=int, default=500)
    t.add_argument("--d", type=int, default=2)
    t.add_argument("--k", type=int, default=3)
    t.add_argument("--minibatch", action=argparse.BooleanOptionalAction,
                   default=None, help="alias for --model minibatch "
                   "(named configs set it from BASELINE)")
    t.add_argument("--model", default=None, choices=[
        "lloyd", "accelerated", "minibatch", "spherical", "bisecting",
        "fuzzy", "gmm", "kernel", "kmedoids", "trimmed", "balanced",
        "spectral", "xmeans", "gmeans",
    ], help="model family (default: lloyd, or the config's minibatch "
            "choice); for xmeans/gmeans, --k is k_max and k is discovered")
    t.add_argument("--covariance-type", default=None,
                   choices=["diag", "spherical", "tied"],
                   help="GMM covariance structure (--model gmm; streamed "
                        "GMM supports diag/spherical)")
    t.add_argument("--trim-fraction", type=float, default=None,
                   help="--model trimmed: fraction of points excluded as "
                        "outliers each iteration (default 0.05); trimmed "
                        "points export as unassigned cards")
    t.add_argument("--init", default="k-means++",
                   choices=["k-means++", "k-means||", "random"])
    t.add_argument("--mesh", type=int, default=0,
                   help="data-parallel mesh size (0/1 = single device): N "
                        "ranks, one process per card (--device cpu: gloo "
                        "CPU processes); every ported family and "
                        "--stream")
    t.add_argument("--max-iter", type=int, default=None,
                   help="Lloyd-family iteration cap (default 100); the "
                        "minibatch path is step-based — use --steps")
    t.add_argument("--steps", type=int, default=None,
                   help="minibatch/stream SGD steps (default 200)")
    t.add_argument("--coreset", type=int, default=None,
                   help="reduce the data to an M-point lightweight coreset "
                        "(Bachem et al. 2018) and run the fit weighted")
    t.add_argument("--merge-k", type=int, default=None,
                   help="export the labels merged to a coarser k along the "
                        "centroid dendrogram (Ward linkage)")
    t.add_argument("--pca", type=int, default=None,
                   help="project onto the top N principal components "
                        "before fitting (composes with --coreset/--mesh)")
    t.add_argument("--whiten", action="store_true",
                   help="with --pca: rescale components to unit variance")
    t.add_argument("--batch-size", type=int, default=None,
                   help="minibatch/stream batch size (default 8192)")
    t.add_argument("--update", default=None,
                   choices=["auto", "matmul", "segment", "delta",
                            "hamerly", "yinyang"],
                   help="Lloyd centroid-update reduction (default auto: the "
                        "incremental 'delta' sweep, which large fits switch "
                        "with yinyang at runtime from the measured "
                        "recompute fraction); 'hamerly' and 'yinyang' "
                        "prune the distance pass with exact score bounds")
    t.add_argument("--yinyang-groups", type=int, default=None,
                   help="centroid group count t of the yinyang bounds "
                        "(default ceil(k/10)); needs --update yinyang or "
                        "auto")
    t.add_argument("--comm", default=None,
                   choices=["auto", "allreduce", "scatter"],
                   help="sweep-merge collective of the sharded fit "
                        "(needs --mesh > 1): 'allreduce' sums the full "
                        "per-rank sums|counts slab, 'scatter' reduce-"
                        "scatters it so each rank owns and updates a "
                        "k/mesh slice, then all-gathers the centroids; "
                        "'auto' scatters once the f32 (k, d) slab reaches "
                        "4 MiB")
    t.add_argument("--accel", default=None, choices=["beta", "anderson"],
                   help="accelerated-fit extrapolation (selects --model "
                        "accelerated when no model is given); with the "
                        "runner flags, 'anderson' accelerates the "
                        "step-paced lloyd runner and stamps per-iteration "
                        "outcomes into the telemetry")
    t.add_argument("--schedule", default=None, choices=["full", "nested"],
                   help="iteration schedule of the accelerated/minibatch "
                        "fits: 'nested' runs the doubling subsample ladder "
                        "before the full-batch loop")
    t.add_argument("--anderson-m", type=int, default=None,
                   help="Anderson history depth m (default 5; requires "
                        "--accel anderson)")
    t.add_argument("--tol", type=float, default=1e-4)
    t.add_argument("--seed", type=int, default=None,
                   help="RNG seed of the generated data and the init "
                        "(default 0)")
    t.add_argument("--dtype", default=None,
                   choices=[None, "bfloat16", "float32"],
                   help="compute dtype of the distance product (the data "
                        "stays float32)")
    t.add_argument("--cluster-std", type=float, default=0.6)
    t.add_argument("--device", default="cuda",
                   help="where the fit runs: cuda (the default; exits 2 "
                        "without a card) or cpu (the kernels' plain "
                        "versions)")
    t.add_argument("--out", help="write reference-schema export JSON here")
    t.add_argument("--max-cards", type=int, default=500)
    t.add_argument("--progress", action="store_true",
                   help="print one JSON line per Lloyd iteration to stderr")
    t.add_argument("--checkpoint", help="checkpoint directory (periodic "
                   "saves of the Lloyd runner or the streamed fit)")
    t.add_argument("--checkpoint-every", type=int, default=10)
    t.add_argument("--checkpoint-keep", type=int, default=0,
                   help="retain up to N displaced checkpoints as step-"
                        "tagged siblings (rolling history; 0 = none)")
    t.add_argument("--resume", help="resume the Lloyd runner or the "
                   "streamed fit from this checkpoint directory (it keeps "
                   "saving there; the runner's unless --checkpoint names "
                   "another)")
    t.add_argument("--ckpt-dir", help="elastic checkpoint directory of the "
                   "sharded engine (--model lloyd --mesh > 1): global "
                   "centroids every --ckpt-every sweeps and on SIGTERM; "
                   "--resume DIR continues them on any mesh size")
    t.add_argument("--ckpt-every", type=int, default=None,
                   help="sweeps between elastic checkpoints (default 10; "
                        "needs --ckpt-dir)")
    t.add_argument("--profile", help="legacy spelling of --xla-trace")
    t.add_argument("--trace", metavar="OUT.json",
                   help="write the run's host span timeline (the runner's "
                        "iteration, sweep, update, host sync and checkpoint "
                        "spans) as Chrome trace-event JSON; runs the "
                        "step-paced Lloyd runner")
    t.add_argument("--xla-trace", metavar="DIR",
                   help="write a torch.profiler Chrome trace of the device "
                        "timeline into DIR/trace.json over the same window "
                        "as --trace")
    t.add_argument("--telemetry", metavar="OUT.jsonl",
                   help="write one JSON telemetry event per iteration to "
                        "this file (inertia, shift, seconds, device, "
                        "phase); runs the step-paced Lloyd runner, or "
                        "one event a step with --stream")
    t.set_defaults(fn=_cmd_train)

    w = sub.add_parser("sweep", help="sweep k, score fits, suggest a k")
    w.add_argument("--input", help="path to a .npy (n, d) feature matrix")
    w.add_argument("--n", type=int, default=2000)
    w.add_argument("--d", type=int, default=8)
    w.add_argument("--true-k", type=int, default=4,
                   help="generating k for the synthetic fallback data")
    w.add_argument("--k-min", type=int, default=2)
    w.add_argument("--k-max", type=int, default=8)
    w.add_argument("--k-step", type=int, default=1)
    w.add_argument("--model", default="lloyd", choices=[
        "lloyd", "accelerated", "minibatch", "spherical", "bisecting",
        "fuzzy", "gmm", "kernel", "kmedoids", "balanced", "spectral",
    ])
    w.add_argument("--criterion", default="silhouette",
                   choices=["silhouette", "bic", "aic", "gap", "elbow"],
                   help="suggestion rule; bic/aic need --model gmm, gap "
                        "runs the Tibshirani gap statistic (--model "
                        "lloyd), elbow is the objective kneedle read of "
                        "the inertia curve (any model)")
    w.add_argument("--gap-refs", type=int, default=10,
                   help="reference datasets per k for --criterion gap")
    w.add_argument("--init", default="k-means++",
                   choices=["k-means++", "k-means||", "random"])
    w.add_argument("--max-iter", type=int, default=100)
    w.add_argument("--seed", type=int, default=0)
    w.add_argument("--dtype", default=None,
                   choices=[None, "bfloat16", "float32"])
    w.add_argument("--cluster-std", type=float, default=0.4)
    w.add_argument("--silhouette-sample", type=int, default=10_000)
    w.add_argument("--device", default="cuda",
                   help="where the fits run: cuda (the default; exits 2 "
                        "without a card) or cpu (the kernels' plain "
                        "versions)")
    w.set_defaults(fn=_cmd_sweep)

    c = sub.add_parser(
        "continuous",
        help="run the drift-aware continuous clustering pipeline",
    )
    c.add_argument("--k", type=int, default=4)
    c.add_argument("--batches", type=int, default=60,
                   help="total stream length in batches (absolute; a "
                        "--resume continues from the checkpointed "
                        "position toward this total)")
    c.add_argument("--model-dir", default=None, metavar="DIR",
                   help="model-registry checkpoint directory (each "
                        "generation publishes here atomically); serve "
                        "--model-dir points at the same directory")
    c.add_argument("--resume", action="store_true",
                   help="restore the newest verified generation from "
                        "--model-dir and replay the stream from its "
                        "recorded position")
    c.add_argument("--input", help="path to a .npy (n, d) matrix streamed "
                                   "as cycling sequential chunks (default: "
                                   "synthetic drifting blobs)")
    c.add_argument("--batch-n", type=int, default=512,
                   help="rows per stream batch")
    c.add_argument("--d", type=int, default=8)
    c.add_argument("--stream-k", type=int, default=None,
                   help="generating cluster count of the synthetic "
                        "stream (default: --k)")
    c.add_argument("--stream-seed", type=int, default=0)
    c.add_argument("--drift-at", type=int, default=30,
                   help="batch index where the synthetic centers drift")
    c.add_argument("--drift", type=float, default=6.0,
                   help="drift offset norm per center")
    c.add_argument("--drift-len", type=int, default=0,
                   help="batches the drift glides over (0 = abrupt)")
    c.add_argument("--cluster-std", type=float, default=0.6)
    c.add_argument("--window-batches", type=int, default=8)
    c.add_argument("--compact-above", type=int, default=32768,
                   help="window point count that triggers coreset "
                        "compaction")
    c.add_argument("--coreset", type=int, default=4096,
                   help="compacted window coreset size")
    c.add_argument("--refit-iters", type=int, default=25)
    c.add_argument("--drift-ratio", type=float, default=0.25)
    c.add_argument("--ewma-alpha", type=float, default=0.3)
    c.add_argument("--ewma-k-sigma", type=float, default=6.0)
    c.add_argument("--min-refit-batches", type=int, default=2)
    c.add_argument("--refit-every", type=int, default=10,
                   help="scheduled refit cadence in batches since the "
                        "last refit (0 disables; drift triggers still "
                        "fire)")
    c.add_argument("--warmup-batches", type=int, default=2)
    c.add_argument("--checkpoint-keep", type=int, default=2,
                   help="step-tagged retention dirs kept per generation "
                        "checkpoint")
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--device", default="cuda",
                   help="where scoring, compactions and refits run: cuda "
                        "(the default; exits 2 without a card) or cpu "
                        "(the kernels' plain versions)")
    c.add_argument("--progress", action="store_true",
                   help="print one JSON line per batch to stderr")
    c.add_argument("--telemetry", metavar="OUT.jsonl",
                   help="append one JSON telemetry event per batch")
    c.set_defaults(fn=_cmd_continuous)

    s = sub.add_parser("serve", help="run the HTTP/SSE board and model "
                                     "server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8787)
    s.add_argument("--device", default="cuda",
                   help="where the assignment engine scores and the board's "
                        "fits run: cuda (the default; raises without a "
                        "card) or cpu (the kernels' plain versions)")
    s.add_argument("--persist-dir", default=".kmeans_rooms", metavar="DIR",
                   help="directory for durable rooms (reloaded on restart; "
                        "pass '' to disable)")
    s.add_argument("--metrics", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="serve GET /metrics (Prometheus text; default on)")
    s.add_argument("--telemetry", metavar="OUT.jsonl", default=None,
                   help="telemetry file of train jobs (probed for "
                        "writability at start)")
    s.add_argument("--model-dir", default=None, metavar="DIR",
                   help="serve /api/assign from the model-registry "
                        "checkpoints in DIR (newest verified generation "
                        "restored at boot, POST /api/model/reload picks up "
                        "new ones)")
    s.add_argument("--assign-batching",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="adaptive micro-batching on /api/assign (default "
                        "on; --no-assign-batching keeps the per-request "
                        "NumPy path)")
    s.add_argument("--assign-max-delay-ms", type=float, default=None,
                   metavar="MS",
                   help="ceiling on the queue delay the batcher may add "
                        "to coalesce a batch (default 2)")
    s.add_argument("--assign-max-batch", type=int, default=None,
                   metavar="ROWS",
                   help="row cap on one coalesced assign batch "
                        "(default 8192)")
    s.add_argument("--assign-max-points", type=int, default=None,
                   metavar="N",
                   help="per-request point cap on POST /api/assign "
                        "(default 4096)")
    s.add_argument("--assign-quant", choices=("int8", "bf16", "off"),
                   default=None,
                   help="compressed-codebook scoring tier (exact labels; "
                        "default off, int8 by policy at >= 256 MiB f32 "
                        "codebooks)")
    s.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="spool completed spans to spans-<pid>.jsonl "
                        "under DIR (with --workers N the supervisor also "
                        "serves the merged trace at its obs endpoint's "
                        "/api/trace)")
    s.add_argument("--slo", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="burn-rate SLO monitor: /readyz answers 503 while "
                        "a window is in breach (default off)")
    s.add_argument("--slo-latency-target-ms", type=float, default=None,
                   metavar="MS",
                   help="latency SLO threshold (default 250)")
    s.add_argument("--slo-min-samples", type=int, default=None,
                   metavar="N",
                   help="events a window needs before it can breach "
                        "(default 50)")
    s.add_argument("--fleet-obs-port", type=int, default=None,
                   metavar="PORT",
                   help="fixed port for the supervisor's fleet "
                        "observability endpoint (--workers N only: the "
                        "workers' /metrics aggregated under a worker "
                        "label, the merged /api/trace, /readyz; default: "
                        "an ephemeral port, announced in the supervisor's "
                        "obs_up event)")
    s.add_argument("--workers", type=int, default=1, metavar="N",
                   help="run N supervised SO_REUSEPORT worker processes, "
                        "each with its own engine on --device, instead of "
                        "serving in-process (crashed workers respawn with "
                        "backoff; model-dir publishes are pushed to every "
                        "worker; SIGTERM drains, SIGHUP replaces the "
                        "workers one by one)")
    s.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    from kmeans_tpu_torch.utils.preempt import Preempted

    grouped = _in_process_group()
    try:
        return args.fn(args)
    except Preempted as e:
        # SIGTERM/SIGINT during a long fit: the loop already cut a final
        # checkpoint; report the resumable state and exit with a distinct
        # code (3 = preempted; 2 = usage error).
        # On a mesh every rank stops at the same boundary; rank 0 reports.
        import os

        if os.environ.get("RANK", "0") == "0":
            print(f"preempted: {e}", file=sys.stderr)
            if e.resume_hint:
                print(f"resume with: {e.resume_hint}", file=sys.stderr)
        return 3
    finally:
        if not grouped and _in_process_group():
            # A --mesh rank leaves the group it joined (a group the caller
            # made stays), and frees the group's objects now: one still
            # held at the interpreter's teardown (by a reference cycle)
            # can abort the exit, "terminate called without an active
            # exception", a rank's code then -6.
            import gc

            sys.modules["torch.distributed"].destroy_process_group()
            gc.collect()


def _in_process_group() -> bool:
    dist = sys.modules.get("torch.distributed")
    return bool(dist is not None and dist.is_available()
                and dist.is_initialized())


if __name__ == "__main__":
    raise SystemExit(main())
