"""Command line of the port: ``serve``.

    python -m kmeans_tpu_torch.cli serve --model-dir DIR [--port 8787]
        [--workers N [--fleet-obs-port PORT]]

serves ``POST /api/assign`` from the newest verified generation in DIR (a
:class:`~kmeans_tpu_torch.continuous.registry.ModelRegistry` directory of
either package), scored on the card; ``--device cpu`` runs the kernels'
plain versions on the CPU.  ``--workers N`` above 1 runs the fleet
(:mod:`kmeans_tpu_torch.serve.fleet`): N worker processes on the one port,
each with its own engine on ``--device``, a supervisor that respawns them,
pushes new generations to them, drains them on SIGTERM and replaces them
one by one on SIGHUP, and with ``--fleet-obs-port`` the fleet's aggregated
``/metrics`` and merged ``/api/trace``.  The flags are the reference's
(``kmeans_tpu/cli.py serve``) plus ``--device``.  Known difference: board
persistence (``--persist-dir``, unset by default here) is not ported, and
asking for it exits with code 2.
"""

from __future__ import annotations

import argparse
import sys


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
        # Config mistakes (an unwritable --telemetry path, --persist-dir,
        # no card without --device cpu) surface at construction: one line.
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
        if config.persist_dir:
            # Every worker's server would refuse it at boot.
            raise ValueError(
                f"persist_dir={config.persist_dir!r}: board persistence is "
                "not ported; the port serves models only")
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

    s = sub.add_parser("serve", help="run the HTTP model server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8787)
    s.add_argument("--device", default="cuda",
                   help="where the assignment engine scores: cuda (the "
                        "default; raises without a card) or cpu (the "
                        "kernels' plain versions)")
    s.add_argument("--persist-dir", default=None, metavar="DIR",
                   help="board persistence; not ported, refused if given")
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
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
