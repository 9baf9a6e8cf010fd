"""k2_roofline: the share, in %, of the least time of K2's calls
(``lloyd_delta_cuda``, the incremental sweep) over the device time they
took in the traced fits (layer: kernels, ``ops/cuda_lloyd.py`` and
``csrc/lloyd.cu``).

A K2 call is found in the device trace by its epilogue, which no other
entry point launches: ``core_delta_finish_kernel`` after the Hopper
core's score kernel (bf16, or the f32 route's), or ``lloyd_delta_kernel``
on ``score_block``.  Its device time sums that kernel, the score kernel
launched just before the epilogue, and the fold core's kernels that
follow it (the dual fold of the changed rows).  The least time of a call
is ``max(2·n·d·k / 989e12, bytes / 3.35e12)`` at the cell's shape
(:func:`benchmark.roofline.k2_least_seconds`).  None where the traced fits
ran no K2 call."""

from collections import defaultdict

from benchmark.roofline import k2_least_seconds

#: The epilogue that marks a K2 call.
EPILOGUES = ("core_delta_finish_kernel", "lloyd_delta_kernel")
#: Score kernels a core epilogue finishes.
SCORES = ("core_score_kernel", "core32_score_kernel")
#: The fold core's kernels (the dual fold of the changed rows).
FOLD = ("sort_hist_kernel", "sort_digit_scan_kernel", "sort_scatter_kernel",
        "fold_start_kernel", "fold_kernel", "fold_combine_kernel")


def read(run):
    if run.trace is None:
        return None
    streams = defaultdict(list)
    for k in run.trace.kernels:
        if k.cat == "kernel":
            streams[k.stream].append(k)
    calls, busy_us = 0, 0.0
    for ks in streams.values():
        for i, k in enumerate(ks):
            if k.base not in EPILOGUES:
                continue
            calls += 1
            busy_us += k.dur
            if k.base == EPILOGUES[0] and i > 0 and ks[i - 1].base in SCORES:
                busy_us += ks[i - 1].dur
            for f in ks[i + 1:]:
                if f.base not in FOLD:
                    break
                busy_us += f.dur
    if not calls:
        return None
    cfg = run.config
    least = k2_least_seconds(int(cfg["n"]), int(cfg["d"]), int(cfg["k"]),
                             cfg["storage_dtype"], cfg.get("compute_dtype"))
    return 100.0 * calls * least / (busy_us * 1e-6)
