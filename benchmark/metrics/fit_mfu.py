"""fit_mfu: the window's fits' share of the card's peak rate, in %: the
scoring operations the fits needed over the window's fit time at the
dense bf16 peak (layer: fit loop).

A fit needs ``2·rows·d·k`` operations for each pass that scores rows
against k centroids: k-means++'s k rounds of one centre over all n rows
(as much as one pass of n rows) when the mix seeds, every sweep's
rows (``diag_["recompute_rows"]`` where the fit counted them, n a sweep
where it did not) and the final classic pass over n rows.  It bounds the
kernels' rooflines: a kernel taken off the path leaves its own roofline
silent, and this share still counts the work."""

from benchmark.roofline import PEAK_OPS_PER_S, scoring_ops


def read(run):
    if not run.records:
        return None
    n, d, k = (int(run.config[key]) for key in ("n", "d", "k"))
    seeds = run.traffic.get("init") == "k-means++"
    ops = 0.0
    for f in run.records:
        rows = (f.diag["recompute_rows"] if f.diag.get("rows_seen", -1) > 0
                else f.n_iter * n)
        rows += n + (n if seeds else 0)   # final pass; k seeding rounds
        ops += scoring_ops(rows, d, k)
    seconds = sum(f.seconds for f in run.records)
    return 100.0 * ops / (seconds * PEAK_OPS_PER_S)
