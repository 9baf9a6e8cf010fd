"""recompute_frac: rows whose distances the window's fits recomputed over
the rows their sweeps saw, summed over the fits (``KMeans.diag_``'s
``recompute_rows`` and ``rows_seen``; layer: fit loop).  None where no fit
ran a pruned or adaptive loop (the counters are then -1)."""


def read(run):
    fits = [f for f in run.records if f.diag.get("rows_seen", -1) > 0]
    if not fits:
        return None
    seen = sum(f.diag["rows_seen"] for f in fits)
    return sum(f.diag["recompute_rows"] for f in fits) / seen
