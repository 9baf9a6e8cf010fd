"""sweep_ms: a fit's time outside its seeding over its sweeps, averaged
over the window's fits, in milliseconds (layer: sweeps and planner).  It
holds the fit's set-up (group formation, row norms) and its final classic
pass too; where no seeding ran it is the fit's time over its sweeps."""


def read(run):
    per_fit = [(f.seconds - (f.seed_s or 0.0)) / f.n_iter
               for f in run.records if f.n_iter > 0]
    if not per_fit:
        return None
    return 1e3 * sum(per_fit) / len(per_fit)
