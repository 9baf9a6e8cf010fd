"""sweeps_per_fit: the mean of ``KMeans.n_iter_`` over the window's fits
(layer: fit loop, ``models/lloyd.py``)."""


def read(run):
    if not run.records:
        return None
    return sum(f.n_iter for f in run.records) / len(run.records)
