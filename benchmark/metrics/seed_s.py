"""seed_s: the mean seconds of a window fit's k-means++ seeding, from the
span the harness puts around ``models/init.kmeans_plus_plus`` (host clock
between two synchronisations; layer: seeding).  None where no fit seeded."""


def read(run):
    spans = [f.seed_s for f in run.records if f.seed_s is not None]
    if not spans:
        return None
    return sum(spans) / len(spans)
