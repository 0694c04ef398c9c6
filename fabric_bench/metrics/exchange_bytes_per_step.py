"""One rank's collective input bytes a step inside the aggregation:
the program's ``collective.<op>.bytes`` counters under ``fabric.aggregate``,
in MiB (virtual on one card: no wire carries them)."""


def read(t):
    rec = getattr(t, "record", None)
    if rec is None:
        return None
    names = {c.name for c in rec.counts
             if c.name.startswith("collective.") and c.name.endswith(".bytes")}
    total = sum(rec.counter(n, under="fabric.aggregate") for n in names)
    if total <= 0:
        return None
    return total / t.steps / 2 ** 20
