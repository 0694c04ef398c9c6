"""Device time a step under the ``fabric.backward`` spans: each worker's
backward, the recomputed layers inside it (``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "fabric.backward")
