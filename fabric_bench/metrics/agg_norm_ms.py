"""Device time a step under the ``fabric.agg_norm`` span: the
aggregate's norm and the diagnostics' cosines (``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "fabric.agg_norm")
