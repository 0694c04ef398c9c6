"""Device time a step under the ``fabric.aggregate`` span: the bucketed
aggregation, packed votes and FP32 means (``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "fabric.aggregate")
