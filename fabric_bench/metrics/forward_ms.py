"""Device time a step under the ``fabric.forward`` spans: each of the W
workers' forwards (``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "fabric.forward")
