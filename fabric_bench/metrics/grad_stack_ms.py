"""Device time a step under the ``fabric.grad_stack`` spans: each
worker's gradients copied into the stacked (W, ...) buffers
(``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "fabric.grad_stack")
