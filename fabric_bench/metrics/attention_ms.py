"""Device time a step under the ``model.attention`` spans: scores, mask,
softmax and values, in the forward and in the backward's recompute (the
attention's own backward stays in ``backward_ms``; ``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "model.attention")
