"""Self device time a step of the ``model.moe`` spans: the router, top-k,
capacity assignment, dispatch and combine, without the experts'
products (``model.moe.experts``; ``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "model.moe", own=True)
