"""Device time a step under the ``optim.apply`` span: the optimizer's
update of every leaf (``fabric_bench.spans``)."""
from fabric_bench.spans import phase_ms


def read(t):
    return phase_ms(t, "optim.apply")
