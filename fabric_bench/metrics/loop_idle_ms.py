"""Device idle time a step while no ``trainer.step`` span is open: the
Trainer's loop, the batch copy and the step's bookkeeping
(``fabric_bench.spans``)."""


def read(t):
    if getattr(t, "record", None) is None or t.busy_s <= 0:
        return None
    return t.loop_idle_s / t.steps * 1e3
