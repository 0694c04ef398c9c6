"""The share of the MoE layers' capacity slots taken: the program's
counters ``moe.slots_filled`` over ``moe.slots``."""


def read(t):
    rec = getattr(t, "record", None)
    slots = rec.counter("moe.slots") if rec is not None else 0
    if not slots:
        return None
    return 100.0 * rec.device.get("moe.slots_filled", 0) / slots
