"""Device time a step of the port's own CUDA kernels."""


def read(t):
    total = sum(s for s, _ in t.port.values())
    if total <= 0:
        return None
    return total / t.steps * 1e3
