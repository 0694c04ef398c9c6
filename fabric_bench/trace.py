"""A traced window of training steps, read from ``torch.profiler``.

The benchmark traces a few steps of the same Trainer the window drives,
with the profiler's CUDA activity alone (device events and the host's
CUDA runtime calls: on an H100, recording every host operator as well
slowed the MoE cell's traced steps at 1 x 4096 tokens a worker from
1.15 to 2.51 s, the CUDA activity alone to 1.64 s, and the dense cell's
not at all), and reduces the raw events (no
tree is built: a MoE step holds tens of thousands) to what the
per-layer readers need: the window's wall time, the device's busy time
as the union of its events' intervals, the device time of each kernel
by name, the host's kernel launch calls, and the longest idle gaps
named by the runtime call running through each (none: the host was in
Python or in PyTorch's dispatch).
"""
from __future__ import annotations

import dataclasses
import re
import time

from .counts.port_kernels import port_kernel

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")

#: coarse kinds of device operation, by name, the first match winning
KINDS = (("port kernels", None),
         ("float32 matmul (no tensor cores)",
          re.compile(r"gemm_f32f32|sgemm|simt_sgemm")),
         ("matmul (tensor cores)", re.compile(r"nvjet|gemm|cutlass")),
         ("copies", re.compile(r"Memcpy|Memset|copy_kernel|CatArray")),
         ("softmax and reductions",
          re.compile(r"softmax|SoftMax|reduce_kernel|scan")),
         ("elementwise", re.compile(r"elementwise|Functor|index|gather")))


@dataclasses.dataclass
class Trace:
    cell: object
    steps: int
    window_s: float
    busy_s: float
    kernels: dict            # device op name -> (seconds, count)
    port: dict               # port kernel -> (seconds, count)
    launch_calls: int
    idle_gaps: list          # [(host op, seconds)], longest first
    device_kind: str

    def kinds(self) -> dict:
        """Device seconds by coarse kind of operation (``KINDS``)."""
        out = {}
        for name, (s, _) in self.kernels.items():
            kind = "other"
            for k, pat in KINDS:
                if (port_kernel(name) is not None if pat is None
                        else pat.search(name)):
                    kind = k
                    break
            out[kind] = out.get(kind, 0.0) + s
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:120], s] for k, (s, _) in ops],
                "idle_gaps": [[n[:120], s] for n, s in self.idle_gaps[:top]]}


def _union(intervals):
    """Merged (start, end) intervals of a list, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, t):
    """The shortest host event (a CUDA runtime call) running at ``t``."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host, between CUDA calls"


def record(trainer, cell, steps: int, device_kind: str, on_card: bool,
           top: int = 10) -> Trace:
    """Trace ``steps`` more steps of ``trainer`` and reduce the events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        start = trainer.state.step
        trainer.run(start + steps)
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host, kernels, port, launches = [], [], {}, {}, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if e.device_type().name == "CUDA":
            dev.append((a, b))
            s, n = kernels.get(name, (0.0, 0))
            kernels[name] = (s + (b - a) * 1e-9, n + 1)
            k = port_kernel(name)
            if k is not None:
                s, n = port.get(k, (0.0, 0))
                port[k] = (s + (b - a) * 1e-9, n + 1)
        else:
            host.append((a, b, name))
            launches += name.startswith(LAUNCH_CALLS)
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle = [(_innermost(host, (a + b) // 2), (b - a) * 1e-9) for a, b in gaps]
    return Trace(cell=cell, steps=steps, window_s=window_s, busy_s=busy_s,
                 kernels=kernels, port=port, launch_calls=launches,
                 idle_gaps=idle, device_kind=device_kind)
