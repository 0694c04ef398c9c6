"""Step analysis of the launch dry-run: the collective inventory, the ring
model, the roofline terms, and the trace of one eager step.

Counterpart of two reference modules:

  * ``repro/launch/hlo_analysis.py``: :data:`DTYPE_BYTES`,
    :class:`CollectiveOp`, the ring model :func:`_wire_bytes`,
    :func:`summarize_collectives` and :func:`roofline_terms`, as they
    are.  The roofline's constants are one NVIDIA H100 SXM's, from its
    data sheet at its 700 W limit: 989e12 dense bf16 FLOP/s, 3.35e12 B/s
    of HBM3 and 450e9 B/s of NVLink each way.
  * ``repro/launch/hlo_walk.py``: torch has no HLO, so the walk is a
    trace of one eager step (:class:`StepTrace`).  FLOPs come from
    ``torch.utils.flop_counter.FlopCounterMode`` (the recompute of a
    checkpointed layer runs again in the backward and is counted, as
    the reference's walk counts remat).  HBM bytes add the operand and
    output bytes of each aten op that is not a view: the reference's
    rule that a fusion counts as one op, applied to unfused eager ops.
    The collectives are the calls the port's
    :class:`~repro_torch.core.collectives.DistributedGroup` makes,
    each folded through the ring model, not parsed out of any IR.
    Eager torch runs every loop unrolled, so the reference's loop trip
    counts have no counterpart here.

A kernel wrapper called on ``meta`` operands records its call in
:data:`repro_torch.kernels.build.META_CALLS` in place of a launch; the
trace adds those calls' operand and output bytes to the HBM bytes.  The
peak memory tracks the live storages of the traced device: each new
storage adds its bytes and a freed one drops them;
``argument_bytes`` are the rank's state and inputs before the step and
``temp_bytes`` the peak above them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

#: torch dtypes under the reference's (HLO) names
DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

#: a DistributedGroup's op -> the reference's collective kind; a
#: broadcast has no kind in the reference's inventory, and the ring model
#: prices it at 0
COLLECTIVE_KINDS = {"all_reduce": "all-reduce", "barrier": "all-reduce",
                    "all_gather": "all-gather", "all_to_all": "all-to-all",
                    "broadcast": "broadcast"}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_total: int          # per-device payload size of the op's output
    group_size: int
    wire_bytes: float         # per-device bytes crossing links (ring model)
    crosses_pod: bool
    dtype: str = ""


def _wire_bytes(kind: str, payload: int, g: int) -> float:
    """Ring-model per-device wire bytes for one collective."""
    if g <= 1:
        return 0.0
    f = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * f * payload
    if kind == "all-gather":
        return f * payload                 # payload = gathered output
    if kind == "reduce-scatter":
        return (g - 1) * payload           # payload = scattered output
    if kind == "all-to-all":
        return f * payload
    if kind == "collective-permute":
        return float(payload)
    return 0.0


def summarize_collectives(ops: list[CollectiveOp]) -> dict:
    by_kind: dict[str, dict] = {}
    by_dtype: dict[str, float] = {}
    by_group: dict[str, float] = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "wire_bytes": 0.0,
                                         "payload_bytes": 0})
        d["count"] += 1
        d["wire_bytes"] += op.wire_bytes
        d["payload_bytes"] += op.bytes_total
        by_dtype[op.dtype] = by_dtype.get(op.dtype, 0.0) + op.wire_bytes
        key = f"g{op.group_size}"
        by_group[key] = by_group.get(key, 0.0) + op.wire_bytes
    total_wire = sum(o.wire_bytes for o in ops)
    pod_wire = sum(o.wire_bytes for o in ops if o.crosses_pod)
    top = sorted(ops, key=lambda o: -o.wire_bytes)[:8]
    return {
        "total_wire_bytes": total_wire,
        "pod_crossing_wire_bytes": pod_wire,
        "num_ops": len(ops),
        "by_kind": by_kind,
        "by_dtype": by_dtype,
        "by_group_size": by_group,
        "top_ops": [{"kind": o.kind, "dtype": o.dtype,
                     "group": o.group_size, "wire_bytes": o.wire_bytes}
                    for o in top],
    }


# ---------------------------------------------------------------------------
# roofline terms (one NVIDIA H100 SXM at its 700 W limit, data sheet)
# ---------------------------------------------------------------------------

H100_PEAK_FLOPS = 989e12     # dense bf16 FLOP/s per card
H100_HBM_BW = 3.35e12        # HBM3 bytes/s per card
H100_NVLINK_BW = 450e9       # NVLink bytes/s per card, one direction


def roofline_terms(flops_per_device: float, hbm_bytes_per_device: float,
                   wire_bytes_per_device: float) -> dict:
    t_comp = flops_per_device / H100_PEAK_FLOPS
    t_mem = hbm_bytes_per_device / H100_HBM_BW
    t_coll = wire_bytes_per_device / H100_NVLINK_BW
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_comp, t_mem, t_coll)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "roofline_fraction": (t_comp / bound) if bound > 0 else 0.0,
        "step_time_lower_bound_s": bound,
    }


# ---------------------------------------------------------------------------
# the trace of one eager step
# ---------------------------------------------------------------------------

def tensors_of(*objs) -> list[torch.Tensor]:
    """Every tensor held by nested dicts, lists, tuples, dataclasses and
    modules (a module's parameters and buffers)."""
    out, todo = [], list(objs)
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            todo.extend(x.parameters())
            todo.extend(x.buffers())
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            todo.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: ops that move no data: a fresh allocation, and ops that only
#: reinterpret their input (not flagged as views by their schema)
_NO_TRAFFIC = frozenset({
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten._unsafe_view.default,
    torch.ops.aten.detach.default, torch.ops.aten.lift_fresh.default,
})


class _LiveStorages:
    """The bytes of the live storages of one device and their peak.

    A storage counts from the op that makes it until it is freed.  Freed
    storages are swept out whenever the running sum would set a new peak
    (and every few thousand new storages), so the peak is exact."""

    def __init__(self, device: torch.device):
        self.device = device
        self.refs: dict[int, tuple] = {}
        self.bytes = 0
        self.peak = 0
        self._since_sweep = 0

    def _key(self, t: torch.Tensor):
        if t.device != self.device:
            return None, None
        st = t.untyped_storage()
        return st._cdata, st

    def add(self, t: torch.Tensor) -> None:
        key, st = self._key(t)
        if key is None:
            return
        entry = self.refs.get(key)
        if entry is not None:
            if not entry[0].expired():
                return
            self.bytes -= entry[1]          # the address of a freed one
        n = st.nbytes()
        self.refs[key] = (StorageWeakRef(st), n)
        self.bytes += n
        self._since_sweep += 1
        if self.bytes > self.peak or self._since_sweep > 4096:
            self.sweep()
            self.peak = max(self.peak, self.bytes)

    def sweep(self) -> None:
        self._since_sweep = 0
        dead = [k for k, (ref, _) in self.refs.items() if ref.expired()]
        for k in dead:
            self.bytes -= self.refs.pop(k)[1]


class _TraceMode(TorchDispatchMode):
    """Adds each op's operand and output bytes on the traced device to
    ``hbm_bytes`` (views and allocations excluded) and its new storages
    to the live set."""

    def __init__(self, live: _LiveStorages):
        super().__init__()
        self.live = live
        self.hbm_bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        dev = self.live.device
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (getattr(func, "is_view", False) or func in _NO_TRAFFIC):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs
                                  if t.device == dev)
        for t in outs:
            self.live.add(t)
        return out


def _group_ranks(group) -> list[int]:
    """The global ranks of a DistributedGroup's process group."""
    if group.process_group is None:
        return list(range(dist.get_world_size()))
    return dist.get_process_group_ranks(group.process_group)


class StepTrace:
    """Trace one eager step on ``meta`` tensors::

        with StepTrace(arguments=(state, batch), groups=names) as tr:
            out = step(state, batch)
            tr.set_outputs(out)
        tr.flops, tr.hbm_bytes, tr.collectives, tr.memory()

    ``arguments`` are what the step is given (their storages are live
    before it starts); ``groups`` names the DistributedGroups whose calls
    :meth:`by_group` reports, by name; ``pod_size`` (ranks a pod, 0 for
    one pod) marks the collectives whose group spans pods.  Kernel
    calls on ``meta`` operands are reset at entry and read at exit
    (:attr:`kernels`).
    """

    def __init__(self, *, arguments=(), groups: dict | None = None,
                 pod_size: int = 0):
        from torch.utils.flop_counter import FlopCounterMode
        self.device = torch.device("meta")
        self.groups = dict(groups or {})
        self.pod_size = pod_size
        self.live = _LiveStorages(self.device)
        for t in tensors_of(arguments):
            self.live.add(t)
        self.live.sweep()
        self._arguments = dict(self.live.refs)
        self.argument_bytes = self.live.bytes
        self.live.peak = self.live.bytes
        self._flop_mode = FlopCounterMode(display=False)
        self._mode = _TraceMode(self.live)
        self.collectives: list[CollectiveOp] = []
        self.calls: dict[str, dict] = {
            n: {"calls": {}, "bytes": {}} for n in self.groups}
        self._ranks: dict[int, list[int]] = {}
        self.kernels: dict[str, dict] = {}
        self.flops = 0
        self.hbm_bytes = 0
        self.seconds = 0.0
        self._outputs = ()

    def _observe(self, group, op: str, x: torch.Tensor) -> None:
        if not hasattr(group, "process_group"):
            return                  # a virtual group crosses no wire
        ranks = self._ranks.get(id(group))
        if ranks is None:
            ranks = self._ranks[id(group)] = _group_ranks(group)
        for name, g in self.groups.items():
            if g is group:
                rec = self.calls[name]
                rec["calls"][op] = rec["calls"].get(op, 0) + 1
                rec["bytes"][op] = rec["bytes"].get(op, 0) + _nbytes(x)
        payload = _nbytes(x) * (group.size if op == "all_gather" else 1)
        kind = COLLECTIVE_KINDS[op]
        crosses = bool(self.pod_size) and len(
            {r // self.pod_size for r in ranks}) > 1
        self.collectives.append(CollectiveOp(
            kind=kind, bytes_total=payload, group_size=group.size,
            wire_bytes=_wire_bytes(kind, payload, group.size),
            crosses_pod=crosses, dtype=DTYPE_NAMES.get(x.dtype, str(x.dtype))))

    def set_outputs(self, outputs: Any) -> None:
        """What the step returned (for ``output_bytes`` / ``alias_bytes``)."""
        self._outputs = tensors_of(outputs)

    def __enter__(self) -> "StepTrace":
        from ..core import collectives
        from ..kernels import build
        build.META_CALLS.clear()
        collectives.COLLECTIVE_OBSERVERS.append(self._observe)
        self._t0 = time.perf_counter()
        self._flop_mode.__enter__()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        from ..core import collectives
        from ..kernels import build
        self._mode.__exit__(*exc)
        self._flop_mode.__exit__(*exc)
        self.seconds = time.perf_counter() - self._t0
        collectives.COLLECTIVE_OBSERVERS.remove(self._observe)
        self.kernels = {n: dict(r) for n, r in build.META_CALLS.items()}
        build.META_CALLS.clear()
        self.flops = self._flop_mode.get_total_flops()
        self.hbm_bytes = self._mode.hbm_bytes + sum(
            r["operand_bytes"] + r["output_bytes"]
            for r in self.kernels.values())

    def memory(self) -> dict:
        """The reference's memory keys: bytes of the arguments, of the
        outputs (new storages), of the outputs that alias an argument,
        the peak above the arguments, and their sum."""
        seen, out_b, alias_b = set(), 0, 0
        for t in self._outputs:
            if t.device != self.device:
                continue
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            arg = self._arguments.get(st._cdata)
            if arg is not None and not arg[0].expired():
                alias_b += st.nbytes()
            else:
                out_b += st.nbytes()
        temp = self.live.peak - self.argument_bytes
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": out_b, "temp_bytes": temp,
                "alias_bytes": alias_b,
                "peak_estimate_bytes": self.argument_bytes + temp}

    def by_group(self) -> dict:
        """Calls and bytes (as each group counts them) by named group and
        op: the numbers a real rank's ``calls_by_op`` / ``bytes_by_op``
        hold after the same step."""
        return {n: {"calls": dict(r["calls"]), "bytes": dict(r["bytes"])}
                for n, r in self.calls.items()}

    def wire_breakdown(self) -> dict:
        """Wire bytes by ``kind/dtype/g<size>``, largest first."""
        bd: dict[str, float] = {}
        for o in self.collectives:
            key = f"{o.kind}/{o.dtype}/g{o.group_size}"
            bd[key] = bd.get(key, 0.0) + o.wire_bytes
        return dict(sorted(bd.items(), key=lambda x: -x[1]))
