"""Continuous-batching request scheduler: lifecycle, admission, preemption.

Port of ``repro/serve/scheduler.py`` (plain Python).

Requests move through ``waiting -> prefill -> decode -> finished``;
preemption sends a decoding request back to ``waiting`` (its KV blocks
turn cold, see :mod:`repro_torch.serve.evictor`) and a later admission resumes
it where it left off.  *Which* request is admitted next and *which* one
is preempted under block pressure is a pluggable
:class:`SchedulingPolicy`, registered through the same generic
:class:`repro_torch.core.registry.Registry` helper as the codec / schedule /
controller / topology seams:

    from repro_torch.serve import register_policy

    @register_policy("my_policy")
    class MyPolicy:
        name = "my_policy"
        def admission_order(self, waiting): ...
        def preemption_victim(self, running): ...
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Sequence

from ..core.registry import Registry


class RequestState(enum.Enum):
    WAITING = "waiting"      # queued (new, or preempted awaiting resume)
    PREFILL = "prefill"      # prompt KV being built this step
    DECODE = "decode"        # holds a batch slot, generating
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One serving request and its decode-side bookkeeping."""
    rid: int
    prompt: list
    max_new_tokens: int
    arrival_step: int = 0
    state: RequestState = RequestState.WAITING
    outputs: list = dataclasses.field(default_factory=list)
    tokens_in_cache: int = 0        # positions written to the paged cache
    pending_token: Optional[int] = None   # sampled, not yet fed
    slot: Optional[int] = None      # batch row while decoding
    preemptions: int = 0
    prefilled: bool = False

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.outputs)

    @property
    def done(self) -> bool:
        return len(self.outputs) >= self.max_new_tokens

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.outputs)


# ---------------------------------------------------------------------------
# policy registry
# ---------------------------------------------------------------------------

def _prepare_policy(obj: Any, keys):
    return obj() if isinstance(obj, type) else obj


_POLICIES = Registry("serve policy", key_fn=str, prepare=_prepare_policy,
                     register_hint="@register_policy({key!r})")


def register_policy(name: str, *aliases: str, override: bool = False):
    """Class/instance decorator registering a scheduling policy."""
    return _POLICIES.register(name, *aliases, override=override)


def unregister_policy(name: str) -> None:
    _POLICIES.unregister(name)


def get_policy(name: Any):
    """Resolve a policy by registered name (or pass an instance through)."""
    if not isinstance(name, str):
        return name
    return _POLICIES.get(name)


def available_policies() -> tuple[str, ...]:
    return _POLICIES.available()


@register_policy("fcfs")
class FcfsPolicy:
    """First come, first served; under pressure the youngest request
    yields (its lost work is the cheapest to redo)."""

    name = "fcfs"

    def admission_order(self, waiting: Sequence[Request]) -> list[Request]:
        return sorted(waiting, key=lambda r: (r.arrival_step, r.rid))

    def preemption_victim(self, running: Sequence[Request]) -> Request:
        return max(running, key=lambda r: (r.arrival_step, r.rid))


@register_policy("sjf")
class SjfPolicy:
    """Shortest job first (by remaining token budget); the longest
    remaining job yields under pressure."""

    name = "sjf"

    def admission_order(self, waiting: Sequence[Request]) -> list[Request]:
        return sorted(waiting,
                      key=lambda r: (r.remaining, r.arrival_step, r.rid))

    def preemption_victim(self, running: Sequence[Request]) -> Request:
        return max(running, key=lambda r: (r.remaining, -r.arrival_step,
                                           -r.rid))


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """Tracks the waiting queue and the occupied batch slots."""

    def __init__(self, *, max_batch: int, policy: Any = "fcfs"):
        self.max_batch = int(max_batch)
        self.policy = get_policy(policy)
        self.waiting: list[Request] = []
        self.running: list[Request] = []
        self._slots: list[Optional[Request]] = [None] * self.max_batch
        self.preemptions = 0

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def add(self, request: Request) -> None:
        request.state = RequestState.WAITING
        self.waiting.append(request)

    def admissible(self, now_step: int) -> list[Request]:
        """Waiting requests that have arrived, in policy order, capped
        at the number of free slots."""
        arrived = [r for r in self.waiting if r.arrival_step <= now_step]
        free = self.max_batch - len(self.running)
        return self.policy.admission_order(arrived)[:max(0, free)]

    def admit(self, request: Request) -> int:
        """Seat a waiting request in a free slot; returns the slot."""
        slot = self._slots.index(None)
        self._slots[slot] = request
        self.waiting.remove(request)
        self.running.append(request)
        request.slot = slot
        request.state = (RequestState.DECODE if request.prefilled
                         else RequestState.PREFILL)
        return slot

    def preempt(self, exclude: Optional[Request] = None) -> Optional[Request]:
        """Evict one running request back to the waiting queue.

        ``exclude`` protects the request whose allocation triggered the
        squeeze (preempting it would not free anything it can use this
        step) unless it is the only one running.
        """
        candidates = [r for r in self.running if r is not exclude]
        if not candidates:
            candidates = list(self.running)
        if not candidates:
            return None
        victim = self.policy.preemption_victim(candidates)
        self._release_slot(victim)
        victim.state = RequestState.WAITING
        victim.preemptions += 1
        self.waiting.append(victim)
        self.preemptions += 1
        return victim

    def finish(self, request: Request) -> None:
        self._release_slot(request)
        request.state = RequestState.FINISHED

    def _release_slot(self, request: Request) -> None:
        self._slots[request.slot] = None
        self.running.remove(request)
        request.slot = None
