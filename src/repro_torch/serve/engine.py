"""ServeEngine: continuous-batching decode over the paged KV cache.

Port of ``repro/serve/engine.py``.  One engine step = policy-ordered
admission and prefill of newly seated requests, then one *batched*
decode in which every active request advances a token at its own depth
(the vector-position path of :func:`repro_torch.models.decode_step`).
Between the logical block tables and the dense cache the decode step
reads, the engine gathers and scatters through the KV codec
(:mod:`repro_torch.serve.cache`) on its device, so every step's fabric
traffic (gather, scatter, spill and fetch of preempted state) is
codec-priced and recorded in a :class:`StepRecord`: element counts and
bytes as the reference counts them.

Determinism contract (``tests/test_torch_serve.py`` on the CPU, the
card tests and ``chip_smoke.py`` run T on the card): with the lossless
``fp32`` KV codec, each request's logits are bit-identical to serving
it alone at the same ``max_batch``.  Continuous batching, paging,
preemption and CXL spill round trips do not touch the numerics: every
decode runs at the shapes ``max_batch`` fixes, each row from its own
cache row (:func:`repro_torch.models.layers.attn_decode`), and
prefill runs one request at a time.  The per-step records replay
through :mod:`repro_torch.sim` via :meth:`ServeEngine.simulate`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..models import ModelConfig, init_cache, init_params
from ..runtime.serve import build_cached_prefill, build_serve_step
from ..sim.trace import simulate_launches, timeline_launch_specs
from .blocks import NoFreeBlocks
from .cache import PagedKVCache
from .scheduler import Request, RequestState, Scheduler

#: families whose decode state is a sequence-indexed KV cache the block
#: pager can address; SSM/hybrid state and encoder cross-caches are not
#: token-paged.
PAGEABLE_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """Traffic and scheduling facts of one engine step."""
    step: int
    active: tuple               # rids that decoded this step
    admitted: tuple
    preempted: tuple
    finished: tuple
    new_tokens: int             # tokens sampled (prefill + decode)
    n_elements: int             # KV elements gathered + scattered
    wire_bytes: float           # codec-priced gather+scatter+spill+fetch
    blocks_in_use: int
    utilization: float          # of the block pool, after this step

    def to_jsonable(self) -> dict:
        d = dataclasses.asdict(self)
        for key in ("active", "admitted", "preempted", "finished"):
            d[key] = list(d[key])
        return d


@dataclasses.dataclass(frozen=True)
class DecodeTimeline:
    """The engine's step history, replayable through ``repro_torch.sim``."""
    steps: tuple                # tuple[StepRecord]
    kv_codec: str

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def total_new_tokens(self) -> int:
        return sum(s.new_tokens for s in self.steps)

    @property
    def total_wire_bytes(self) -> float:
        return sum(s.wire_bytes for s in self.steps)

    @property
    def total_preemptions(self) -> int:
        return sum(len(s.preempted) for s in self.steps)

    def launch_specs(self, *, step_compute_s: float = 0.0,
                     schedule: str = "paged_kv"):
        """One fabric launch per step (KV movement of that step)."""
        return timeline_launch_specs(
            [{"name": f"decode:{s.step}", "n_elements": s.n_elements,
              "wire_bytes": s.wire_bytes, "ready_s": s.step * step_compute_s}
             for s in self.steps],
            mode=self.kv_codec, schedule=schedule)

    def to_jsonable(self) -> dict:
        return {"kv_codec": self.kv_codec,
                "num_steps": self.num_steps,
                "total_new_tokens": self.total_new_tokens,
                "total_wire_bytes": self.total_wire_bytes,
                "total_preemptions": self.total_preemptions,
                "steps": [s.to_jsonable() for s in self.steps]}


class ServeEngine:
    """Continuous-batching serving engine over a paged, codec-priced
    KV cache.

    ``max_batch`` fixes the decode width; requests are seated into its
    slots as they arrive and leave as they finish, so the batch changes
    every step.  ``num_blocks`` x ``block_size`` bounds resident KV;
    running out spills preempted (cold) state to the modeled CXL tier,
    then preempts.  ``params`` is a parameter tree on ``device`` (by
    default the port's own initialisation from ``seed``);
    ``cache_dtype`` is the pool's and the dense decode cache's dtype
    (float32, as the reference's default).  With ``collect_logits`` the
    engine keeps each request's logits rows, on the host, in
    ``logits[rid]``.
    """

    def __init__(self, cfg: ModelConfig, params=None, *, max_batch: int = 4,
                 max_seq: int = 128, num_blocks: int = 64,
                 block_size: int = 16, kv_codec: str = "fp32",
                 policy: Any = "fcfs", cache_dtype=torch.float32,
                 seed: int = 0, collect_logits: bool = False,
                 device="cuda"):
        if cfg.family not in PAGEABLE_FAMILIES:
            raise ValueError(
                f"family {cfg.family!r} is not servable with a paged KV "
                f"cache (supported: {', '.join(PAGEABLE_FAMILIES)}); "
                f"SSM/hybrid recurrent state and encoder cross-caches are "
                f"not token-paged")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else init_params(
            cfg, generator=torch.Generator(device=self.device)
            .manual_seed(seed), device=self.device)
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq)
        self.cache_dtype = cache_dtype
        self.cache = PagedKVCache(cfg, num_blocks=num_blocks,
                                  block_size=block_size, kv_codec=kv_codec,
                                  dtype=cache_dtype, device=self.device)
        self.scheduler = Scheduler(max_batch=max_batch, policy=policy)
        # each call gets a fresh cache, so both steps write in place
        self._prefill = build_cached_prefill(cfg, donate=True)
        self._step, _ = build_serve_step(cfg, batch=self.max_batch,
                                         max_seq=self.max_seq, donate=True)
        self.requests: dict[int, Request] = {}
        self.records: list[StepRecord] = []
        self.step_index = 0
        self.collect_logits = collect_logits
        self.logits: dict[int, list] = {}
        self._next_rid = 0
        self._tick = 0

    # -- submission -------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               arrival_step: int = 0) -> int:
        """Queue a request; returns its rid."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) + int(max_new_tokens) > self.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + budget ({max_new_tokens}) "
                f"exceeds max_seq={self.max_seq}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      arrival_step=int(arrival_step))
        self.requests[rid] = req
        self.scheduler.add(req)
        return rid

    # -- one engine step --------------------------------------------------

    def step(self) -> StepRecord:
        """Admit, prefill, batched-decode one token, scatter, sample."""
        now = self.step_index
        admitted: list[int] = []
        preempted: list[int] = []
        finished: list[int] = []
        new_tokens = 0
        base_elems = (self.cache.gathered_elements
                      + self.cache.scattered_elements)
        base_bytes = (self.cache.gathered_bytes + self.cache.scattered_bytes
                      + self.cache.tier.spilled_bytes
                      + self.cache.tier.fetched_bytes)

        # 1. admission (+ prefill of never-seen prompts)
        for req in self.scheduler.admissible(now):
            if not self._admit(req):
                break                     # no room this step; keep order
            admitted.append(req.rid)
            if not req.prefilled:
                self._run_prefill(req)
                new_tokens += 1
            if req.done:                  # budget met at prefill already
                self._finish(req)
                finished.append(req.rid)

        # 2. grow tables for this step's writes; preempt under pressure
        for req in list(self.scheduler.running):
            while req.slot is not None:
                try:
                    self.cache.ensure_capacity(req.rid,
                                               req.tokens_in_cache + 1)
                    break
                except NoFreeBlocks:
                    victim = self.scheduler.preempt(exclude=req)
                    if victim is None:
                        raise RuntimeError(
                            "KV pool too small for a single request")
                    self.cache.deactivate(victim.rid, self._next_tick())
                    preempted.append(victim.rid)

        # 3. one batched decode over every seated request
        active = sorted(self.scheduler.running, key=lambda r: r.slot)
        if active:
            logits = self._decode(active)
            # one host read for the step: the greedy tokens, and the rows
            nxt = logits.argmax(dim=-1).tolist()
            rows = logits.cpu() if self.collect_logits else None
            for req in active:
                req.tokens_in_cache += 1
                if self.collect_logits:
                    self.logits[req.rid].append(rows[req.slot])
                req.outputs.append(nxt[req.slot])
                req.pending_token = nxt[req.slot]
                new_tokens += 1
                if req.done or req.total_len >= self.max_seq:
                    self._finish(req)
                    finished.append(req.rid)

        rec = StepRecord(
            step=now,
            active=tuple(r.rid for r in active),
            admitted=tuple(admitted), preempted=tuple(preempted),
            finished=tuple(finished), new_tokens=new_tokens,
            n_elements=(self.cache.gathered_elements
                        + self.cache.scattered_elements - base_elems),
            wire_bytes=(self.cache.gathered_bytes
                        + self.cache.scattered_bytes
                        + self.cache.tier.spilled_bytes
                        + self.cache.tier.fetched_bytes - base_bytes),
            blocks_in_use=self.cache.blocks_in_use,
            utilization=self.cache.utilization())
        self.records.append(rec)
        self.step_index += 1
        return rec

    # -- driving loops ----------------------------------------------------

    def run(self, max_steps: int = 10_000) -> DecodeTimeline:
        """Step until every submitted request finishes."""
        while any(r.state is not RequestState.FINISHED
                  for r in self.requests.values()):
            if self.step_index >= max_steps:
                raise RuntimeError(f"serving did not drain in "
                                   f"{max_steps} steps")
            self.step()
        return self.timeline()

    def serve(self, trace: Sequence[Any],
              max_steps: int = 10_000) -> dict[int, list[int]]:
        """Submit a whole request trace, run it dry, return outputs.

        ``trace`` entries are mappings with ``prompt`` /
        ``max_new_tokens`` / optional ``arrival_step``.
        """
        rids = [self.submit(e["prompt"], e["max_new_tokens"],
                            e.get("arrival_step", 0))
                for e in map(dict, trace)]
        self.run(max_steps=max_steps)
        return {rid: list(self.requests[rid].outputs) for rid in rids}

    def timeline(self) -> DecodeTimeline:
        return DecodeTimeline(steps=tuple(self.records),
                              kv_codec=self.cache.codec.name)

    def simulate(self, timeline: Optional[DecodeTimeline] = None, *,
                 topology: Any = "cxl_direct", step_compute_s: float = 1e-3,
                 num_workers: int = 1, **topology_kwargs):
        """Replay the decode timeline's KV traffic through
        ``repro_torch.sim``.

        Each engine step becomes one launch carrying that step's
        codec-priced gather / scatter / spill bytes, ready when the step's
        model forward finishes (``step * step_compute_s``); the returned
        :class:`~repro_torch.sim.SimReport` gives queueing and exposure of
        the serving datapath on the chosen topology, under the
        reference's modeled constants.
        """
        tl = timeline if timeline is not None else self.timeline()
        specs = tl.launch_specs(step_compute_s=step_compute_s)
        return simulate_launches(
            specs, num_workers, topology=topology, datapath=None,
            compute_time_s=tl.num_steps * step_compute_s, **topology_kwargs)

    # -- internals --------------------------------------------------------

    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _admit(self, req: Request) -> bool:
        """Seat one waiting request; False when it cannot fit right now.

        Admission never preempts (that privilege belongs to requests
        already decoding) but it may spill *cold* blocks via the
        allocator's eviction path.
        """
        self.scheduler.admit(req)
        rid = req.rid
        if rid not in self.cache:
            self.cache.add_request(rid)
            if self.collect_logits:
                self.logits[rid] = []
        try:
            if req.prefilled:
                if not self.cache.activate(rid, self._next_tick()):
                    raise NoFreeBlocks(f"cannot resume request {rid}")
            else:
                self.cache.ensure_capacity(rid, len(req.prompt))
        except NoFreeBlocks:
            self._bounce(req)
            return False
        req.state = RequestState.DECODE
        return True

    def _bounce(self, req: Request) -> None:
        """Undo a failed admission: back to waiting, blocks cold."""
        self.scheduler._release_slot(req)
        req.state = RequestState.WAITING
        self.scheduler.waiting.append(req)
        self.cache.deactivate(req.rid, self._next_tick())

    def _run_prefill(self, req: Request) -> None:
        """Fill the prompt KV pages and sample the first token."""
        plen = len(req.prompt)
        tokens = torch.zeros((1, self.max_seq), dtype=torch.int64)
        tokens[0, :plen] = torch.tensor(req.prompt)
        cache0 = init_cache(self.cfg, 1, self.max_seq,
                            dtype=self.cache_dtype, device=self.device)
        logits, filled = self._prefill(self.params, tokens.to(self.device),
                                       plen, cache0)
        self.cache.write_prompt(req.rid, filled["k"][:, 0, :plen],
                                filled["v"][:, 0, :plen])
        row = logits[0]
        if self.collect_logits:
            self.logits[req.rid].append(row.cpu())
        first = int(row.argmax())
        req.outputs.append(first)
        req.pending_token = first
        req.tokens_in_cache = plen
        req.prefilled = True

    def _decode(self, active: Sequence[Request]) -> torch.Tensor:
        """Gather pages -> one vector-position decode -> scatter back."""
        cfg = self.cfg
        shape = (cfg.num_layers, self.max_batch, self.max_seq,
                 cfg.num_kv_heads, cfg.hd)
        dense_k = torch.zeros(shape, dtype=self.cache_dtype,
                              device=self.device)
        dense_v = torch.zeros(shape, dtype=self.cache_dtype,
                              device=self.device)
        tokens = torch.zeros((self.max_batch, 1), dtype=torch.int64)
        positions = torch.zeros((self.max_batch,), dtype=torch.int64)
        for req in active:
            self.cache.gather_into(req.rid, dense_k[:, req.slot],
                                   dense_v[:, req.slot])
            tokens[req.slot, 0] = req.pending_token
            positions[req.slot] = req.tokens_in_cache
        logits, new_cache = self._step(
            self.params, tokens.to(self.device),
            {"k": dense_k, "v": dense_v}, positions.to(self.device))
        for req in active:
            pos = req.tokens_in_cache
            self.cache.write_token(req.rid, pos,
                                   new_cache["k"][:, req.slot, pos],
                                   new_cache["v"][:, req.slot, pos])
        return logits

    def _finish(self, req: Request) -> None:
        self.scheduler.finish(req)
        self.cache.release(req.rid)
