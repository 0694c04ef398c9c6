"""ElasticTrainer: the Trainer's control loop over a dynamic worker fleet
(port of ``repro/elastic/trainer.py``).

Virtual workers on one device: ``Fabric(num_workers=W)``, the group's W
workers on a leading axis (the reference's ``vmap`` over a host-local
``Fabric(dp_axes=("w",))``), so per-worker gradients, EF residuals and
votes behave as on a data-parallel mesh while the worker count is free
to change between steps.  Each live worker draws its own stream
(``host_index = worker``); a step's global batch is the live workers'
batches concatenated in view order, which is how
:meth:`~repro_torch.fabric.Fabric.worker_grads` splits it.

Lifecycle on a membership change:

  * graceful ``join``/``leave``: a step-boundary re-plan.  The fleet's
    :class:`~repro_torch.elastic.membership.WorkerView` epoch bumps, the
    session re-binds (``Fabric.bind_membership``), EF residual rows are
    re-seated by worker id (survivors keep theirs, joiners start at
    zero), and the next step is built anew under the ``(W, epoch)`` key:
    a step or bucket layout built for another view is never served;
  * ``crash``: involuntary.  The same view change, then a rollback to
    the last durable checkpoint (parameters, optimizer state, step and
    the controller's state) and a deterministic replay under the
    shrunken fleet; with no checkpoint yet, a re-init from the seed.  EF
    rows are worker-local state and do not survive a crash.

Per-worker step times (the host clock around a step that ends in a
device synchronize, or a fixed nominal time scaled by the active fault
models) feed the :class:`~repro_torch.elastic.detector.StragglerDetector`,
whose statistics ride into
:class:`~repro_torch.fabric.control.Telemetry` for any controller.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Sequence

import torch

from ..checkpoint import (CheckpointManager, load_train_state,
                          train_state_arrays)
from ..core import (AdmissionPlan, GroupRules, plan_traffic_ratio,
                    resolve_device)
from ..core import spans
from ..core import tree as T
from ..fabric import Fabric, TrainState
from ..fabric.control import Telemetry, make_controller
from ..models import ModelConfig, Transformer
from ..optim import Optimizer
from ..runtime.fault import StepTimer
from .detector import StragglerDetector
from .faults import FaultModel, combined_step_time_scale, resolve_faults
from .membership import Membership, MembershipEvent

log = logging.getLogger("repro_torch.elastic")

__all__ = ["ElasticConfig", "ElasticFailure", "ElasticTrainer"]


class ElasticFailure(RuntimeError):
    """A worker crashed: roll back to the last durable checkpoint."""

    def __init__(self, event: MembershipEvent):
        super().__init__(f"worker {event.worker} crashed at step "
                         f"{event.step}")
        self.event = event


@dataclasses.dataclass
class ElasticConfig:
    checkpoint_interval: int = 10
    checkpoint_keep: int = 3
    log_interval: int = 50
    max_restarts: int = 10
    #: None -> the host clock around each step; a float makes per-worker
    #: step times deterministic (nominal seconds scaled by the active
    #: fault models) for reproducible detector and controller runs
    synthetic_step_time_s: float | None = None
    fused: bool = True


def _worker_stream(data: Any, worker: int):
    """A worker's own deterministic stream from one stream template.

    ``data`` is a factory ``worker_id -> stream`` or a dataclass stream
    with a ``host_index`` field (``SyntheticLMStream``): each worker
    draws from its own host slot, so a step's batch depends only on the
    live worker set, never on the fleet's history.
    """
    if callable(data) and not hasattr(data, "batch_at"):
        return data(worker)
    if dataclasses.is_dataclass(data) and hasattr(data, "host_index"):
        return dataclasses.replace(data, host_index=worker)
    raise TypeError(
        "data must be a worker_id -> stream factory or a dataclass "
        "stream with a host_index field (e.g. SyntheticLMStream)")


def _resize_ef(ef: Any, old_workers: Sequence[int],
               new_workers: Sequence[int]) -> Any:
    """Re-seat the per-worker EF rows across a view change, by id."""
    slot = {w: i for i, w in enumerate(old_workers)}

    def leaf(e):
        out = torch.zeros((len(new_workers), *e.shape[1:]), dtype=e.dtype,
                          device=e.device)
        for i, w in enumerate(new_workers):
            if w in slot:
                out[i] = e[slot[w]]
        return out

    return T.map_leaves(leaf, ef)


class ElasticTrainer:
    """Host control loop over an elastic virtual-worker fleet.

    ``membership`` is a :class:`Membership` ledger (or an int for a
    fixed initial fleet); graceful events come from its deterministic
    schedule, involuntary ones from the ``faults`` models (the shapes
    :func:`~repro_torch.elastic.resolve_faults` accepts).  As in the
    Trainer, ``controller=`` (an instance or a registered name) drives
    adaptive plans and ``plan=`` is the static path.  ``loss`` is
    ``loss(params, batch)`` (the model's own by default).
    """

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer, data: Any,
                 membership: Membership | int, *,
                 faults: Sequence = (),
                 controller=None,
                 plan: AdmissionPlan | None = None,
                 rules: GroupRules | None = None,
                 ecfg: ElasticConfig | None = None,
                 ckpt_dir: str | None = None,
                 detector: StragglerDetector | None = None,
                 loss: Callable | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg, self.optimizer, self.data = cfg, optimizer, data
        self.membership = (membership if isinstance(membership, Membership)
                           else Membership(membership))
        self.faults: tuple[FaultModel, ...] = resolve_faults(faults)
        if isinstance(controller, str):
            controller = make_controller(controller)
        self.controller = controller
        self.static_plan = plan
        self.ecfg = ecfg or ElasticConfig()
        self.loss = loss
        self.seed = seed
        self.device = resolve_device(device)
        self.fabric = Fabric(num_workers=self.membership.view.num_workers,
                             rules=rules, fused=self.ecfg.fused)
        self.fabric.bind_membership(self.membership.view)
        if controller is not None:
            self.fabric.attach_controller(controller)
        self.detector = detector or StragglerDetector()
        self.ckpt = (CheckpointManager(
            ckpt_dir, interval=self.ecfg.checkpoint_interval,
            keep=self.ecfg.checkpoint_keep) if ckpt_dir else None)
        self.state: TrainState | None = None
        self.history: list[dict] = []
        self.recoveries: list[dict] = []
        self.restarts = 0
        self.executed_steps = 0
        self.replayed_steps = 0
        self.total_traffic = 0.0
        self.unique_traffic = 0.0
        self._high_water = 0
        self._sizes = None
        self._streams: dict[int, Any] = {}
        self._compiled: dict[tuple, Callable] = {}
        self._just_restarted = False

    # -- state ----------------------------------------------------------

    def init_state(self) -> TrainState:
        """Parameters from the seed, a fresh optimizer state and EF tree
        at step 0."""
        self.state = None              # the old state's memory goes first
        model = Transformer(self.cfg, device=self.device, seed=self.seed)
        params = model.tree()
        self.state = TrainState(model=model, opt=self.optimizer.init(params),
                                ef=self._fresh_ef(params))
        self._sizes = self.fabric.group_sizes(params)
        return self.state

    def _fresh_ef(self, params: Any) -> Any:
        """The full per-worker residual tree, ``(W, *shape)`` float32 rows
        on every leaf: room for any plan the controller may latch later
        (a policy without EF leaves its rows as they are), since elastic
        plans change too often to size EF off the first plan."""
        w = self.membership.view.num_workers
        return T.map_leaves(
            lambda p: torch.zeros((w, *p.shape), dtype=torch.float32,
                                  device=p.device), params)

    def _current_plan(self) -> AdmissionPlan:
        if self.controller is not None:
            return self.controller.plan
        return self.static_plan or AdmissionPlan.fp32_all()

    def _stream(self, worker: int):
        if worker not in self._streams:
            self._streams[worker] = _worker_stream(self.data, worker)
        return self._streams[worker]

    def _batch(self, step: int) -> dict:
        """The live workers' batches concatenated in view order."""
        parts = [self._stream(w).batch_at(step)
                 for w in self.membership.view.workers]
        return {k: torch.cat([torch.as_tensor(p[k]) for p in parts])
                .to(self.device) for k in parts[0]}

    # -- step building --------------------------------------------------

    def _get_step(self, plan: AdmissionPlan, diagnostics: bool):
        # the worker count and the membership epoch in the key: a step
        # built for one view is never served after a re-plan
        key = (plan.signature(), diagnostics,
               self.membership.view.num_workers,
               self.fabric.membership_epoch)
        if key not in self._compiled:
            model = self.state.model
            self._compiled[key] = self.fabric.build_step(
                self.optimizer, plan, model.tree(), self.loss or model.loss,
                with_diagnostics=diagnostics)
        return self._compiled[key]

    # -- membership -----------------------------------------------------

    def _apply_events(self, step: int) -> MembershipEvent | None:
        """Apply every event due at ``step``; returns a crash, if any.

        Graceful scheduled events apply first, then fault-driven ones;
        every view change re-binds the session (the epoch into the step
        key) and re-seats the EF rows by worker id."""
        events = list(self.membership.step_events(step))
        for f in self.faults:
            events.extend(f.membership_events(step))
        if not events:
            return None
        old = self.membership.view
        crash = None
        for ev in events:
            self.membership.apply(ev)
            if ev.kind == "crash":
                crash = ev
        new = self.membership.view
        self.fabric.bind_membership(new)
        if self.state is not None:
            self.state = dataclasses.replace(
                self.state, ef=_resize_ef(self.state.ef, old.workers,
                                          new.workers))
        log.info("membership epoch %d -> %d: %s (W=%d)", old.epoch,
                 new.epoch, [e.to_jsonable() for e in events],
                 new.num_workers)
        return crash

    # -- checkpointing --------------------------------------------------

    def _ckpt_tree(self) -> dict:
        """The durable state: parameters, optimizer state and step, in
        the reference's checkpoint format.  EF rows are worker-local
        (their shapes change with the fleet; a crash loses them)."""
        return train_state_arrays(dataclasses.replace(self.state, ef={}))

    def _restore(self) -> bool:
        restored = self.ckpt.restore(controller=self.controller)
        if restored is None:
            return False
        _, arrays, _ = restored
        # the old EF rows go before the fresh ones are made
        self.state = load_train_state(dataclasses.replace(self.state, ef={}),
                                      arrays)
        self.state = dataclasses.replace(
            self.state, ef=self._fresh_ef(self.state.model.tree()))
        self._just_restarted = True
        return True

    def _recover(self, failure: ElasticFailure) -> None:
        crash_step = failure.event.step
        if self.ckpt is None or not self._restore():
            # no durable checkpoint yet: deterministic re-init from step 0
            self.init_state()
            self._just_restarted = True
        restored_step = self.state.step
        self.recoveries.append({
            "crash_step": crash_step,
            "restored_step": restored_step,
            "steps_to_recover": crash_step - restored_step,
            "epoch": self.membership.view.epoch,
            "num_workers": self.membership.view.num_workers,
        })
        log.warning("recovered from %s: rolled back %d steps (restart %d)",
                    failure, crash_step - restored_step, self.restarts)

    # -- loop -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int) -> list[dict]:
        if self.state is None:
            self.init_state()
            if self.ckpt is not None and self._restore():
                log.info("restored checkpoint at step %d", self.state.step)
        while self.state.step < num_steps:
            try:
                self._run_until(num_steps)
            except ElasticFailure as e:
                self.restarts += 1
                if self.restarts > self.ecfg.max_restarts:
                    raise
                self._recover(e)
        if self.ckpt is not None:
            self.ckpt.maybe_save(self.state.step, self._ckpt_tree,
                                 force=True, controller=self.controller)
            self.ckpt.wait()
        return self.history

    def _run_until(self, num_steps: int) -> None:
        while self.state.step < num_steps:
            step = self.state.step
            spans.at_step(step)
            crash = self._apply_events(step)
            if crash is not None:
                raise ElasticFailure(crash)
            view = self.membership.view

            plan = self._current_plan()
            calibrating = bool(self.controller is not None and getattr(
                self.controller, "wants_diagnostics", False))
            step_fn = self._get_step(plan, calibrating)
            batch = self._batch(step)

            self._sync()
            with StepTimer() as t:
                self.state, metrics, _ = step_fn(self.state, batch)
                self._sync()
            # the session's step also reports the aggregate's norm; the
            # reference's elastic step does not
            metrics.pop("agg_norm", None)
            metrics = {k: float(v) for k, v in metrics.items()}

            self.executed_steps += 1
            replay = step < self._high_water
            if replay:
                self.replayed_steps += 1
            self._high_water = max(self._high_water, step + 1)

            base = (self.ecfg.synthetic_step_time_s
                    if self.ecfg.synthetic_step_time_s is not None
                    else t.duration)
            times = {w: base * combined_step_time_scale(self.faults, step, w)
                     for w in view.workers}
            stats = self.detector.observe(step, times)

            ratio = plan_traffic_ratio(self._sizes, plan)
            self.total_traffic += ratio
            if not replay:
                self.unique_traffic += ratio
            metrics.update(step=step, plan=plan.signature(),
                           traffic_ratio=ratio,
                           step_time_s=max(times.values()),
                           num_workers=view.num_workers,
                           membership_epoch=view.epoch,
                           stragglers=stats.stragglers)
            self.history.append(metrics)

            if self.controller is not None:
                telemetry = dataclasses.replace(
                    Telemetry.from_metrics(step, metrics,
                                           step_time_s=max(times.values()),
                                           restart=self._just_restarted),
                    worker_step_times=times, stragglers=stats.stragglers,
                    membership_epoch=view.epoch)
                self._just_restarted = False
                self.controller.observe(telemetry)

            if self.ckpt is not None:
                self.ckpt.maybe_save(
                    step + 1, self._ckpt_tree,
                    extra={"plan": plan.signature(),
                           "membership": view.to_jsonable()},
                    controller=self.controller)
            if step % self.ecfg.log_interval == 0:
                log.info("step %d loss %.4f W=%d epoch=%d plan=%s", step,
                         metrics["loss"], view.num_workers, view.epoch,
                         plan.signature()[:48])

    # -- reporting ------------------------------------------------------

    @property
    def traffic_overhead(self) -> float:
        """Executed over ideal gradient traffic (1.0 = no replay waste)."""
        return (self.total_traffic / self.unique_traffic
                if self.unique_traffic > 0 else 1.0)

    def report(self) -> dict:
        return {
            "steps": self._high_water,
            "executed_steps": self.executed_steps,
            "replayed_steps": self.replayed_steps,
            "traffic_overhead": self.traffic_overhead,
            "restarts": self.restarts,
            "recoveries": list(self.recoveries),
            "final_view": self.membership.view.to_jsonable(),
            "compiled_steps": len(self._compiled),
        }
