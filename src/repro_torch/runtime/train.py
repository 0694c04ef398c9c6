"""Training runtime: the Trainer's host loop and its admission control.

Port of ``repro/runtime/train.py`` (the ``Trainer`` with its ``plan=``
and ``controller=`` paths).  Each step runs the
:class:`~repro_torch.fabric.Fabric` train step built for the latched
plan — per-worker gradients, bucketed aggregation under the plan, one
optimizer update — and records the loss, the plan signature, the
payload traffic ratio and the step's wall time (ending in a device
synchronize).  With a controller, each step's record goes to it as a
:class:`~repro_torch.fabric.control.Telemetry`, and the controller
latches the plan of the next step; the step runs with cosine
diagnostics while the controller asks for them.  Checkpointing and
failure injection are still to port (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import logging
import time
from typing import Iterator

import torch

from ..core import AdmissionPlan, plan_traffic_ratio, resolve_device
from ..fabric import Fabric, TrainState
from ..fabric.control import Telemetry, make_controller
from ..models import ModelConfig, Transformer
from ..optim import Optimizer

log = logging.getLogger("repro_torch.train")

__all__ = ["Trainer"]

LOG_INTERVAL = 10           # steps between log lines


class Trainer:
    """Host loop with admission control.

    ``data`` yields (or, through ``batch_at(step)``, replays) global
    batches of numpy arrays; the Fabric's workers each take an equal
    shard.  Admission control is a controller: ``controller=`` (an
    instance or a ``@register_controller`` name) or the one attached to
    the fabric (``fabric.attach_controller(...)``); passing one that
    conflicts with the attached one raises.  ``plan=`` without a
    controller is the static path.  Error-feedback state is built once,
    for the plan latched at :meth:`init_state`, as in the reference.
    ``last_aggregates`` holds the aggregates of the most recent step
    (replicated, one tree) for callers that check them.
    """

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 data: Iterator[dict], *, plan: AdmissionPlan | None = None,
                 controller=None, fabric: Fabric | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg, self.optimizer, self.data = cfg, optimizer, data
        self.fabric = fabric = fabric or Fabric()
        if isinstance(controller, str):
            controller = make_controller(controller)
        if controller is None:
            controller = fabric.controller
        elif fabric.controller is not None \
                and fabric.controller is not controller:
            raise ValueError("controller argument conflicts with the "
                             "controller already attached to this fabric")
        else:
            fabric.attach_controller(controller)
        self.controller = controller
        self.static_plan = plan
        self.seed = seed
        self.device = resolve_device(device)
        self.state: TrainState | None = None
        self.history: list[dict] = []
        self.last_aggregates = None
        self._sizes = None

    def init_state(self) -> TrainState:
        model = Transformer(self.cfg, device=self.device, seed=self.seed)
        params = model.tree()
        policies = self.fabric.resolve(params, self._current_plan())
        self.state = TrainState(model=model,
                                opt=self.optimizer.init(params),
                                ef=self.fabric.init_ef(params, policies))
        self._sizes = self.fabric.group_sizes(params)
        return self.state

    def _current_plan(self) -> AdmissionPlan:
        if self.controller is not None:
            return self.controller.plan
        return self.static_plan or AdmissionPlan.fp32_all()

    def _batch(self, step: int, it) -> dict:
        batch = self.data.batch_at(step) if hasattr(self.data, "batch_at") \
            else next(it)
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int) -> list[dict]:
        if self.state is None:
            self.init_state()
        it = iter(self.data)
        while self.state.step < num_steps:
            step = self.state.step
            plan = self._current_plan()
            # the controller owns the calibration window: diagnostics run
            # while it asks for them, so admission can retry until the
            # cosines land
            calibrating = bool(self.controller is not None and getattr(
                self.controller, "wants_diagnostics", False))
            model = self.state.model
            step_fn = self.fabric.step_for(self.optimizer, plan,
                                           model.tree(), model.loss,
                                           with_diagnostics=calibrating)
            batch = self._batch(step, it)
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics, agg = step_fn(self.state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.last_aggregates = agg
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt, plan=plan.signature(),
                       traffic_ratio=plan_traffic_ratio(self._sizes, plan))
            self.history.append(rec)
            if self.controller is not None:
                self.controller.observe(
                    Telemetry.from_metrics(step, rec, step_time_s=dt))
            if step % LOG_INTERVAL == 0:
                log.info("step %d loss %.4f traffic %.4f %.3fs", step,
                         rec["loss"], rec["traffic_ratio"], dt)
        return self.history
