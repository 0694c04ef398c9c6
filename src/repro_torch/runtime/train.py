"""Training runtime: the Trainer's static-plan loop.

Port of ``repro/runtime/train.py`` (the ``plan=`` path of ``Trainer``).
Each step runs the :class:`~repro_torch.fabric.Fabric` train step —
per-worker gradients, bucketed aggregation under the admitted plan, one
optimizer update — and records the loss, the plan signature, the payload
traffic ratio and the step's wall time (ending in a device synchronize).
The admission controllers, checkpointing and failure injection are still
to port (ROADMAP queue 1 items 4-5).
"""
from __future__ import annotations

import logging
import time
from typing import Iterator

import torch

from ..core import AdmissionPlan, plan_traffic_ratio, resolve_device
from ..fabric import Fabric, TrainState
from ..models import ModelConfig, Transformer
from ..optim import Optimizer

log = logging.getLogger("repro_torch.train")

__all__ = ["Trainer"]

LOG_INTERVAL = 10           # steps between log lines


class Trainer:
    """Host loop over a static admission plan.

    ``data`` yields (or, through ``batch_at(step)``, replays) global
    batches of numpy arrays; the Fabric's workers each take an equal
    shard.  ``last_aggregates`` holds the aggregates of the most recent
    step (replicated, one tree) for callers that check them.
    """

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 data: Iterator[dict], *, plan: AdmissionPlan | None = None,
                 fabric: Fabric | None = None, seed: int = 0,
                 device="cuda"):
        self.cfg, self.optimizer, self.data = cfg, optimizer, data
        self.plan = plan or AdmissionPlan.fp32_all()
        self.fabric = fabric or Fabric()
        self.seed = seed
        self.device = resolve_device(device)
        self.state: TrainState | None = None
        self.history: list[dict] = []
        self.last_aggregates = None
        self._step_fn = None
        self._sizes = None

    def init_state(self) -> TrainState:
        model = Transformer(self.cfg, device=self.device, seed=self.seed)
        params = model.tree()
        policies = self.fabric.resolve(params, self.plan)
        self.state = TrainState(model=model,
                                opt=self.optimizer.init(params),
                                ef=self.fabric.init_ef(params, policies))
        self._sizes = self.fabric.group_sizes(params)
        self._step_fn = self.fabric.build_step(self.optimizer, self.plan,
                                               params, model.loss)
        return self.state

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
            batch = self._batch(step, it)
            self._sync()
            t0 = time.perf_counter()
            self.state, metrics, agg = self._step_fn(self.state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            self.last_aggregates = agg
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt,
                       plan=self.plan.signature(),
                       traffic_ratio=plan_traffic_ratio(self._sizes,
                                                        self.plan))
            self.history.append(rec)
            if step % LOG_INTERVAL == 0:
                log.info("step %d loss %.4f traffic %.4f %.3fs", step,
                         rec["loss"], rec["traffic_ratio"], dt)
        return self.history
