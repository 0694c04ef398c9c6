"""Training runtime: the Trainer's host loop, admission control and fault
tolerance.

Port of ``repro/runtime/train.py:80-307``.  Each step runs the
:class:`~repro_torch.fabric.Fabric` train step built for the latched
plan — per-rank gradients, bucketed aggregation under the plan, one
optimizer update — and records the loss, the plan signature, the
payload traffic ratio and the step's wall time (ending in a device
synchronize).  With a controller, each step's record goes to it as a
:class:`~repro_torch.fabric.control.Telemetry`, and the controller
latches the plan of the next step; the step runs with cosine
diagnostics while the controller asks for them.

With ``ckpt_dir=`` the Trainer restores the newest checkpoint on start,
saves every ``checkpoint_interval`` steps (and at the end), and on a
:class:`~repro_torch.runtime.fault.SimulatedFailure` restores the last
durable checkpoint, the controller's state with it, and replays the
deterministic data stream (``batch_at``).  A straggler watchdog watches
the step times.

On a fabric over a
:class:`~repro_torch.core.collectives.DistributedGroup` each process is
one rank: it takes its shard of every global batch, rank 0's initial
parameters are broadcast once, every rank runs its own controller on
replicated telemetry (the step time it is given is the slowest rank's),
and only rank 0 logs and writes checkpoints.

On a fabric over a :class:`~repro_torch.core.collectives.ProcessMesh`
(``Fabric(mesh=...)``: the reference's ``shard_map`` over the data axes
with GSPMD over ``"model"``) each rank takes its data index's shard of
the batch; with a model axis above 1 it holds its blocks of the
parameters under the sanitized :func:`~repro_torch.models.transformer.
param_pspecs` and runs the model tensor-parallel over its model group.
With ``TrainerConfig.zero1`` (the default, as in the reference) the
moments are partitioned over the data group (ZeRO-1).  The traffic ratio
is priced on the whole leaves' sizes, and checkpoints hold whole arrays.
On a :class:`~repro_torch.core.collectives.VirtualMesh` (the launcher's
``--mesh W,1`` outside ``torchrun``) the W workers are virtual, in one
process: the specs reach the policies as on a ``ProcessMesh`` of that
shape, and the moments and EF rows stay whole.

:func:`build_train_step` is the reference's legacy step builder: a
throwaway session's step with its partition specs, as a
:class:`~repro_torch.fabric.CompiledStep`.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterator

import torch

from ..checkpoint import (CheckpointManager, load_train_state,
                          train_state_arrays)
from ..checkpoint.manager import MeshLayout
from ..core import (AdmissionPlan, DistributedGroup, GroupRules,
                    ProcessMesh, VirtualGroup, plan_traffic_ratio,
                    resolve_device)
from ..core import spans
from ..core import tree as T
from ..core.buckets import resolve_policies
from ..fabric import CompiledStep, Fabric, TrainState, dp_num_workers
from ..fabric.control import Telemetry, make_controller
from ..fabric.session import _group_extents
from ..models import ModelConfig, Transformer, init_params, loss_fn
from ..models.tp import TensorParallel
from ..models.transformer import param_pspecs
from ..optim import OptState, Optimizer, Zero1, optimizer_state_pspecs
from ..optim.optimizers import _dp_entry
from .shardings import local_shape, sanitize_pspecs
from .fault import (FailureInjector, SimulatedFailure, StepTimer,
                    StragglerWatchdog)

log = logging.getLogger("repro_torch.train")

__all__ = ["TrainState", "Trainer", "TrainerConfig", "build_train_step",
           "dp_num_workers"]


# ---------------------------------------------------------------------------
# step builder (the reference's legacy entry point)
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, mesh, optimizer: Optimizer,
                     plan: AdmissionPlan, params_like: Any, *,
                     dp_axes=("data",), rules: GroupRules | None = None,
                     with_diagnostics: bool = False,
                     loss: Callable | None = None, zero1: bool = True,
                     grad_accum: int = 1,
                     donate: bool = True) -> CompiledStep:
    """The reference's legacy step builder: a throwaway
    :class:`~repro_torch.fabric.Fabric`'s step under ``plan``, with its
    I/O contracts, as a :class:`~repro_torch.fabric.CompiledStep`.

    ``mesh`` is a :class:`~repro_torch.core.ProcessMesh` (the session
    ``Fabric(mesh=mesh)``, partition specs sanitized to its extents,
    ZeRO-1 over its data group when ``zero1`` and the data extent is
    above 1) or a worker group (``Fabric(group=mesh)``, the specs of a
    mesh of its data axes and a model axis of 1, the moments whole; an
    ``int`` W is ``VirtualGroup(W)``).  ``dp_axes`` must be the
    session's data axes (:attr:`~repro_torch.fabric.Fabric.dp_axes`);
    anything else raises.  On a mesh the policies are resolved with the
    specs, as the reference's mesh step resolves them, so a leaf specced
    over ``"model"`` keeps its own launch; a worker group has no model
    axis and buckets it.
    ``params_like`` is the whole parameter tree
    (``init_params(cfg, device="meta")`` will do); only its paths,
    shapes and dtypes are read.  ``loss(params, batch)`` defaults to the
    model's cross entropy (tensor-parallel on a model axis above 1).
    ``donate`` is accepted and has no effect: PyTorch has no buffer
    donation, and the step updates the parameters and moments in place
    anyway.

    The step runs on a :class:`~repro_torch.fabric.TrainState` whose
    ``model`` has ``tree()`` (a :class:`~repro_torch.models.Transformer`
    built on the mesh's model group), its ``opt`` from
    ``optimizer.init(model.tree(), zero=aux["zero"])`` and ``ef`` from
    ``aux["fabric"].init_ef(model.tree(), aux["policies"])``.  ``aux``
    holds the reference's keys (``policies``, ``groups``,
    ``num_workers``, ``ef_specs``, ``pspecs``, ``layout``,
    ``num_launches``) and the port's ``fabric`` and ``zero``.
    """
    del donate
    if isinstance(mesh, ProcessMesh):
        fabric = Fabric(mesh=mesh, rules=rules)
        extents = mesh.extents
    else:
        group = VirtualGroup(mesh) if isinstance(mesh, int) else mesh
        fabric = Fabric(group=group, rules=rules)
        extents = {**dict(zip(fabric.dp_axes, _group_extents(group))),
                   "model": 1}
    dp = fabric.dp_axes
    if ((dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes)) != dp:
        raise ValueError(f"dp_axes {dp_axes} are not the session's data "
                         f"axes {dp}")
    pspecs = sanitize_pspecs(param_pspecs(cfg), params_like, extents)
    on_mesh = fabric.mesh is not None
    opt_specs = optimizer_state_pspecs(
        pspecs, params_like, dp_axes=dp, dp_size=fabric.num_workers,
        zero1=zero1 and on_mesh and mesh.data_size > 1)
    zero, tp, like, policies = None, None, params_like, plan
    if on_mesh:
        if zero1 and mesh.data_size > 1:
            zero = Zero1.from_specs(fabric.group, opt_specs, dp)
        if fabric.tensor_parallel:
            tp = TensorParallel(mesh.model_group)
            # the step plans its layout on this rank's blocks
            like = T.unflatten([
                (path, torch.empty(local_shape(x.shape, spec, extents),
                                   dtype=x.dtype, device="meta"))
                for (path, x), spec in zip(T.flatten(params_like),
                                           T.leaves(pspecs))])
        policies = resolve_policies(like, plan, pspecs=pspecs,
                                    rules=fabric.rules)
    step = fabric.build_step(
        optimizer, policies, like,
        loss or (lambda p, b: loss_fn(p, cfg, b, tp)),
        with_diagnostics=with_diagnostics, grad_accum=grad_accum,
        pspecs=pspecs if on_mesh else None, zero=zero)
    policies = step.policies
    ef_specs = fabric.ef_specs(policies, pspecs)
    state_shardings = TrainState(
        model=pspecs,
        opt=OptState(step=(), mu=opt_specs,
                     nu=opt_specs if optimizer.has_nu else None),
        ef=ef_specs, step=())
    aux = {"policies": policies, "groups": fabric.groups(params_like),
           "num_workers": fabric.num_workers, "ef_specs": ef_specs,
           "pspecs": pspecs, "layout": step.layout,
           "num_launches": (step.layout.num_launches
                            if step.layout is not None
                            else len(T.leaves(params_like))),
           "fabric": fabric, "zero": zero}
    return CompiledStep(step, state_shardings,
                        (_dp_entry(dp),) if dp else (), aux)


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Do two devices name one (``cuda`` is the current card)?"""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


@dataclasses.dataclass
class TrainerConfig:
    checkpoint_interval: int = 100
    checkpoint_keep: int = 3
    log_interval: int = 10
    max_restarts: int = 10
    zero1: bool = True        # ZeRO-1 moments on a ProcessMesh's data group


class Trainer:
    """Host loop with admission control and fault tolerance.

    ``data`` yields (or, through ``batch_at(step)``, replays) global
    batches of numpy arrays; each of the Fabric's ranks takes an equal
    shard.  Admission control is a controller: ``controller=`` (an
    instance or a ``@register_controller`` name) or the one attached to
    the fabric (``fabric.attach_controller(...)``); passing one that
    conflicts with the attached one raises.  ``plan=`` without a
    controller is the static path.  Error-feedback state is built once,
    for the plan latched at :meth:`init_state`, as in the reference.
    ``last_aggregates`` holds the aggregates of the most recent step
    (replicated, one tree) for callers that check them; ``restarts``
    counts the failures recovered from.
    """

    def __init__(self, cfg: ModelConfig, optimizer: Optimizer,
                 data: Iterator[dict], *, tcfg: TrainerConfig | None = None,
                 plan: AdmissionPlan | None = None, controller=None,
                 fabric: Fabric | None = None, ckpt_dir: str | None = None,
                 failure_injector: FailureInjector | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg, self.optimizer, self.data = cfg, optimizer, data
        self.tcfg = tcfg = tcfg or TrainerConfig()
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
        group = fabric.group
        self.distributed = isinstance(group, DistributedGroup)
        if self.distributed and not _same_device(group.device, self.device):
            raise ValueError(f"the fabric's {group!r} holds tensors on "
                             f"{group.device}, the Trainer runs on "
                             f"{self.device}")
        self.mesh = fabric.mesh
        # the whole world: the writer of checkpoints and their barrier
        world = group if self.mesh is None else self.mesh.world
        self._world = world if self.distributed else None
        self._logs = not self.distributed or world.rank() == (0,)
        self.tp = (TensorParallel(self.mesh.model_group)
                   if fabric.tensor_parallel else None)
        self.pspecs = None            # the sanitized specs, on a mesh
        self.zero = None              # the ZeRO-1 partition, on a mesh
        self.failure_injector = failure_injector
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(ckpt_dir,
                                       interval=tcfg.checkpoint_interval,
                                       keep=tcfg.checkpoint_keep,
                                       group=world)
                     if ckpt_dir else None)
        self.state: TrainState | None = None
        self.history: list[dict] = []
        self.last_aggregates = None
        self.restarts = 0
        self._sizes = None
        self._just_restarted = False

    # -- state ----------------------------------------------------------

    def init_state(self) -> TrainState:
        model = Transformer(self.cfg, device=self.device, seed=self.seed,
                            tp=self.tp)
        params = model.tree()
        if self.distributed:
            # one set of parameters for every rank of the data group: its
            # rank 0's
            for p in T.leaves(params):
                self.fabric.group.broadcast(p.detach())
        whole = params
        if self.mesh is not None:
            whole = init_params(self.cfg, device="meta")
            self.pspecs = sanitize_pspecs(param_pspecs(self.cfg), whole,
                                          self.mesh.extents)
            if self.tcfg.zero1 and self.distributed \
                    and self.mesh.data_size > 1:
                dp = self.mesh.data_axes
                self.zero = Zero1.from_specs(
                    self.fabric.group, optimizer_state_pspecs(
                        self.pspecs, whole, dp_axes=dp,
                        dp_size=self.mesh.data_size), dp)
        policies = self.fabric.resolve(params, self._current_plan(),
                                       self.pspecs)
        opt = (self.optimizer.init(params) if self.zero is None
               else self.optimizer.init(params, zero=self.zero))
        self.state = TrainState(model=model, opt=opt,
                                ef=self.fabric.init_ef(params, policies))
        self._sizes = self.fabric.group_sizes(whole)
        return self.state

    def _layout(self) -> MeshLayout | None:
        return (None if self.mesh is None or not self.distributed else
                MeshLayout(self.mesh, self.pspecs if self.tp else None,
                           self.zero))

    def _current_plan(self) -> AdmissionPlan:
        if self.controller is not None:
            return self.controller.plan
        return self.static_plan or AdmissionPlan.fp32_all()

    def _checkpoint_tree(self) -> dict:
        return train_state_arrays(self.state, self.fabric.group,
                                  self._layout())

    def _restore(self) -> bool:
        """Load the newest checkpoint (and the controller's state) into
        the state in place; False when there is none."""
        restored = self.ckpt.restore(controller=self.controller)
        if restored is None:
            return False
        step, arrays, _ = restored
        self.state = load_train_state(self.state, arrays, self.fabric.group,
                                      self._layout())
        self._just_restarted = True
        if self._logs:
            log.info("restored checkpoint at step %d", step)
        return True

    def _batch(self, step: int, it) -> dict:
        with spans.span("trainer.batch"):
            batch = self.data.batch_at(step) \
                if hasattr(self.data, "batch_at") else next(it)
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in batch.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _slowest(self, dt: float) -> float:
        """The step's time as every rank sees it: the slowest rank's
        (one all-reduce over the world under a process group), so that
        every rank's controller decides on the same number."""
        if self._world is None:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.device)
        return float(self._world.all_reduce(t, op="max")[0])

    def step_function(self, plan: AdmissionPlan, *,
                      with_diagnostics: bool = False, grad_accum: int = 1):
        """The fabric's (cached) train step of the current state under
        ``plan``: ``step(state, batch) -> (state, metrics, aggregates)``,
        with this Trainer's partition specs and ZeRO-1 partition on a
        mesh.  The loop runs it; the launch dry-run traces it."""
        model = self.state.model
        mesh_kw = ({} if self.mesh is None else
                   {"pspecs": self.pspecs, "zero": self.zero})
        return self.fabric.step_for(self.optimizer, plan, model.tree(),
                                    model.loss,
                                    with_diagnostics=with_diagnostics,
                                    grad_accum=grad_accum, **mesh_kw)

    # -- loop -----------------------------------------------------------

    def run(self, num_steps: int) -> list[dict]:
        if self.state is None:
            self.init_state()
            if self.ckpt is not None:
                self._restore()
        it = iter(self.data)
        while self.state.step < num_steps:
            try:
                self._run_until(num_steps, it)
            except SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                log.warning("%s -> restart %d (restore + replay)", e,
                            self.restarts)
                self._recover()
        if self.ckpt is not None:
            self.ckpt.maybe_save(self.state.step, self._checkpoint_tree,
                                 force=True, controller=self.controller)
            self.ckpt.wait()
        return self.history

    def _recover(self) -> None:
        """Node-failure recovery: restore the last durable checkpoint,
        with the controller's state (CUSUM statistics, cooldown, the
        admitted plan), or start over from the seed without one."""
        if self.ckpt is None:
            raise RuntimeError("failure without checkpointing enabled")
        if not self._restore():
            self.init_state()
            self._just_restarted = True

    def _run_until(self, num_steps: int, it) -> None:
        while self.state.step < num_steps:
            step = self.state.step
            spans.at_step(step)
            if self.failure_injector is not None:
                self.failure_injector.check(step)
            plan = self._current_plan()
            # the controller owns the calibration window: diagnostics run
            # while it asks for them, so admission can retry until the
            # cosines land
            calibrating = bool(self.controller is not None and getattr(
                self.controller, "wants_diagnostics", False))
            step_fn = self.step_function(plan, with_diagnostics=calibrating)
            batch = self._batch(step, it)
            # the last step's aggregates are a model's worth of memory
            self.last_aggregates = None
            self._sync()
            with StepTimer() as t:
                self.state, metrics, agg = step_fn(self.state, batch)
                self._sync()
            dt = t.duration
            self.watchdog.observe(step, dt)
            self.last_aggregates = agg
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, step_time_s=dt, plan=plan.signature(),
                       traffic_ratio=plan_traffic_ratio(self._sizes, plan))
            self.history.append(rec)
            if self.controller is not None:
                self.controller.observe(Telemetry.from_metrics(
                    step, rec, step_time_s=self._slowest(dt),
                    restart=self._just_restarted))
            self._just_restarted = False
            if self.ckpt is not None:
                self.ckpt.maybe_save(step + 1, self._checkpoint_tree,
                                     extra={"plan": plan.signature()},
                                     controller=self.controller)
            if self._logs and step % self.tcfg.log_interval == 0:
                log.info("step %d loss %.4f traffic %.4f %.3fs plan=%s",
                         step, rec["loss"], rec["traffic_ratio"], dt,
                         plan.signature()[:48])
