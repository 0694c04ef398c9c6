"""Virtual-worker convergence experiments (paper Sections 7 and 8).

Port of ``repro/core/experiments.py``.  The paper's protocol: split each
minibatch into W = 8 virtual workers, apply the selected aggregation rule
to the per-worker gradients, and feed the aggregate to an unmodified
optimizer.  On synthetic cluster-classification tasks the easy task
(the CIFAR-10 analogue) tolerates full-path low-bit aggregation, the
fine-grained hard task (the CIFAR-100 analogue) rejects it, and
layer-aware admission (low-bit backbone + FP32 head) recovers most of
the gap: the paper's central boundary result.

Plain functions on tensors, on ``device`` (CUDA unless the caller asks
for the CPU), with every random draw from one ``torch.Generator`` seeded
by ``seed``.  The reference draws its initial weights and its
degradation noise with ``jax.random``, which this package cannot
reproduce: ``run_training(params=..., noise=...)`` takes them from the
caller instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from ..data import ClassificationTask, make_cluster_task
from . import tree as T
from .device import resolve_device
from .diagnostics import group_cosines_from_workers
from .lowbit import signum


# ---------------------------------------------------------------------------
# small MLP classifier (backbone + head, mirroring the paper's split)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, dim: int, hidden: int,
             classes: int) -> dict:
    """Random MLP weights on the generator's device."""
    dev = gen.device

    def s(a, b):
        return torch.randn((a, b), generator=gen, device=dev) \
            * (1.0 / np.sqrt(a))

    zeros = lambda n: torch.zeros(n, device=dev)  # noqa: E731
    return {
        "backbone": {"w1": s(dim, hidden), "b1": zeros(hidden),
                     "w2": s(hidden, hidden), "b2": zeros(hidden)},
        "head": {"w": s(hidden, classes), "b": zeros(classes)},
    }


def mlp_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["backbone"]["w1"] + p["backbone"]["b1"])
    h = torch.relu(h @ p["backbone"]["w2"] + p["backbone"]["b2"])
    return h @ p["head"]["w"] + p["head"]["b"]


def _ce(p: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lg = mlp_logits(p, x)
    return torch.mean(torch.logsumexp(lg, -1)
                      - torch.gather(lg, 1, y[:, None])[:, 0])


# ---------------------------------------------------------------------------
# aggregation rules over stacked (W, ...) worker grads
# ---------------------------------------------------------------------------

def agg_fp32(g):
    return torch.mean(g, dim=0)


def agg_gbinary(g):
    w = g.shape[0]
    return torch.sign(2 * torch.sum(g > 0, dim=0).to(torch.float32) - w)


def agg_gternary(g):
    u = agg_gbinary(g)
    gate = ((torch.arange(u.numel(), device=u.device) % 3) != 2)
    return u * gate.to(torch.float32).reshape(u.shape)


def agg_majority_sign(g):
    """MajoritySignSGD: the communication-comparable software baseline."""
    return agg_gbinary(g)


def agg_sign_of_mean(g):
    """SignOfMean: the sign after the FP32 mean (optimizer reference)."""
    return signum(torch.mean(g, dim=0))


RULES: dict[str, Callable] = {
    "fp32": agg_fp32,
    "gbinary": agg_gbinary,
    "gternary": agg_gternary,
    "majority_sign_sgd": agg_majority_sign,
    "sign_of_mean": agg_sign_of_mean,
}

#: the paper's learning rates: FP32-scale for mean updates, small for sign
LR = {"fp32": 0.08, "gbinary": 5e-4, "gternary": 5e-4,
      "majority_sign_sgd": 5e-4, "sign_of_mean": 5e-4}

#: payload bits per element of each rule, for the traffic ratio
_BITS = {"fp32": 32.0, "gbinary": 1.0, "gternary": np.log2(3.0),
         "majority_sign_sgd": 1.0, "sign_of_mean": 32.0}


@dataclasses.dataclass
class RunResult:
    policy: str
    final_acc: float
    traffic_ratio: float
    losses: list
    cosines: Optional[dict] = None


def run_training(task: ClassificationTask, *, policy: str = "fp32",
                 head_policy: Optional[str] = None, steps: int = 400,
                 batch: int = 256, workers: int = 8, hidden: int = 256,
                 seed: int = 0, lr: Optional[float] = None,
                 momentum: float = 0.9, diagnose_at: Optional[int] = None,
                 degrade: Optional[tuple] = None, warmup_fp32: int = 50,
                 plan_callback: Optional[Callable] = None,
                 program=None, device="cuda", params: Optional[dict] = None,
                 noise: Optional[Callable] = None) -> RunResult:
    """One training run under a (backbone, head) aggregation policy.

    ``policy`` applies to the backbone, ``head_policy`` (default: policy)
    to the classifier head: an 'fp32' head on a low-bit backbone is the
    paper's layer-aware operating point.  Every run begins with
    ``warmup_fp32`` FP32 steps, a :class:`~repro_torch.fabric.control.
    PolicyProgram` latching ``(backbone, head)`` rule names; ``program=``
    may replace it.  ``plan_callback(step, loss)`` may return a (backbone,
    head) pair to change the policy online (control-plane pilots).
    ``degrade=(t0, t1)`` adds 5 x standard-normal noise to every worker
    gradient in that window.

    ``params`` (a numpy tree of the MLP's weights) and ``noise`` (a
    callable ``(step, shape) -> array`` of standard-normal draws) replace
    the generator's draws, so that a run can start from another
    implementation's weights and see its noise.
    """
    # the control vocabulary lives in the fabric layer, which imports
    # core: imported here, as the reference does
    from ..fabric.control import Phase, PolicyProgram, Telemetry

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    head_policy = head_policy or policy
    if params is None:
        params = init_mlp(gen, task.dim, hidden, task.num_classes)
    else:
        params = T.map_leaves(lambda a: torch.tensor(
            np.asarray(a, np.float32), device=dev), params)
    if noise is None:
        def noise(step, shape):
            return torch.randn(shape, generator=gen, device=dev)
    vel = T.map_leaves(torch.zeros_like, params)
    worker_grads = vmap(grad(_ce), in_dims=(None, 0, 0))

    losses, cosines = [], None
    cur = {"plan": (policy, head_policy)}   # live latch payload
    user_program = program is not None
    if program is None:
        program = PolicyProgram([
            Phase("warmup", plan=("fp32", "fp32"),
                  transition=lambda t, p: ("admit" if t.step >= warmup_fp32
                                           else None)),
            Phase("admit", plan=lambda t, p: cur["plan"], latch=False),
        ])
    data = task.batches(batch, seed_offset=seed * 1000)
    rng_eval = np.random.RandomState(seed + 777)
    xe, ye = task.sample(rng_eval, 2048)

    lr_b = lr if lr is not None else LR[policy]
    lr_h = lr if lr is not None else LR[head_policy]
    nb = sum(x.numel() for x in T.leaves(params["backbone"]))
    nh = sum(x.numel() for x in T.leaves(params["head"]))

    traffic_acc = 0.0
    for step in range(steps):
        x, y = next(data)
        x = torch.from_numpy(x).to(dev)
        y = torch.from_numpy(y.astype(np.int64)).to(dev)
        g = worker_grads(params, x.reshape(workers, batch // workers, -1),
                         y.reshape(workers, batch // workers))
        if degrade and degrade[0] <= step < degrade[1]:
            g = T.map_leaves(lambda a: a + 5.0 * torch.as_tensor(
                noise(step, tuple(a.shape)), dtype=torch.float32,
                device=dev), g)

        with torch.no_grad():
            loss = float(_ce(params, x, y))
        losses.append(loss)

        if plan_callback is not None:
            nxt = plan_callback(step, loss)
            if nxt is not None:
                cur["plan"] = tuple(nxt)
        active = tuple(program.advance(Telemetry(step=step, loss=loss)))
        bb_rule, hd_rule = RULES[active[0]], RULES[active[1]]

        if diagnose_at is not None and step == diagnose_at:
            groups = {grp: T.map_leaves(lambda _, n=grp: n, params[grp])
                      for grp in ("backbone", "head")}
            cosines = {k: {m: float(v) for m, v in d.items()}
                       for k, d in group_cosines_from_workers(
                           g, groups).items()}

        agg = {"backbone": T.map_leaves(bb_rule, g["backbone"]),
               "head": T.map_leaves(hd_rule, g["head"])}
        traffic_acc += (nb * _BITS[active[0]] + nh * _BITS[active[1]]) \
            / (32.0 * (nb + nh))

        lr_b_now = LR["fp32"] if active[0] == "fp32" and lr is None else lr_b
        lr_h_now = LR["fp32"] if active[1] == "fp32" and lr is None else lr_h
        with torch.no_grad():
            for grp, lr_ in (("backbone", lr_b_now), ("head", lr_h_now)):
                for name in params[grp]:
                    v = momentum * vel[grp][name] + agg[grp][name]
                    params[grp][name] = params[grp][name] - lr_ * v
                    vel[grp][name] = v

    with torch.no_grad():
        pred = torch.argmax(mlp_logits(params, torch.from_numpy(xe).to(dev)),
                            -1)
    acc = float(torch.mean((pred == torch.from_numpy(
        ye.astype(np.int64)).to(dev)).to(torch.float32)))
    # label what actually ran: a user program owns the latch, so its
    # final plan names the operating point, not the policy arguments
    bb, hd = tuple(program.plan) if user_program else cur["plan"]
    return RunResult(policy=f"{bb}+{hd}head", final_acc=acc,
                     traffic_ratio=traffic_acc / steps, losses=losses,
                     cosines=cosines)


def easy_task(seed: int = 0) -> ClassificationTask:
    """CIFAR-10 analogue: 10 well-separated classes."""
    return make_cluster_task(10, dim=64, hard=False, seed=seed)


def hard_task(seed: int = 0) -> ClassificationTask:
    """CIFAR-100 analogue: 100 fine-grained hierarchical classes."""
    return make_cluster_task(100, dim=64, hard=True, seed=seed)
