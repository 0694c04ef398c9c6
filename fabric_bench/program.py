"""The system under test: the port's ``Trainer`` built for a cell.

The port (``repro_torch``, under ``src/`` of the checkout) is the only
thing taken from the program: its model config, plan preset, fabric,
optimizer and Trainer.  The weights and the batches are the
benchmark's (:mod:`fabric_bench.weights`, :mod:`fabric_bench.stream`).
"""
from __future__ import annotations

import dataclasses

import torch

from .spec import Cell
from .stream import TokenStream
from . import weights


def model_config(cell: Cell):
    """The port's ``ModelConfig`` as the configuration file states it:
    its ``arch``'s published config with the file's ``model`` keys."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import MoEConfig
    fields = dict(cell.config["model"])
    if "moe" in fields:
        fields["moe"] = MoEConfig(**fields["moe"])
    return dataclasses.replace(get_config(cell.config["arch"]), **fields)


def optimizer(cell: Cell):
    from repro_torch.optim import AdamW
    o = dict(cell.traffic["optimizer"])
    if o.pop("name") != "adamw":
        raise ValueError("the harness drives AdamW only")
    return AdamW(**o)


def build_trainer(cell: Cell, seed: int, device):
    """The port's Trainer for ``cell``, its parameters the benchmark's
    seeded weights, its data the benchmark's stream."""
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.runtime import Trainer
    cfg = model_config(cell)
    plan = plan_presets(error_feedback=cell.traffic["error_feedback"])[
        cell.traffic["plan"]]
    data = TokenStream(cfg.vocab_size, cell.global_batch, cell.seq_len, seed)
    trainer = Trainer(cfg, optimizer(cell), data, plan=plan,
                      fabric=Fabric(num_workers=cell.workers), seed=0,
                      device=device)
    trainer.init_state()
    weights.fill(dict(T.flatten(trainer.state.model.tree())), seed)
    return trainer


def leaves(trainer) -> dict:
    from repro_torch.core import tree as T
    return dict(T.flatten(trainer.state.model.tree()))


@torch.no_grad()
def first_grad_norms(trainer) -> dict:
    """Each leaf's norm of the first aggregate as the optimizer got it,
    worked out from AdamW's state after one step: ``mu / (1 - b1)``."""
    from repro_torch.core import tree as T
    b1 = trainer.optimizer.b1
    return {p: float(torch.linalg.vector_norm(m.to(torch.float32))) / (1 - b1)
            for p, m in T.flatten(trainer.state.opt.mu)}


@torch.no_grad()
def first_votes(trainer, voted) -> dict:
    """The first aggregate's votes on the ``voted`` leaves as the
    optimizer got them, after one step: the signs of AdamW's ``mu``
    (``(1 - b1)`` times the vote), as int8 on the CPU."""
    from repro_torch.core import tree as T
    return {p: torch.sign(m).to(torch.int8).cpu()
            for p, m in T.flatten(trainer.state.opt.mu) if p in voted}


def change_norms(trainer, seed: int) -> dict:
    """Each leaf's distance from the seeded weights."""
    return weights.change_norms(leaves(trainer), seed)


def losses(trainer, n: int) -> list:
    return [float(h["loss"]) for h in trainer.history[:n]]
