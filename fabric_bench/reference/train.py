"""The reference's data-parallel steps, followed from the seeded start.

Each step: the global batch of the benchmark's stream cut into W equal
shards of rows; each worker's float32 loss and gradients on its shard;
the aggregate of each parameter group as the traffic mix's
``reference_plan`` names it, either the G-Binary vote ``sign(2c - W)``
(``c`` the workers whose gradient is strictly positive, so a tie gives
0) or the FP32 mean; then AdamW (float32 moments, the step's learning
rate from linear warm-up and cosine decay, decoupled weight decay), the
parameters stored in the configuration's dtype.  Groups follow the
parameter's path: the head and routers, the norms and biases, the
embedding, and the rest (the backbone).
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch

from .. import weights
from ..stream import TokenStream
from . import model as M

#: (pattern, group): the first that matches a parameter's path wins
GROUPS = ((r"(^|/)(head|lm_head|classifier|logits)(/|$)", "head"),
          (r"(^|/)(router|gate_weights?)(/|$)", "head"),
          (r"(norm|bias|scale|ln_|layernorm)", "norms"),
          (r"(embed|wte|wpe|patch_proj|frontend)", "embed"))


def group_of(path: str) -> str:
    for pattern, group in GROUPS:
        if re.search(pattern, path):
            return group
    return "backbone"


@dataclasses.dataclass
class Readings:
    """What a run gives to be compared: each step's loss, each leaf's
    norm of the first aggregate and of the change after the steps,
    the first aggregate's votes (each voted leaf's, as int8 on the
    CPU), and (the reference's) each leaf's norm of a worker's raw first
    gradient, averaged over the workers."""
    losses: list
    grad_norms: dict
    change_norms: dict
    votes: dict = dataclasses.field(default_factory=dict)
    raw_norms: dict = dataclasses.field(default_factory=dict)


def voted_paths(paths, traffic: dict) -> set:
    """The parameters whose group the mix's ``reference_plan`` votes."""
    votes = {g for g, how in traffic["reference_plan"].items()
             if how == "gbinary"}
    return {p for p in paths if group_of(p) in votes}


def lr_at(step: int, o: dict) -> float:
    """The learning rate of the 1-based ``step``: linear warm-up, then
    cosine decay to a tenth of the peak."""
    warm = max(o["warmup_steps"], 1)
    if step < o["warmup_steps"]:
        return o["peak_lr"] * step / warm
    span = max(o["total_steps"] - o["warmup_steps"], 1)
    prog = min(max((step - o["warmup_steps"]) / span, 0.0), 1.0)
    return o["peak_lr"] * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def halve(x: torch.Tensor) -> torch.Tensor:
    """A worker's first half of rows, or of its one row's tokens."""
    return x[:x.shape[0] // 2] if x.shape[0] > 1 else x[:, :x.shape[1] // 2]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.to(torch.float32)))


def run(m: dict, traffic: dict, workers: int, seed: int, device, *,
        steps: int, control: bool = False,
        fault: str | None = None) -> Readings:
    """The reference followed for ``steps`` steps from the seeded start.

    ``control`` computes every product in the precision below the
    configuration's (``model.LOWER``), recomputing each layer in the
    backward: its rounded operands would not fit beside the float32
    ones at the cells' sizes.  ``fault`` plants a fault
    in the program's place: ``"half"`` leaves out half of each worker's
    batch (its later rows, or the later half of a single row) and
    aggregates the rest, ``"exchange"`` leaves out the exchange (the
    aggregate is worker 0's own gradient)."""
    params = M.empty_params(m, device)
    weights.fill(params, seed)
    voted = voted_paths(params, traffic)
    o = traffic["optimizer"]
    mu = {p: torch.zeros(t.shape, dtype=torch.float32, device=device)
          for p, t in params.items()}
    nu = {p: torch.zeros_like(x) for p, x in mu.items()}
    rows = traffic["seqs_per_worker"]
    stream = TokenStream(m["vocab_size"], workers * rows, traffic["seq_len"],
                         seed)
    ranks = list(range(workers))[:1 if fault == "exchange" else workers]
    ar = M.Arith(M.LOWER[m["dtype"]] if control else None)
    losses, grad_norms, raw, first_votes = [], {}, {}, {}
    for step in range(steps):
        batch = stream.batch_at(step)
        tokens = torch.as_tensor(batch["tokens"]).to(device)
        labels = torch.as_tensor(batch["labels"]).to(device)
        p32 = {p: t.to(torch.float32).requires_grad_()
               for p, t in params.items()}
        count = {p: torch.zeros(params[p].shape, dtype=torch.int8,
                                device=device) for p in voted}
        total = {p: torch.zeros(params[p].shape, dtype=torch.float32,
                                device=device)
                 for p in params if p not in voted}
        step_loss = 0.0
        for r in ranks:
            tok, lab = tokens[r * rows:(r + 1) * rows], \
                labels[r * rows:(r + 1) * rows]
            if fault == "half":
                tok, lab = halve(tok), halve(lab)
            # the worker's mean loss and gradient, a row at a time (its
            # rows are of one length), so that the activations fit
            for t in p32.values():
                t.grad = None
            for i in range(tok.shape[0]):
                lval = M.loss(p32, m, tok[i:i + 1], lab[i:i + 1], ar,
                              remat=control) / tok.shape[0]
                lval.backward()
                step_loss += float(lval.detach()) / len(ranks)
                del lval
            for p, t in p32.items():
                g = t.grad
                if p in voted:
                    count[p] += (g > 0).to(torch.int8)
                else:
                    total[p] += g
                if step == 0:
                    raw[p] = raw.get(p, 0.0) + _norm(g) / len(ranks)
                t.grad = None
        del p32
        losses.append(step_loss)
        n = len(ranks)
        agg = {p: torch.sign(2 * count[p].to(torch.float32) - n)
               for p in voted}
        agg.update({p: t / n for p, t in total.items()})
        del count, total
        if step == 0:
            grad_norms = {p: _norm(a) for p, a in agg.items()}
            first_votes = {p: agg[p].to(torch.int8).cpu() for p in voted}
        lr = lr_at(step + 1, o)
        c1, c2 = 1 - o["b1"] ** (step + 1), 1 - o["b2"] ** (step + 1)
        with torch.no_grad():
            for p, t in params.items():
                g = agg.pop(p)
                mu[p].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
                nu[p].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
                pf = t.to(torch.float32)
                delta = (mu[p] / c1) / (torch.sqrt(nu[p] / c2) + o["eps"]) \
                    + o["weight_decay"] * pf
                t.copy_(pf - lr * delta)
    return Readings(losses=losses, grad_norms=grad_norms,
                    change_norms=weights.change_norms(params, seed),
                    votes=first_votes, raw_norms=raw)
