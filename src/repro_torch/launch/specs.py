"""``meta`` stand-ins for every model input (no device allocation).

Counterpart of ``repro/launch/specs.py``, with ``meta`` tensors in place
of ``jax.ShapeDtypeStruct``.  ``input_specs(cfg, shape_cell)`` returns
the abstract inputs the dry-run traces against, per architecture family
and evaluation cell:

  * train / prefill: token batches (+ patch features for the VLM stub,
    + frame embeddings for the audio stub);
  * decode: one new token, a KV / state cache sized to ``seq_len``, and
    the position scalar.  With ``mesh=`` the cache is one rank's block
    (``init_cache(..., mesh=)``); the whole cache is never built then.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import ModelConfig, ShapeCell, init_cache

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    b, s = cell.global_batch, cell.seq_len
    if cfg.family == "vlm":
        p = cfg.vision_patches
        text = s - p
        return {"tokens": sds((b, text), torch.int32),
                "labels": sds((b, text), torch.int32),
                "patch_feats": sds((b, p, cfg.vision_feat_dim),
                                   torch.bfloat16)}
    if cfg.family == "encdec":
        return {"tokens": sds((b, s), torch.int32),
                "labels": sds((b, s), torch.int32),
                "frames": sds((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)}
    return {"tokens": sds((b, s), torch.int32),
            "labels": sds((b, s), torch.int32)}


def decode_input_specs(cfg: ModelConfig, cell: ShapeCell,
                       mesh=None) -> dict:
    """The decode step's token, cache and position; ``mesh`` (a
    ProcessMesh) gives this rank's block of the cache."""
    b, s = cell.global_batch, cell.seq_len
    kw = {} if mesh is None else {"mesh": mesh,
                                  "dp_axes": mesh.data_axes}
    cache = init_cache(cfg, b, s, device=META, **kw)
    return {"token": sds((b, 1), torch.int32),
            "cache": cache,
            "position": sds((), torch.int32)}


class StateSpecs(NamedTuple):
    """The reference's ``TrainState`` fields, as ``meta`` trees."""
    params: Any
    opt: Any
    ef: Any
    step: torch.Tensor


def state_specs(cfg: ModelConfig, optimizer, plan, rules=None,
                dp_size: int = 1) -> StateSpecs:
    """Abstract train state (params + opt + EF sentinels) of ``dp_size``
    virtual workers, on ``meta``."""
    from ..fabric import Fabric
    from ..models import init_params, param_pspecs

    fabric = Fabric(rules=rules, num_workers=dp_size)
    params = init_params(cfg, device=META)
    opt = optimizer.init(params)
    opt = opt._replace(step=opt.step.to(META))     # moments are meta already
    policies = fabric.resolve(params, plan, param_pspecs(cfg))
    ef = fabric.init_ef(params, policies)
    return StateSpecs(params=params, opt=opt, ef=ef,
                      step=sds((), torch.int32))


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """All model inputs for one evaluation cell."""
    if cell.kind in ("train", "prefill"):
        return train_batch_specs(cfg, cell)
    return decode_input_specs(cfg, cell)
