"""Serving runtime: the decode step, the cache-filling prefill and the
batched prefill, on one device or on a process mesh.

Port of ``repro/runtime/serve.py``.  Serving has no gradient traffic, so
the fabric's modes do not enter here.  ``mesh=None`` is the one-device
path (the serving engine's and the tests' path).  On a
:class:`~repro_torch.core.ProcessMesh` (one rank a process) each rank
holds its blocks of the reference's GSPMD layouts
(:func:`serve_shardings`):

  * batched decode (the data ranks divide the batch): the batch over
    the data axes, the cache's sequence over ``"model"``; Q's columns,
    the MLP's, the experts and the vocabulary over ``"model"`` too
    (:mod:`repro_torch.models.tp`), its ranks gathering the token's q,
    k and v of every head;
  * ``shard_seq`` (a batch they do not divide, such as ``long_500k``'s
    1): the batch on every rank, the cache's sequence over every axis.

Each rank attends over the cache positions it holds, and the partial
softmaxes are combined over the ranks that hold a row's sequence
(:func:`repro_torch.models.layers.attn_decode`; float32 sums in another
order than the one-device softmax, so close to it, not bit-equal).  A
MoE layer gathers its input over the data ranks and dispatches the
whole batch, as the reference's capacity counts it, each model rank
running its experts on it.  The step takes the
global token (and a global (B,) position) as the reference's caller
holds it, the rank's blocks of the parameters
(:func:`~repro_torch.models.transformer.shard_params`) and of the cache
(``init_cache(..., mesh=mesh)``), and returns the whole (B, V) logits
on every rank, as the reference's replicated output.  The SSM, hybrid
and encoder-decoder families raise by name at a model axis above 1
(their tensor parallelism is ROADMAP queue 1 item 4); every family
serves on a ``(D, 1)`` mesh.

``donate=True`` mirrors the reference's donated cache: the step writes
into the cache it is given (the KV tensors in place; the recurrent
states come back as new tensors, see
:func:`~repro_torch.models.decode_step`).  ``donate=False`` works on a
copy of the whole tree and leaves the caller's cache as it was.  The
paged engine (:mod:`repro_torch.serve`) takes only the attention
families on one device, as the reference's does.
"""
from __future__ import annotations

import torch

from ..core import tree as T
from ..models import ModelConfig, decode_step, forward, init_params
from ..models import layers as L
from ..models.tp import TensorParallel
from ..models.transformer import (DecodeLayout, _vocab_split,
                                  check_model_axis, mesh_extents,
                                  param_pspecs, serving_cache_specs)
from .shardings import axis_size, block_index, sanitize_pspecs

__all__ = ["build_cached_prefill", "build_prefill", "build_serve_step",
           "serve_shardings"]


def _own(cache: dict, donate: bool) -> dict:
    """The cache itself, or a copy of the whole tree (an xLSTM's is a
    list of per-block state dicts)."""
    return cache if donate else T.map_leaves(torch.Tensor.clone, cache)


def serve_shardings(cfg: ModelConfig, mesh, *, batch: int, max_seq: int,
                    dp_axes=("data",)) -> dict:
    """The reference's layouts of one decode step: ``"token"`` the
    token's spec (``()`` or ``(dp, None)``), ``"cache"`` the sanitized
    cache spec tree, ``"shard_seq"`` whether the cache's sequence is
    spread over every axis (the data ranks do not divide ``batch``).
    ``mesh`` is a :class:`~repro_torch.core.ProcessMesh` or its extents
    ``{axis: size}``."""
    dp = tuple(dp_axes)
    shard_seq, specs, _ = serving_cache_specs(cfg, batch, max_seq, mesh, dp)
    return {"token": () if shard_seq else (dp, None), "cache": specs,
            "shard_seq": shard_seq}


def _param_specs(cfg: ModelConfig, mesh) -> dict:
    return sanitize_pspecs(param_pspecs(cfg), init_params(cfg, device="meta"),
                           mesh_extents(mesh))


def _check_mesh(cfg: ModelConfig, mesh, dp_axes) -> None:
    """Raise for what the port does not serve on ``mesh``: a family
    without tensor parallelism on a model axis above 1, data axes other
    than the mesh's own."""
    extents = mesh_extents(mesh)
    check_model_axis(cfg, extents.get("model", 1))
    if not hasattr(mesh, "data_group"):
        raise TypeError(f"serving on a mesh runs one rank a process: pass "
                        f"a ProcessMesh, not {mesh!r}")
    if set(dp_axes) != set(mesh.data_axes):
        raise ValueError(f"dp_axes {tuple(dp_axes)}: the port's data group "
                         f"spans the mesh's data axes {mesh.data_axes}")


def _seq_group(spec, mesh):
    """The group that holds a cache leaf's sequence under its entry
    ``spec``, or None where one rank holds it whole."""
    if spec is None or axis_size(mesh.extents, spec) == 1:
        return None
    return mesh.model_group if spec == "model" else mesh.world


def _layout(cfg: ModelConfig, mesh, sh: dict, batch: int, max_seq: int,
            tp) -> tuple[DecodeLayout, slice]:
    """This rank's :class:`DecodeLayout` and its rows of the batch."""
    seq = cross = None
    if cfg.family != "ssm":
        k_spec = sh["cache"]["k"][2]
        group = _seq_group(k_spec, mesh)
        if group is not None:
            n = max_seq // axis_size(mesh.extents, k_spec)
            seq = L.SeqShard(group, block_index(k_spec, mesh.extents,
                                                mesh.coords) * n)
        if "cross_k" in sh["cache"]:
            cross = _seq_group(sh["cache"]["cross_k"][2], mesh)
    spread = not sh["shard_seq"] and mesh.data_size > 1
    rows = slice(None)
    if spread:
        n = batch // mesh.data_size
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    return DecodeLayout(tp=tp, seq=seq, cross=cross,
                        data=mesh.data_group if spread else None), rows


def _tensor_parallel(mesh) -> TensorParallel | None:
    return TensorParallel(mesh.model_group) if mesh.model_size > 1 else None


def build_serve_step(cfg: ModelConfig, mesh=None, *, batch: int,
                     max_seq: int, dp_axes=("data",), donate: bool = True):
    """(params, token, cache, position) -> (logits, cache), and the
    shardings dict.

    ``position`` is a Python int or a (B,) integer tensor (continuous
    batching, see :func:`repro_torch.models.decode_step`); ``batch`` and
    ``max_seq`` size the step's cache, as in the reference.  On one
    device the dict's entries are None.  On a mesh ``sh["params"]`` is
    the sanitized parameter spec tree (the blocks the step's
    ``params`` are), and the step takes the global (B, 1) token and
    position, this rank's cache block, and returns the (B, V) logits."""
    if mesh is None:
        def step(params, token, cache, position):
            return decode_step(params, cfg, token, _own(cache, donate),
                               position)

        return step, {"token": None, "cache": None, "params": None,
                      "shard_seq": False}

    _check_mesh(cfg, mesh, dp_axes)
    sh = serve_shardings(cfg, mesh, batch=batch, max_seq=max_seq,
                         dp_axes=dp_axes)
    sh["params"] = _param_specs(cfg, mesh)
    layout, rows = _layout(cfg, mesh, sh, batch, max_seq,
                           _tensor_parallel(mesh))

    def mesh_step(params, token, cache, position):
        if torch.is_tensor(position) and position.dim() == 1:
            position = position[rows]
        logits, cache = decode_step(params, cfg, token[rows],
                                    _own(cache, donate), position, layout)
        if layout.data is not None:
            logits = layout.data.all_gather(logits[None])
        return logits, cache

    return mesh_step, sh


def build_cached_prefill(cfg: ModelConfig, mesh=None, *, dp_axes=("data",),
                         donate: bool = True, batch: int | None = None,
                         max_seq: int | None = None):
    """(params, tokens, length, cache) -> (last_logits, cache).

    Feeds ``tokens[:, :length]`` (B, P integers, anything past
    ``length``) through :func:`~repro_torch.models.decode_step` one
    position at a time, as the reference's ``fori_loop`` does, so the
    prefilled cache and the logits are the decode path's own bits.
    Returns the logits at the last prompt position and the cache filled
    at ``[0, length)``, ready for decode at ``length``.  On a mesh the
    prompt goes through the mesh's decode step
    (:func:`build_serve_step`), which ``batch`` and ``max_seq`` (the
    global cache's) size; ``tokens`` is the global (B, P) prompt and
    ``cache`` this rank's block."""
    if mesh is None:
        def run(params, tokens, length, cache):
            cache = _own(cache, donate)
            logits = None
            for i in range(max(1, int(length))):
                logits, cache = decode_step(params, cfg, tokens[:, i:i + 1],
                                            cache, i)
            return logits, cache

        return run

    if batch is None or max_seq is None:
        raise ValueError("build_cached_prefill on a mesh needs batch= and "
                         "max_seq=, the global cache's, to lay it out")
    step, _ = build_serve_step(cfg, mesh, batch=batch, max_seq=max_seq,
                               dp_axes=dp_axes, donate=True)

    def mesh_run(params, tokens, length, cache):
        cache = _own(cache, donate)
        logits = None
        for i in range(max(1, int(length))):
            logits, cache = step(params, tokens[:, i:i + 1], cache, i)
        return logits, cache

    return mesh_run


def build_prefill(cfg: ModelConfig, mesh, *, dp_axes=("data",)):
    """(params, batch) -> logits (B, S, V): the forward pass with the
    batch over the data ranks (which must divide it, as the reference's
    ``P(dp)`` placement requires) and, for the decoder-only families,
    Q's columns, the MLP's, the experts and the vocabulary over the
    model ranks; ``params`` are this
    rank's blocks (``sh["params"]`` of :func:`build_serve_step`), and
    every rank gets the whole logits.  A MoE layer dispatches each
    rank's tokens, which is the reference's function when they fill
    whole dispatch groups (raises otherwise)."""
    _check_mesh(cfg, mesh, dp_axes)
    tp = _tensor_parallel(mesh)
    d = mesh.data_size

    @torch.no_grad()
    def run(params, batch):
        b, s = batch["tokens"].shape
        if b % d:
            raise ValueError(f"a batch of {b} over {d} data ranks: the "
                             f"prefill shards the batch over the data axes")
        n = b // d
        if cfg.moe is not None and d > 1 and (n * s) % cfg.moe.group_size:
            raise NotImplementedError(
                f"{cfg.name}: {n * s} tokens a data rank split the MoE's "
                f"{cfg.moe.group_size}-token dispatch groups across ranks; "
                f"the reference dispatches them whole")
        rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
        logits = forward(params, cfg, {k: v[rows] for k, v in batch.items()},
                         tp)
        if _vocab_split(params, cfg, tp):
            logits = tp.group.all_gather_dim(logits, -1)
        if d > 1:
            logits = mesh.data_group.all_gather(logits[None])
        return logits

    return run
