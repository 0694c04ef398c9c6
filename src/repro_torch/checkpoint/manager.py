"""Atomic, retained checkpointing with async save (port of
``repro/checkpoint/manager.py``), in the reference's on-disk format.

  * **Atomicity** — a checkpoint is written to ``step_<k:010d>.tmp`` and
    renamed to ``step_<k:010d>`` only when complete; a crash mid-save
    never corrupts the restore path (the previous step remains the
    latest valid one, and a leftover ``.tmp`` is never restored).
  * **Retention** — keep the last ``keep`` checkpoints; older ones are
    deleted only after a newer one is durable.
  * **Format** — ``arrays.npz`` (``a0``, ``a1``, ... in the manifest's
    order) and ``manifest.json`` (``step``, the '/'-joined tree-path
    ``names``, ``dtypes``, ``shapes``, ``extra``).  bfloat16 arrays are
    stored as numpy stores the reference's ``ml_dtypes`` ones: raw
    2-byte words (``|V2``), ``"bfloat16"`` in ``dtypes``.  A train state
    is the reference's ``TrainState`` tree in its leaf order:
    ``params/...``, ``opt/step``, ``opt/mu/...``, ``opt/nu/...`` (AdamW),
    ``ef/...``, ``step`` (:func:`train_state_arrays`), so either package
    restores the other's float32 checkpoints.
  * **Async save** — the state is copied to the host synchronously,
    before :meth:`CheckpointManager.maybe_save` returns (the next step
    updates parameters and moments in place), and serialized on a
    background thread; ``wait()`` fences.
  * **Process groups** — rank 0 writes; every rank meets the others at a
    barrier in ``wait()`` once the write is renamed, so no restore sees
    a half-written step.  Error-feedback rows are gathered to the
    ``(W, ...)`` layout a virtual group holds, so W processes write what
    ``Fabric(num_workers=W)`` writes.
  * **Process meshes** — under tensor parallelism and ZeRO-1
    (:class:`MeshLayout`) the checkpoint still holds whole arrays in the
    reference's format: parameters, moments and ``(W, ...)`` EF rows are
    gathered over the model and data groups before the write, and a
    restore cuts each rank's blocks out of them, on any mesh of the same
    world size (EF rows only at the same data extent W).
  * **Controller threading** — pass ``controller=`` to ``maybe_save`` /
    ``restore`` and its ``state_dict()`` rides in ``extra`` and is
    loaded back on restore.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..core import tree as T

log = logging.getLogger("repro_torch.checkpoint")

_BF16 = "bfloat16"


# ---------------------------------------------------------------------------
# host arrays
# ---------------------------------------------------------------------------

def _host(x) -> tuple[np.ndarray, str]:
    """A tensor or array -> (a host copy that owns its memory, dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        a = t.numpy()
    else:
        a = np.array(x, copy=True)
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array -> a CPU tensor (bfloat16 read bit for bit)."""
    a = np.asarray(a, order="C")           # keeps a 0-d array 0-d
    if dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# one checkpoint on disk
# ---------------------------------------------------------------------------

def _steps(directory: str) -> list[str]:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(directory: str, step: int, arrays: Mapping[str, Any],
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write one atomic checkpoint of a name -> array mapping (tensors or
    numpy arrays, in the order given); returns the final path."""
    return _write(directory, step, {n: _host(x) for n, x in arrays.items()},
                  extra, keep)


def _write(directory: str, step: int, host: Mapping[str, tuple],
           extra: Optional[dict], keep: int) -> str:
    """Write host copies ``name -> (array, dtype name)`` atomically."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = list(host)
    host = [host[n] for n in names]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(host)})
    manifest = {"step": int(step), "names": names,
                "dtypes": [dt for _, dt in host],
                "shapes": [list(a.shape) for a, _ in host],
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                          # atomic publish
    for old in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, old), ignore_errors=True)
    return final


def restore_latest(directory: str):
    """The newest checkpoint as ``(step, {name: CPU tensor}, extra)``, or
    None when there is none."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    if not steps:
        return None
    path = os.path.join(directory, steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {name: _tensor(data[f"a{i}"], dt) for i, (name, dt) in
                  enumerate(zip(manifest["names"], manifest["dtypes"]))}
    return manifest["step"], arrays, manifest.get("extra", {})


# ---------------------------------------------------------------------------
# a train state as a checkpoint tree
# ---------------------------------------------------------------------------

def _per_rank_group(group) -> bool:
    """Does this group hold fewer EF rows than workers (a process group)?"""
    return group is not None and len(group.rank()) != group.size


class MeshLayout:
    """Where a rank's train state lies on a
    :class:`~repro_torch.core.collectives.ProcessMesh`: ``pspecs`` (the
    sanitized partition specs of the whole parameter tree, None off a
    model axis) and ``zero`` (the :class:`~repro_torch.optim.Zero1`
    partition of the moments, or None)."""

    def __init__(self, mesh, pspecs=None, zero=None):
        self.mesh, self.zero = mesh, zero
        self.specs = None if pspecs is None else T.leaves(pspecs)

    def _model_dim(self, i: int):
        from ..runtime.shardings import dim_of
        return None if self.specs is None else dim_of(self.specs[i], "model")

    def whole(self, x: torch.Tensor, i: int, lead: int = 0) -> torch.Tensor:
        """Leaf ``i``'s block ``x`` gathered over the model group (a
        collective every rank joins); ``lead`` leading axes come first."""
        d = self._model_dim(i)
        return x if d is None else \
            self.mesh.model_group.all_gather_dim(x.detach(), d + lead)

    def block(self, full: torch.Tensor, i: int,
              lead: int = 0) -> torch.Tensor:
        """This rank's block of leaf ``i``'s whole array."""
        d = self._model_dim(i)
        if d is None:
            return full
        n = full.shape[d + lead] // self.mesh.model_size
        return full.narrow(d + lead, self.mesh.model_index * n, n)


def _leaf_index(state) -> dict:
    return {p: i for i, (p, _) in enumerate(T.flatten(state.model.tree()))}


def train_state_arrays(state, group=None,
                       layout: MeshLayout | None = None) -> dict:
    """A :class:`~repro_torch.fabric.TrainState` as the reference's tree:
    name -> tensor, in the reference's leaf order.  Under a process group
    each rank's EF rows are gathered (a collective every rank joins) to
    the ``(W, ...)`` rows of a virtual group; on a mesh (``layout``) the
    blocks and ZeRO-1 slices are gathered to whole arrays as well."""
    out: dict[str, Any] = {}
    whole = (lambda x, i, lead=0: x) if layout is None else layout.whole
    index = _leaf_index(state)
    for path, p in T.flatten(state.model.tree()):
        out[f"params/{path}"] = whole(p, index[path])
    opt = state.opt
    out["opt/step"] = opt.step
    for part in ("mu", "nu"):
        tree = getattr(opt, part)
        if tree is not None:
            for path, x in T.flatten(tree):
                i = index[path]
                if layout is not None and layout.zero is not None:
                    x = layout.zero.gather(x, i)
                out[f"opt/{part}/{path}"] = whole(x, i)
    gather = _per_rank_group(group)
    for path, e in T.flatten(state.ef):
        # (1, *shape) rows -> (W, *shape)
        if gather and e.dim():
            e = whole(group.all_gather(e[None]), index[path], 1)
        out[f"ef/{path}"] = e
    out["step"] = torch.tensor(int(state.step), dtype=torch.int32)
    return out


def _rank_arrays(state, arrays, layout: MeshLayout) -> dict:
    """A whole-array checkpoint cut to this rank's blocks and ZeRO-1
    slices (EF rows: its data index's row, kept as a ``(1, ...)`` row)."""
    index = _leaf_index(state)
    out = {}
    for name, x in arrays.items():
        kind, _, path = name.partition("/")
        if kind == "opt" and path != "step":
            _, _, path = path.partition("/")
        i = index.get(path)
        if i is None or x.dim() == 0:
            out[name] = x
        elif kind == "ef":
            w = layout.mesh.data_size
            if x.shape[0] != w:
                raise ValueError(
                    f"checkpoint holds error-feedback residuals {name} of "
                    f"shape {tuple(x.shape)}, written by another number "
                    f"of workers than this run's {w}: EF rows cannot be "
                    f"restored at another world size")
            row = x[layout.mesh.data_index:layout.mesh.data_index + 1]
            out[name] = layout.block(row, i, 1)
        else:
            x = layout.block(x, i)
            if kind == "opt" and layout.zero is not None:
                x = layout.zero.part(x, i)
            out[name] = x
    return out


def load_train_state(state, arrays: Mapping[str, torch.Tensor],
                     group=None, layout: MeshLayout | None = None):
    """Copy a checkpoint's arrays into ``state`` in place (parameters,
    moments, EF rows) and return the restored TrainState.

    Parameters and moments keep their tensors, so steps built on the
    model stay valid.  Under a process group each rank takes its own EF
    rows; EF rows written by another number of workers raise, since a
    residual belongs to one worker's gradient stream.  On a mesh
    (``layout``) each rank takes its blocks of the whole arrays, so a
    checkpoint restores on any mesh of the world size it was written at.
    """
    from ..fabric import TrainState

    if layout is not None:
        arrays = _rank_arrays(state, arrays, layout)
        group = None                   # the EF rows are this rank's now
    want = train_state_arrays(state)
    missing = sorted(set(want) - set(arrays))
    unexpected = sorted(set(arrays) - set(want))
    if missing or unexpected:
        raise ValueError(f"checkpoint tree differs from the train state: "
                         f"missing {missing[:5]}, unexpected "
                         f"{unexpected[:5]}")
    per_rank = _per_rank_group(group)
    ranks = list(group.rank()) if per_rank else None
    for name, dst in want.items():
        src = arrays[name]
        if name.startswith("ef/") and dst.dim():
            size = group.size if group is not None else dst.shape[0]
            if src.dim() == 0 or src.shape[0] != size:
                raise ValueError(
                    f"checkpoint holds error-feedback residuals {name} of "
                    f"shape {tuple(src.shape)}, written by another number "
                    f"of workers than this run's {size}: EF rows cannot "
                    f"be restored at another world size")
            src = src[ranks] if per_rank else src
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"checkpoint leaf {name} is {src.dtype} "
                             f"{tuple(src.shape)}, the state's "
                             f"{dst.dtype} {tuple(dst.shape)}")
    with torch.no_grad():
        for name, dst in want.items():
            if name in ("opt/step", "step"):
                continue
            src = arrays[name]
            if name.startswith("ef/") and dst.dim() and per_rank:
                src = src[ranks]
            dst.copy_(src)
    opt = state.opt._replace(
        step=arrays["opt/step"].to(state.opt.step.device))
    return TrainState(model=state.model, opt=opt, ef=state.ef,
                      step=int(arrays["step"]))


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Async wrapper with a save-interval policy.

    ``group`` (a :class:`~repro_torch.core.collectives.DistributedGroup`)
    makes rank 0 the only writer and fences every rank at a barrier in
    :meth:`wait` after a save.  An exception in the writer thread is
    raised by the next :meth:`wait`.
    """

    def __init__(self, directory: str, *, interval: int = 100, keep: int = 3,
                 group=None):
        self.directory = directory
        self.interval = interval
        self.keep = keep
        self.group = group
        self._writes = not _per_rank_group(group) or group.rank() == (0,)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False
        self.saves = 0

    def maybe_save(self, step: int,
                   tree: Mapping[str, Any] | Callable[[], Mapping[str, Any]],
                   extra: Optional[dict] = None, force: bool = False,
                   controller: Any = None) -> bool:
        """Save at every ``interval``-th step (or when ``force``).

        ``tree`` is a name -> tensor mapping or a callable returning one,
        called only when the step saves (building the tree may take a
        collective).  It is copied to the host before this returns.
        """
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        if controller is not None and hasattr(controller, "state_dict"):
            extra = dict(extra or {})
            extra["controller"] = {
                "name": getattr(controller, "name",
                                type(controller).__name__),
                "state": controller.state_dict()}
        self.wait()
        arrays = tree() if callable(tree) else tree
        # the snapshot: host copies now, before the caller's next step
        # updates the parameters and moments in place
        host = {name: _host(x) for name, x in arrays.items()}
        del arrays
        self._pending = True
        self.saves += 1
        if not self._writes:
            return True

        def work():
            try:
                _write(self.directory, step, host, extra, self.keep)
            except BaseException as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        """Fence the pending save: its writer has renamed it, and under a
        process group every rank has reached this call."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error
        if self._pending and _per_rank_group(self.group):
            self.group.barrier()
        self._pending = False

    def restore(self, controller: Any = None):
        """The newest checkpoint, ``(step, arrays, extra)`` as
        :func:`restore_latest` gives it, or None; loads the controller's
        state from it when the checkpoint carries the same controller's."""
        self.wait()
        restored = restore_latest(self.directory)
        if (restored is not None and controller is not None
                and hasattr(controller, "load_state_dict")):
            blob = (restored[2] or {}).get("controller")
            if blob is not None:
                saved = blob.get("name")
                mine = getattr(controller, "name", type(controller).__name__)
                if saved is not None and saved != mine:
                    # resuming under another policy is an operator's
                    # choice: keep the fresh controller
                    log.warning("checkpoint carries %r controller state; "
                                "active controller is %r — controller "
                                "state not restored", saved, mine)
                else:
                    controller.load_state_dict(blob["state"])
        return restored
