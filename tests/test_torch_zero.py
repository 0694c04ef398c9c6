"""ZeRO-1 and checkpoints on a process mesh, on the CPU.

  * the moments' partition specs equal the reference's
    ``optimizer_state_pspecs`` (over its sanitized ``param_pspecs``) for
    all ten configs at meshes (2, 2) and (2, 4);
  * one spawn of four gloo ranks (``torch.set_num_threads(1)``, a
    ``file://`` store, 60 s collective timeouts) training the qwen3 SMOKE
    model on a ``ProcessMesh`` of (2, 2), under gbin_packed:

      - ZeRO-1 (the Trainer's default) against ``zero1=False``: every
        parameter bit-equal after 3 AdamW steps (and 2 SGD-momentum
        steps), with half the moment bytes a rank (every leaf has a
        dimension 2 divides) and one data-group all-gather a leaf a step;
      - a (pod 2, data 1, model 2) mesh: the (2, 2) run bit for bit;
      - restore-and-replay: a failure at step 3 of 5, checkpoints every
        2 steps, restored and replayed to the same last loss and
        parameters bit for bit;
      - the checkpoint holds whole arrays in the reference's format (the
        names of an unsharded run's tree, the blocks gathered), and a
        checkpoint written at (2, 2) restores at (1, 4) on the same four
        ranks: parameters and moments there are the blocks of the
        (2, 2) run's; EF rows written at a data extent of 2 are refused
        at 1.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import param_pspecs as j_param_pspecs  # noqa: E402
from repro.optim import \
    optimizer_state_pspecs as j_optimizer_state_pspecs  # noqa: E402
from repro.runtime.shardings import \
    sanitize_pspecs as j_sanitize_pspecs  # noqa: E402
from repro_torch.checkpoint import train_state_arrays  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import TrainState  # noqa: E402
from repro_torch.models import Transformer, init_params  # noqa: E402
from repro_torch.models.transformer import param_pspecs  # noqa: E402
from repro_torch.optim import AdamW, optimizer_state_pspecs  # noqa: E402
from repro_torch.runtime.shardings import (block_slices,  # noqa: E402
                                           sanitize_pspecs)
from test_torch_tp import spawn_ranks  # noqa: E402

MESH = (2, 2)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_pspecs_equal_the_references(arch, mesh):
    extents = {"data": mesh[0], "model": mesh[1]}
    fake = types.SimpleNamespace(shape=extents)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    like = init_params(cfg, device="meta")
    jlike = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg))
    specs = sanitize_pspecs(param_pspecs(cfg), like, extents)
    jspecs = j_sanitize_pspecs(j_param_pspecs(jcfg), jlike, fake)
    for zero1 in (True, False):
        got = T.leaves(optimizer_state_pspecs(
            specs, like, dp_axes=("data",), dp_size=mesh[0], zero1=zero1))
        want = [tuple(s) for s in jax.tree_util.tree_leaves(
            j_optimizer_state_pspecs(jspecs, jlike, dp_axes=("data",),
                                     dp_size=mesh[0], zero1=zero1),
            is_leaf=lambda x: isinstance(x, P) or x is None)]
        assert got == want, (arch, zero1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero") / "out"
    return spawn_ranks(RANK_PROGRAM, 4, out)


def _coords(mesh, r):
    return {"data": r // mesh[1], "model": r % mesh[1]}


def _whole(world, key, spec, mesh, shape):
    out = np.zeros(shape, np.float32)
    extents = {"data": mesh[0], "model": mesh[1]}
    for r, (arrays, _) in enumerate(world):
        out[block_slices(shape, spec, extents, _coords(mesh, r))] = \
            arrays[key]
    return out


def _cfg():
    return get_config("qwen3_0p6b", smoke=True)


def _specs(mesh):
    like = init_params(_cfg(), device="meta")
    return like, sanitize_pspecs(param_pspecs(_cfg()), like,
                                 {"data": mesh[0], "model": mesh[1]})


@pytest.mark.parametrize("opt", ["adamw", "sgdm"])
def test_zero1_parameters_are_bit_equal_to_unsharded_moments(world, opt):
    for arrays, info in world:
        assert info[f"{opt}/zero/losses"] == info[f"{opt}/whole/losses"]
        for p, _ in T.flatten(init_params(_cfg(), device="meta")):
            a = arrays[f"{opt}/zero/params/{p}"]
            b = arrays[f"{opt}/whole/params/{p}"]
            assert a.tobytes() == b.tobytes(), (opt, p)


def test_zero1_halves_the_moments(world):
    for _, info in world:
        assert info["adamw/zero/dims_none"] == 0
        assert 2 * info["adamw/zero/moment_bytes"] == \
            info["adamw/whole/moment_bytes"]
        leaves = len(T.leaves(init_params(_cfg(), device="meta")))
        assert info["adamw/zero/all_gather"] - \
            info["adamw/whole/all_gather"] == 3 * leaves


def test_a_pod_axis_trains_as_the_2x2_mesh(world):
    """A (pod 2, data 1, model 2) mesh holds the (2, 2) mesh's groups
    with the data axes ("pod", "data"): the same losses and parameters
    bit for bit, ZeRO-1 over both axes."""
    for r, (arrays, info) in enumerate(world):
        assert info["pod/coords"] == {"pod": r // 2, "data": 0,
                                      "model": r % 2}
        assert info["pod/data_axes"] == ["pod", "data"]
        assert None not in info["pod/zero_dims"]
        assert info["pod/losses"] == info["adamw/zero/losses"]
        for p, _ in T.flatten(init_params(_cfg(), device="meta")):
            assert arrays[f"pod/params/{p}"].tobytes() == \
                arrays[f"adamw/zero/params/{p}"].tobytes(), p


def test_restore_and_replay_is_bit_equal(world):
    for arrays, info in world:
        assert info["replay/0/restarts"] == 0
        assert info["replay/1/restarts"] == 1
        assert info["replay/0/losses"][-1] == info["replay/1/losses"][-1]
        for p, _ in T.flatten(init_params(_cfg(), device="meta")):
            assert arrays[f"replay/0/params/{p}"].tobytes() == \
                arrays[f"replay/1/params/{p}"].tobytes(), p


def test_checkpoint_holds_whole_arrays_in_the_references_format(world):
    """The names of an unsharded run's checkpoint tree, in its order,
    and every parameter and moment the gathered blocks."""
    cfg = _cfg()
    model = Transformer(cfg, device="cpu")
    opt = AdamW()
    state = TrainState(model=model, opt=opt.init(model.tree()),
                       ef=T.map_leaves(lambda p: torch.zeros(()),
                                       model.tree()))
    names = list(train_state_arrays(state))
    info = world[0][1]
    assert info["elastic/ckpt_names"] == names
    like, specs = _specs(MESH)
    ckpt = world[0][0]
    for (p, x), spec in zip(T.flatten(like), T.leaves(specs)):
        want = _whole(world, f"elastic/params/{p}", spec, MESH,
                      tuple(x.shape))
        np.testing.assert_array_equal(ckpt[f"ckpt/params/{p}"], want, p)


def test_checkpoint_written_at_2x2_restores_at_1x4(world):
    like, specs = _specs((1, 4))
    ckpt = world[0][0]
    for r, (arrays, info) in enumerate(world):
        assert info["elastic/1x4/step"] == 4
        coords = _coords((1, 4), r)
        for (p, x), spec in zip(T.flatten(like), T.leaves(specs)):
            sl = block_slices(tuple(x.shape), spec, {"data": 1, "model": 4},
                              coords)
            for kind in ("params", "opt/mu", "opt/nu"):
                np.testing.assert_array_equal(
                    arrays[f"elastic/1x4/{kind}/{p}"],
                    ckpt[f"ckpt/{kind}/{p}"][sl], (kind, p))


def test_error_feedback_rows_refused_at_another_data_extent(world):
    for _, info in world:
        assert "another number of workers" in info["ef/1x4/error"]


RANK_PROGRAM = r'''
import json, os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
WORLD, R = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
OUT = os.environ["OUT_DIR"]
dist.init_process_group("gloo", init_method=f"file://{OUT}/store", rank=R,
                        world_size=WORLD, timeout=timedelta(seconds=60))

from repro_torch.checkpoint import restore_latest
from repro_torch.configs import get_config
from repro_torch.core import ProcessMesh
from repro_torch.core import tree as T
from repro_torch.data import SyntheticLMStream
from repro_torch.fabric import Fabric, plan_presets
from repro_torch.optim import AdamW, SgdMomentum
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

arrays, info = {}, {}
cfg = get_config("qwen3_0p6b", smoke=True)
data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8, seed=0)
GBIN = plan_presets()["gbin_packed"]
OPTS = {"adamw": AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10),
        "sgdm": SgdMomentum(peak_lr=1e-2)}
mesh22 = ProcessMesh((2, 2), device="cpu")


def train(tag, mesh, steps, opt="adamw", plan=GBIN, **kw):
    tcfg = TrainerConfig(log_interval=1000, zero1=kw.pop("zero1", True),
                         checkpoint_interval=kw.pop("interval", 100))
    tr = Trainer(cfg, OPTS[opt], data, plan=plan, fabric=Fabric(mesh=mesh),
                 device="cpu", tcfg=tcfg, **kw)
    mesh.reset_counts()
    tr.run(steps)
    info[f"{tag}/losses"] = [h["loss"] for h in tr.history]
    info[f"{tag}/restarts"] = tr.restarts
    info[f"{tag}/step"] = tr.state.step
    info[f"{tag}/all_gather"] = mesh.data_group.calls_by_op.get(
        "all_gather", 0)
    for p, x in T.flatten(tr.state.model.tree()):
        arrays[f"{tag}/params/{p}"] = x.detach().numpy().copy()
    return tr


# -- ZeRO-1 against whole moments --------------------------------------------
for opt, steps in (("adamw", 3), ("sgdm", 2)):
    for zero1 in (True, False):
        tag = f"{opt}/{'zero' if zero1 else 'whole'}"
        tr = train(tag, mesh22, steps, opt=opt, zero1=zero1)
        st = tr.state.opt
        moments = T.leaves(st.mu) + (T.leaves(st.nu) if st.nu else [])
        info[f"{tag}/moment_bytes"] = sum(m.numel() * 4 for m in moments)
        if zero1:
            info[f"{tag}/dims_none"] = sum(d is None for d in tr.zero.dims)

# -- a pod axis: (pod 2, data 1, model 2) is (2, 2) with two data axes ----
pod = ProcessMesh((2, 1, 2), device="cpu")
info["pod/coords"] = pod.coords
info["pod/data_axes"] = list(pod.data_axes)
tr = train("pod", pod, 3)
info["pod/zero_dims"] = list(tr.zero.dims)

# -- restore and replay at (2, 2) --------------------------------------------
for fail in (0, 1):
    train(f"replay/{fail}", mesh22, 5, interval=2,
          ckpt_dir=os.path.join(OUT, f"replay{fail}"),
          failure_injector=FailureInjector(at_steps=[3]) if fail else None)

# -- a (2, 2) checkpoint restored at (1, 4) ----------------------------------
elastic = os.path.join(OUT, "elastic")
train("elastic", mesh22, 4, interval=2, ckpt_dir=elastic)
if R == 0:
    _, ckpt, _ = restore_latest(elastic)
    info["elastic/ckpt_names"] = list(ckpt)
    for name, x in ckpt.items():
        arrays[f"ckpt/{name}"] = x.numpy()
dist.barrier()
mesh14 = ProcessMesh((1, 4), device="cpu")
tr = Trainer(cfg, OPTS["adamw"], data, plan=GBIN, fabric=Fabric(mesh=mesh14),
             device="cpu", ckpt_dir=elastic,
             tcfg=TrainerConfig(log_interval=1000, checkpoint_interval=100))
tr.init_state()
tr._restore()
info["elastic/1x4/step"] = tr.state.step
for p, x in T.flatten(tr.state.model.tree()):
    arrays[f"elastic/1x4/params/{p}"] = x.detach().numpy().copy()
for part in ("mu", "nu"):
    for p, x in T.flatten(getattr(tr.state.opt, part)):
        arrays[f"elastic/1x4/opt/{part}/{p}"] = x.numpy().copy()

# -- EF rows of a data extent of 2 refused at 1 ------------------------------
ef_dir = os.path.join(OUT, "ef")
train("ef", mesh22, 1, plan=plan_presets(error_feedback=True)["gbin_packed"],
      ckpt_dir=ef_dir)
try:
    train("ef/1x4", mesh14, 2,
          plan=plan_presets(error_feedback=True)["gbin_packed"],
          ckpt_dir=ef_dir)
    info["ef/1x4/error"] = None
except ValueError as e:
    info["ef/1x4/error"] = str(e)

dist.barrier()
dist.destroy_process_group()
np.savez(os.path.join(OUT, f"rank{R}.npz"), **arrays)
with open(os.path.join(OUT, f"rank{R}.json"), "w") as f:
    json.dump(info, f)
'''
