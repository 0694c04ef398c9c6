"""The bucket layout of a session on a mesh against the reference's.

The reference resolves its policies with the partition specs on every
mesh, so a leaf specced over ``"model"`` keeps a launch of its own even
at a model extent of 1; a session without a mesh has no specs and
buckets every leaf.  Held here, launch for launch and slot for slot, on
the SMOKE model and on full qwen3-0.6B (shapes only: ``meta`` tensors
against ``jax.eval_shape``), at (data 1, model 1) and (data 4, model 1):

  * ``Fabric(mesh=ProcessMesh(...)).layout_for`` with the sanitized
    specs, against the reference's ``Fabric(mesh, dp_axes).layout_for``;
  * the Trainer's resolved policies and its step's layout, against the
    reference Trainer's step (``Fabric.step_for``'s ``aux``);
  * the launcher's Trainer at ``--mesh 1,1`` and ``--mesh 4,1``, on
    virtual workers (a ``VirtualMesh``) and as rank 0 of ``torchrun``
    (a ``ProcessMesh`` under a fake process group);
  * a worker group used directly, which keeps the data-parallel layout
    of the reference's session without specs.

The reference runs once a module, in a subprocess on four forced host
devices.  The port's process meshes are rank 0 of a fake process group
(``launch.dryrun.fake_world``) on ``meta``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (ProcessMesh, VirtualGroup,  # noqa: E402
                              VirtualMesh, codec_name, schedule_name)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import Fabric, plan_presets  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.transformer import param_pspecs  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import Trainer  # noqa: E402
from repro_torch.runtime.shardings import sanitize_pspecs  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MESHES = ((1, 1), (4, 1))
PLANS = ("gbin_packed", "int4_backbone")
SIZES = ("smoke", "full")

REFERENCE_PROGRAM = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.fabric import Fabric
from repro.fabric.control import plan_presets
from repro.models import init_params, param_pspecs
from repro.optim import AdamW
from repro.runtime.shardings import sanitize_pspecs

MESHES, PLANS = json.loads(sys.argv[1]), json.loads(sys.argv[2])


def name(x):
    return str(getattr(x, "value", x))


def spec(s):
    return None if s is None or all(e is None for e in s) else list(s)


def key(k):
    return [name(k.mode), name(k.schedule), bool(k.error_feedback),
            int(k.gate_phase), spec(k.model_spec), str(k.dtype), k.hops]


def layout(lay):
    units = [[b.slots[0].leaf, "bucket",
              [[s.leaf, s.name, list(s.shape), s.size, s.offset]
               for s in b.slots], b.size, key(b.key)] for b in lay.buckets]
    units += [[u.leaf, "leaf", [[u.leaf, u.name]], u.size, key(u.key)]
              for u in lay.unfused]
    return {"units": sorted(units, key=lambda u: u[0]),
            "launches": lay.num_launches}


def policies(tree):
    return [[name(p.mode), name(p.schedule), int(p.gate_phase),
             bool(p.error_feedback), spec(p.model_spec)]
            for p in jax.tree_util.tree_leaves(
                tree, is_leaf=lambda x: hasattr(x, "error_feedback"))]


out = {}
plans = plan_presets(error_feedback=True)
for size in ("smoke", "full"):
    cfg = get_config("qwen3_0p6b", size == "smoke")
    like = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    for shape in MESHES:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        fabric = Fabric(mesh, ("data",))
        specs = sanitize_pspecs(param_pspecs(cfg), like, mesh)
        for p in PLANS:
            tag = f"{size}/{shape[0]}x{shape[1]}/{p}"
            out[f"fabric/{tag}"] = layout(
                fabric.layout_for(like, plans[p], pspecs=specs))
            # what the reference Trainer's _get_step builds
            step = fabric.step_for(cfg, AdamW(), plans[p], like)
            out[f"trainer/{tag}"] = {
                "policies": policies(step.aux["policies"]),
                "layout": layout(step.aux["layout"]),
                "launches": step.aux["num_launches"]}
    for p in PLANS:
        out[f"group/{size}/{p}"] = layout(
            Fabric(dp_axes=("w",), num_workers=4).layout_for(like, plans[p]))
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    """The reference's layouts and policies, from one subprocess on four
    forced host devices."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-c", REFERENCE_PROGRAM, json.dumps(MESHES),
         json.dumps(PLANS)], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _json(x):
    """Tuples as lists, as the reference's side comes back."""
    return json.loads(json.dumps(x))


def _spec(s):
    return None if s is None or all(e is None for e in s) else list(s)


def _key(k):
    return [codec_name(k.mode), schedule_name(k.schedule),
            bool(k.error_feedback), int(k.gate_phase), _spec(k.model_spec),
            str(k.dtype), k.hops]


def _layout(lay):
    units = [[b.slots[0].leaf, "bucket",
              [[s.leaf, s.name, list(s.shape), s.size, s.offset]
               for s in b.slots], b.size, _key(b.key)] for b in lay.buckets]
    units += [[u.leaf, "leaf", [[u.leaf, u.name]], u.size, _key(u.key)]
              for u in lay.unfused]
    return _json({"units": sorted(units, key=lambda u: u[0]),
                  "launches": lay.num_launches})


def _ref_layout(want):
    """The reference's layout with its codec and schedule names as the
    port spells them."""
    for unit in want["units"]:
        k = unit[-1]
        k[0], k[1] = codec_name(k[0]), schedule_name(k[1])
    return want


def _policies(tree):
    return _json([[codec_name(p.mode), schedule_name(p.schedule),
                   int(p.gate_phase), bool(p.error_feedback),
                   _spec(p.model_spec)] for p in T.leaves(tree)])


def _ref_policies(want):
    return [[codec_name(m), schedule_name(s), *rest]
            for m, s, *rest in want]


def _cfg(size):
    return get_config("qwen3_0p6b", size == "smoke")


def _specced(cfg) -> int:
    """The leaves whose specs shard a dimension over ``"model"``."""
    like = init_params(cfg, device="meta")
    specs = sanitize_pspecs(param_pspecs(cfg), like,
                            {"data": 1, "model": 1})
    return sum(any(e is not None for e in s) for s in T.leaves(specs))


def _trainer_step(fabric, cfg, plan):
    """The Trainer's step on ``fabric`` under ``plan``, built on ``meta``
    parameters as the Trainer builds it."""
    trainer = Trainer(cfg, AdamW(), None, plan=plan, fabric=fabric,
                      device="meta")
    trainer.init_state()
    return trainer.step_function(plan)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", MESHES, ids=["1x1", "4x1"])
def test_fabric_layout_on_a_mesh_equals_the_references(reference, shape,
                                                       size, plan):
    cfg = _cfg(size)
    like = init_params(cfg, device="meta")
    with fake_world(shape[0] * shape[1]):
        mesh = ProcessMesh(shape, device="meta")
        specs = sanitize_pspecs(param_pspecs(cfg), like, mesh.extents)
        got = Fabric(mesh=mesh).layout_for(
            like, plan_presets(error_feedback=True)[plan], specs)
    want = _ref_layout(reference[f"fabric/{size}/{shape[0]}x{shape[1]}/"
                                 f"{plan}"])
    assert _layout(got) == want
    # the "model"-specced leaves keep launches of their own at M = 1
    assert len(got.unfused) == _specced(cfg) == (7 if size == "smoke"
                                                 else 6)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", MESHES, ids=["1x1", "4x1"])
def test_trainer_policies_on_a_mesh_equal_the_references(reference, shape,
                                                         size, plan):
    cfg = _cfg(size)
    preset = plan_presets(error_feedback=True)[plan]
    with fake_world(shape[0] * shape[1]):
        step = _trainer_step(Fabric(mesh=ProcessMesh(shape, device="meta")),
                             cfg, preset)
    want = reference[f"trainer/{size}/{shape[0]}x{shape[1]}/{plan}"]
    assert _policies(step.policies) == _ref_policies(want["policies"])
    assert _layout(step.layout) == _ref_layout(want["layout"])
    assert step.layout.num_launches == want["launches"]


def _launcher_step(monkeypatch, size, shape, torchrun):
    """The step of the Trainer that ``python -m repro_torch.launch.train
    --mesh D,1 --plan gbin_packed --error-feedback`` builds, on ``meta``
    parameters: on virtual workers, or as rank 0 of ``torchrun`` (its
    process group a fake one).  The Trainer's loop is replaced by one
    that builds the step and returns at once."""
    import repro_torch.data as data
    import torch.distributed as dist
    from repro_torch.launch.train import main
    seen = []

    def run(self, num_steps):
        self.init_state()
        seen.append(self.step_function(self._current_plan()))
        return [{"step": 0, "loss": 0.0, "traffic_ratio": 0.0}]

    monkeypatch.setattr(Trainer, "run", run)
    # the launcher's stream draws a vocab x vocab table; no batch is read
    monkeypatch.setattr(data, "SyntheticLMStream", lambda **kw: None)
    if torchrun:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        ranks = str(shape[0] * shape[1])
        for k, v in (("WORLD_SIZE", ranks), ("RANK", "0"),
                     ("LOCAL_RANK", "0")):
            monkeypatch.setenv(k, v)
        monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: (
            dist.distributed_c10d.init_process_group(
                "fake", store=FakeStore(), rank=0, world_size=int(ranks))))
    argv = ["--arch", "qwen3_0p6b", "--device", "meta", "--mesh",
            f"{shape[0]},{shape[1]}", "--steps", "1", "--plan",
            "gbin_packed", "--error-feedback"]
    main(argv + (["--smoke"] if size == "smoke" else []))
    assert not dist.is_initialized()
    return seen[0]


@pytest.mark.parametrize("torchrun", [False, True],
                         ids=["virtual", "torchrun"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", MESHES, ids=["1x1", "4x1"])
def test_launcher_layout_equals_the_references(reference, monkeypatch,
                                               shape, size, torchrun):
    """The launcher builds a mesh at ``--mesh D,1`` as the reference's
    does: its Trainer's policies and layout are the reference Trainer's
    on that mesh."""
    step = _launcher_step(monkeypatch, size, shape, torchrun)
    want = reference[f"trainer/{size}/{shape[0]}x{shape[1]}/gbin_packed"]
    assert _policies(step.policies) == _ref_policies(want["policies"])
    assert _layout(step.layout) == _ref_layout(want["layout"])
    assert step.layout.num_launches == want["launches"] == 9


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("size", SIZES)
def test_a_worker_group_keeps_the_data_parallel_layout(reference, size,
                                                       plan):
    """``Fabric(group=VirtualGroup(4))`` (and the Trainer on it) has no
    model axis and no specs: every leaf is bucketed, as the reference's
    session without a mesh buckets them."""
    cfg = _cfg(size)
    like = init_params(cfg, device="meta")
    preset = plan_presets(error_feedback=True)[plan]
    want = _ref_layout(reference[f"group/{size}/{plan}"])
    fabric = Fabric(group=VirtualGroup(4))
    assert _layout(fabric.layout_for(like, preset)) == want
    assert not fabric.layout_for(like, preset).unfused
    step = _trainer_step(Fabric(num_workers=4), cfg, preset)
    assert _layout(step.layout) == want
    assert all(p.model_spec is None for p in T.leaves(step.policies))


def test_a_virtual_mesh_is_the_process_meshs_layout_and_refuses_a_model_axis():
    """``VirtualMesh((4, 1))``: the same policies and layout as a
    ``ProcessMesh((4, 1))``'s rank, its data group four virtual workers;
    a model axis above 1 needs a process a rank."""
    cfg = _cfg("smoke")
    preset = plan_presets(error_feedback=True)["gbin_packed"]
    mesh = VirtualMesh((4, 1))
    assert mesh.data_group.size == 4 and mesh.data_axes == ("data",)
    virtual = _trainer_step(Fabric(mesh=mesh), cfg, preset)
    with fake_world(4):
        rank = _trainer_step(Fabric(mesh=ProcessMesh((4, 1), device="meta")),
                             cfg, preset)
    assert _layout(virtual.layout) == _layout(rank.layout)
    assert _policies(virtual.policies) == _policies(rank.policies)
    assert VirtualMesh((2, 2, 1)).data_axes == ("pod", "data")
    for shape in ((2, 2), (4,), (1, 2, 2)):
        with pytest.raises(ValueError, match="model axis"):
            VirtualMesh(shape)
