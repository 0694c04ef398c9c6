"""The reference's legacy and session surface in the port, on the CPU.

  * every name of the reference's public surface (a module's
    ``__all__``, or its public top-level functions and classes where it
    has none) has its counterpart in the matching ``repro_torch``
    module, but for three JAX-only names (``JAX_ONLY``, with why);
  * ``traffic_ratio``, ``all_configs``, ``path_name`` over the ten SMOKE
    trees, ``has_nu`` / ``state_has_nu`` and ``init_ef_states`` equal the
    reference's;
  * ``aggregate_gradients`` and ``aggregate_leaf`` on W = 4 virtual
    workers against the reference's under ``jax.vmap``: votes byte-equal,
    FP32 means and EF residuals to ``tests/test_torch_fabric.py``'s
    bounds (rtol 1e-6; ``1e-6 * beta``, since ``beta = mean|x|`` is an
    FP32 mean the two frameworks sum in different orders), the residuals
    byte-equal to the port's own ``Fabric(fused=False)``;
  * ``build_train_step``: ``aux`` against the reference's
    ``build_train_step`` on the CPU's one-device mesh, the
    ``state_shardings`` against the reference's spec functions on fake
    (2, 2) and (2, 4) meshes, two ``CompiledStep`` steps bit-equal to
    ``Fabric.build_step``'s, and ``fused=False`` per call;
  * the block initializers' keys, shapes and dtypes against the
    reference's blocks, and ``init_params``' bits pinned.

On a mesh, ``build_train_step`` resolves its policies with the specs
whatever the model extent, as the reference's mesh step does, so a leaf
specced over ``"model"`` keeps its own launch at a model extent of 1 and
``aux["layout"]`` equals the reference's step's launch for launch on the
SMOKE model and on full qwen3-0.6B.  On a worker group the moments'
specs are the parameters' (the state holds them whole), and each
moment's shape is its spec's block.  ``tests/test_torch_tp.py`` steps
``build_train_step`` on gloo meshes against ``Fabric(mesh=...)``.
"""
import ast
import dataclasses
import hashlib
import importlib
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro  # noqa: E402
from repro.configs import all_configs as j_all_configs  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import AdmissionPlan as JPlan  # noqa: E402
from repro.core import AggregationMode as JMode  # noqa: E402
from repro.core import GroupPolicy as JGroupPolicy  # noqa: E402
from repro.core import aggregate_gradients as j_aggregate_gradients  # noqa: E402
from repro.core import aggregate_leaf as j_aggregate_leaf  # noqa: E402
from repro.core import init_ef_states as j_init_ef_states  # noqa: E402
from repro.core import make_policy_tree as j_make_policy_tree  # noqa: E402
from repro.core import path_name as j_path_name  # noqa: E402
from repro.core import traffic_ratio as j_traffic_ratio  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric.control import plan_presets as j_plan_presets  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import param_pspecs as j_param_pspecs  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import SgdMomentum as JSgdMomentum  # noqa: E402
from repro.optim import optimizer_state_pspecs as j_opt_pspecs  # noqa: E402
from repro.optim.optimizers import state_has_nu as j_state_has_nu  # noqa: E402
from repro.runtime import build_train_step as j_build_train_step  # noqa: E402
from repro.runtime.shardings import sanitize_pspecs as j_sanitize  # noqa: E402
from repro_torch.configs import ARCH_IDS, all_configs, get_config  # noqa: E402
from repro_torch.core import (AdmissionPlan, AggregationMode,  # noqa: E402
                              GroupPolicy, ProcessMesh, VirtualGroup,
                              aggregate_gradients, aggregate_leaf,
                              codec_name, init_ef_states, make_policy_tree,
                              path_name, schedule_name, traffic_ratio)
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.fabric import (CompiledStep, Fabric, TrainState,  # noqa: E402
                                dp_num_workers, plan_presets)
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.models import Transformer, init_params  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.optim import AdamW, SgdMomentum  # noqa: E402
from repro_torch.optim.optimizers import state_has_nu  # noqa: E402
from repro_torch.runtime import build_train_step  # noqa: E402
from repro_torch.runtime.shardings import local_shape  # noqa: E402

REF = pathlib.Path(repro.__file__).parent

#: the reference's public names that have no counterpart, and why
JAX_ONLY = {
    "kernels.ops.interpret_default":
        "Pallas interpret mode: the port's kernels have none; a CPU "
        "tensor runs their plain twins",
    "runtime.shardings.named_shardings":
        "jax.sharding.NamedSharding: the port's specs are tuples with no "
        "device mesh object behind them",
    "models.layers.shard":
        "jax.lax.with_sharding_constraint: GSPMD hints; the port's "
        "tensor parallelism places its blocks explicitly",
}

#: reference modules the port folded into another (PR 27): a trace of
#: the step on ``meta`` in place of XLA's HLO text
FOLDED = {"launch.hlo_analysis": "launch.analysis",
          "launch.hlo_walk": "launch.analysis"}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(REF).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _public(path: pathlib.Path) -> tuple[list, bool]:
    """A reference module's ``__all__`` (True), or its public top-level
    functions and classes (False)."""
    body = ast.parse(path.read_text()).body
    for node in body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value)), True
    return [n.name for n in body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")], False


REF_MODULES = sorted(_module_name(p) for p in REF.rglob("*.py"))


def _port(mod: str):
    return importlib.import_module("repro_torch" + (f".{mod}" if mod else ""))


@pytest.mark.parametrize("mod", [m for m in REF_MODULES if m not in FOLDED])
def test_public_surface_has_its_counterpart(mod):
    path = REF.joinpath(*mod.split(".")) if mod else REF
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    names, has_all = _public(path)
    port = _port(mod)
    port_all = getattr(port, "__all__", None)
    for name in names:
        qual = f"{mod}.{name}"
        # a package's re-export of a JAX-only name is JAX-only too
        if qual in JAX_ONLY or any(q.startswith(f"{mod}.")
                                   and q.endswith(f".{name}")
                                   for q in JAX_ONLY):
            assert not hasattr(port, name), qual
            continue
        assert hasattr(port, name), qual
        if has_all and port_all is not None:
            assert name in port_all, qual


def test_only_the_folded_modules_lack_a_port_file():
    missing = {m for m in REF_MODULES
               if importlib.util.find_spec(
                   "repro_torch" + (f".{m}" if m else "")) is None}
    assert missing == set(FOLDED)
    analysis = _port("launch.analysis")
    for name in ("CollectiveOp", "summarize_collectives", "roofline_terms"):
        assert hasattr(analysis, name)


def test_traffic_ratio_and_all_configs_equal_the_references():
    for mode in [*AggregationMode, "int4", "topk"]:
        jmode = JMode(mode.value) if isinstance(mode, AggregationMode) \
            else mode
        assert traffic_ratio(mode) == j_traffic_ratio(jmode), mode
    for smoke in (False, True):
        got, want = all_configs(smoke), j_all_configs(smoke)
        assert list(got) == list(want) == list(ARCH_IDS)
        assert {a: dataclasses.asdict(c) for a, c in got.items()} == \
            {a: dataclasses.asdict(c) for a, c in want.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_path_name_gives_the_references_names(arch):
    jlike = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                 j_get_config(arch, True)))
    jpaths = [kp for kp, _ in jax.tree_util.tree_flatten_with_path(jlike)[0]]
    want = [j_path_name(kp) for kp in jpaths]
    got = [p for p, _ in T.flatten(init_params(get_config(arch, True),
                                               device="meta"))]
    assert got == want
    # the reference's key path objects, and str / int entries
    assert [path_name(kp) for kp in jpaths] == want
    assert [path_name([int(k) if k.isdigit() else k for k in p.split("/")])
            for p in got] == want


@pytest.mark.parametrize("opt", ["adamw", "sgd", "nesterov"])
def test_has_nu_equals_the_references(opt):
    got, want = {"adamw": (AdamW(), JAdamW()),
                 "sgd": (SgdMomentum(), JSgdMomentum()),
                 "nesterov": (SgdMomentum(nesterov=True),
                              JSgdMomentum(nesterov=True))}[opt]
    assert got.has_nu == want.has_nu == state_has_nu(got) \
        == j_state_has_nu(want) == (opt == "adamw")

    class Probed(type(got)):            # a duck-typed subclass's own flag
        has_nu = False
    assert Probed().has_nu is False and state_has_nu(Probed()) == got.has_nu


def _smoke():
    return get_config("qwen3_0p6b", True), j_get_config("qwen3_0p6b", True)


def _like(cfg, jcfg):
    return (init_params(cfg, device="meta"),
            jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), jcfg)))


def test_init_ef_states_equal_the_references():
    cfg, jcfg = _smoke()
    like, jlike = _like(cfg, jcfg)
    params = T.map_leaves(lambda x: torch.zeros(x.shape, dtype=x.dtype),
                          like)
    plan, jplan = (plan_presets(error_feedback=True)["gbin_packed"],
                   j_plan_presets(error_feedback=True)["gbin_packed"])
    got = init_ef_states(params, make_policy_tree(params, plan))
    want = j_init_ef_states(jlike, j_make_policy_tree(jlike, jplan))
    on = 0
    for (path, e), w in zip(T.flatten(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        assert tuple(e.shape) == w.shape and e.dtype == torch.float32, path
        assert w.dtype == np.float32 and not e.any() and not w.any()
        on += e.dim() > 0
    assert on == 7                      # the seven backbone leaves
    # Fabric.init_ef builds its rows from it
    fab = Fabric(num_workers=3)
    rows = fab.init_ef(params, make_policy_tree(params, plan))
    for (path, r), e in zip(T.flatten(rows), T.leaves(got)):
        assert tuple(r.shape) == ((3, *e.shape[1:]) if e.dim() else ()), path


# ---------------------------------------------------------------------------
# aggregate_gradients / aggregate_leaf at W = 4
# ---------------------------------------------------------------------------

W = 4
LEAF = "layers/mlp/w_up"
CASES = [(plan, ef) for plan in ("fp32", "gbin_packed", "gtern_packed")
         for ef in (False, True)]


def _plan_pair(name: str, ef: bool):
    if name == "fp32":
        return (AdmissionPlan(default=GroupPolicy(AggregationMode.FP32,
                                                  error_feedback=ef)),
                JPlan(default=JGroupPolicy(JMode.FP32, error_feedback=ef)))
    if name == "gbin_packed":
        return (plan_presets(error_feedback=ef)[name],
                j_plan_presets(error_feedback=ef)[name])
    return (AdmissionPlan.lowbit_backbone(AggregationMode.G_TERNARY,
                                          "packed_a2a", ef),
            JPlan.lowbit_backbone(JMode.G_TERNARY, "packed_a2a", ef))


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def reference_aggregates():
    """Every case through the reference's free functions under one
    ``jax.jit(jax.vmap(..., axis_name="w"))`` each, on numpy gradients
    and residuals from one seed."""
    cfg, jcfg = _smoke()
    like, jlike = _like(cfg, jcfg)
    rng = np.random.RandomState(30)
    grads = T.map_leaves(
        lambda x: rng.randn(W, *x.shape).astype(np.float32), like)
    out = {}
    for name, ef in CASES:
        _, jplan = _plan_pair(name, ef)
        jpol = j_make_policy_tree(jlike, jplan)
        on = T.map_leaves(lambda e: e.ndim > 0,
                          j_init_ef_states(jlike, jpol))
        efs = T.map_leaves(
            lambda g, o: (rng.randn(*g.shape).astype(np.float32) if o
                          else np.zeros((W,), np.float32)), grads, on)
        leaf_pol = _at(jpol, LEAF)

        @jax.jit
        def run(gs, es):
            def one(g, e):
                agg, new = j_aggregate_gradients(g, jpol, "w", W,
                                                 e if ef else None)
                u, ue = j_aggregate_leaf(_at(g, LEAF), leaf_pol, "w", W,
                                         _at(e, LEAF) if ef and
                                         leaf_pol.error_feedback else None)
                return agg, new, u, ue
            return jax.vmap(one, axis_name="w")(gs, es)

        j_efs = T.map_leaves(lambda e, o: e[:, None] if o else e, efs, on)
        out[name, ef] = (grads, efs, on, run(
            T.map_leaves(jnp.asarray, grads), T.map_leaves(jnp.asarray,
                                                           j_efs)))
    return out


def _check_mean_or_vote(path, got, want, vote):
    if vote:
        assert got.numpy().tobytes() == want.tobytes(), path
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0,
                                   err_msg=path)


@pytest.mark.parametrize("name,ef", CASES)
def test_aggregate_gradients_and_leaf_equal_the_references(
        reference_aggregates, name, ef):
    grads, efs, on, (want, want_ef, want_u, want_ue) = \
        reference_aggregates[name, ef]
    plan, _ = _plan_pair(name, ef)
    tg = T.map_leaves(torch.from_numpy, grads)
    pol = make_policy_tree(T.map_leaves(lambda g: g[0], tg), plan)
    t_efs = T.map_leaves(lambda e, o: torch.from_numpy(e) if o
                         else torch.zeros(()), efs, on)
    # an int W is VirtualGroup(W); either way the group's size must agree
    got, got_ef = aggregate_gradients(tg, pol, W, W, t_efs if ef else None)
    with pytest.raises(ValueError, match="disagrees"):
        aggregate_gradients(tg, pol, VirtualGroup(W), W + 1)
    votes = {p for p, x in T.flatten(pol)
             if codec_name(x.mode) != "fp32"}
    assert bool(votes) == (name != "fp32")
    wd, wed = dict(T.flatten(want)), dict(T.flatten(want_ef or {}))
    for path, u in T.flatten(got):
        for k in range(W):
            _check_mean_or_vote(path, u, np.asarray(wd[path])[k],
                                path in votes)
    leaf_pol = _at(pol, LEAF)
    u, ue = aggregate_leaf(_at(tg, LEAF), leaf_pol, VirtualGroup(W), W,
                           _at(t_efs, LEAF) if ef and leaf_pol.error_feedback
                           else None)
    for k in range(W):
        _check_mean_or_vote(LEAF, u, np.asarray(want_u)[k], name != "fp32")
    if not ef:
        assert got_ef is None and ue is None
        return
    _, fab_ef = Fabric(num_workers=W, fused=False).aggregate(tg, pol, t_efs)
    assert _bits(got_ef) == _bits(fab_ef)
    grads_d, efs_d = dict(T.flatten(grads)), dict(T.flatten(efs))
    pol_d = dict(T.flatten(pol))
    for path, e in T.flatten(got_ef):
        if not dict(T.flatten(on))[path]:
            assert e.dim() == 0
            continue
        lowbit = codec_name(pol_d[path].mode) != "fp32"
        _close_residual(path, e, np.asarray(wed[path])[:, 0],
                        grads_d[path] + efs_d[path])
        # a vote codec updates the residual, FP32 carries it unchanged
        assert np.array_equal(e.numpy(), efs_d[path]) != lowbit, path
    if leaf_pol.error_feedback:
        # the reference's leaf shim hands back each worker's (1, *shape)
        # residual without its leading axis
        _close_residual(LEAF, ue, np.asarray(want_ue).reshape(ue.shape),
                        grads_d[LEAF] + efs_d[LEAF])


def _close_residual(path, got, want, x):
    """e' = x - beta * sgn(x): the FP32 mean beta = mean|x| may differ by
    rtol 1e-6 between the frameworks, which moves e' by 1e-6 * beta."""
    beta = np.abs(x).reshape(W, -1).mean(axis=1)
    err = np.abs(got.numpy() - want).reshape(W, -1)
    assert (err <= 1e-6 * beta[:, None]).all(), path


# ---------------------------------------------------------------------------
# build_train_step
# ---------------------------------------------------------------------------

def _units(layout):
    """A layout's launches in leaf order: (slot names and sizes, mode,
    wire schedule, dtype), a bucket's or an unfused leaf's."""
    units = [(b.slots[0].leaf, tuple((s.name, s.size) for s in b.slots),
              b.key) for b in layout.buckets]
    units += [(u.leaf, ((u.name, u.size),), u.key) for u in layout.unfused]
    return [(names, codec_name(getattr(key.mode, "value", key.mode)),
             str(getattr(key.schedule, "value", key.schedule)),
             str(key.dtype)) for _, names, key in sorted(units)]


def _slots(layout):
    return [[(s.leaf, s.name, tuple(s.shape), s.size, s.offset)
             for s in b.slots] for b in layout.buckets]


def _same_policies(got, want):
    for (path, a), b in zip(T.flatten(got), jax.tree_util.tree_leaves(
            want, is_leaf=lambda x: hasattr(x, "error_feedback"))):
        assert (codec_name(a.mode), schedule_name(a.schedule), a.gate_phase,
                a.error_feedback, a.model_spec) == (
            codec_name(getattr(b.mode, "value", b.mode)),
            schedule_name(getattr(b.schedule, "value", b.schedule)),
            b.gate_phase, b.error_feedback, _sharding(b.model_spec)), path


def _sharding(spec):
    """A reference policy's spec as the port stores it: None unless it
    shards a dimension."""
    return None if spec is None or all(e is None for e in spec) \
        else tuple(spec)


def _spec_leaves(tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)]


@pytest.fixture(scope="module")
def one_device():
    """The reference's and the port's ``build_train_step`` on a one-device
    (data 1, model 1) mesh, SMOKE and FULL qwen3-0.6B, gbin_packed with
    EF; the port's ProcessMesh under a fake one-rank process group."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    for smoke in (True, False):
        cfg, jcfg = (get_config("qwen3_0p6b", smoke),
                     j_get_config("qwen3_0p6b", smoke))
        like, jlike = _like(cfg, jcfg)
        plan = plan_presets(error_feedback=True)["gbin_packed"]
        jplan = j_plan_presets(error_feedback=True)["gbin_packed"]
        want = j_build_train_step(jcfg, jmesh, JAdamW(), jplan, jlike)
        with fake_world(1):
            got = build_train_step(cfg, ProcessMesh((1, 1), device="meta"),
                                   AdamW(), plan, like)
        out[smoke] = (got, want, like, jlike, jplan)
    return out


def test_aux_equals_the_references_on_a_one_device_mesh(one_device):
    for smoke, (got, want, like, jlike, jplan) in one_device.items():
        assert isinstance(got, CompiledStep) and len(got) == 4
        assert set(want.aux) <= set(got.aux)
        assert got.aux["num_workers"] == want.aux["num_workers"] == 1
        _same_policies(got.aux["policies"], want.aux["policies"])
        assert T.leaves(got.aux["groups"]) == \
            jax.tree_util.tree_leaves(want.aux["groups"])
        assert T.leaves(got.aux["pspecs"]) == _spec_leaves(want.aux["pspecs"])
        assert T.leaves(got.aux["ef_specs"]) == \
            _spec_leaves(want.aux["ef_specs"])
        assert got.batch_sharding == tuple(want.batch_sharding.spec)
        layout, jlayout = got.aux["layout"], want.aux["layout"]
        # launch for launch the reference's step, buckets slot for slot;
        # the "model"-specced leaves keep their own launches at extent 1
        assert _units(layout) == _units(jlayout)
        assert _slots(layout) == _slots(jlayout)
        specced = {p for p, s in T.flatten(got.aux["pspecs"])
                   if "model" in s}
        assert {u.name for u in layout.unfused} == \
            {u.name for u in jlayout.unfused} == specced
        assert len(specced) == (7 if smoke else 6)   # full ties its head
        assert got.aux["num_launches"] == layout.num_launches == \
            want.aux["num_launches"] == 9


@pytest.mark.parametrize("mesh", [(2, 2), (2, 4)])
@pytest.mark.parametrize("opt", ["adamw", "sgd"])
def test_state_shardings_equal_the_references_spec_functions(mesh, opt):
    """The specs of a (data, model) mesh's step, built on a fake process
    group's rank 0, against the reference's spec functions on the same
    extents; ZeRO-1 splits the moments over the data group."""
    cfg, jcfg = _smoke()
    like, jlike = _like(cfg, jcfg)
    optimizer = AdamW() if opt == "adamw" else SgdMomentum()
    plan = plan_presets(error_feedback=True)["gbin_packed"]
    jplan = j_plan_presets(error_feedback=True)["gbin_packed"]
    extents = {"data": mesh[0], "model": mesh[1]}
    with fake_world(mesh[0] * mesh[1]):
        pm = ProcessMesh(mesh, device="meta")
        got = build_train_step(cfg, pm, optimizer, plan, like)
        assert dp_num_workers(pm, ("data",)) == dp_num_workers(pm, "data") \
            == mesh[0] == got.aux["num_workers"]
        with pytest.raises(ValueError, match="data axes"):
            build_train_step(cfg, pm, optimizer, plan, like,
                             dp_axes=("pod", "data"))
    jspecs = j_sanitize(j_param_pspecs(jcfg), jlike,
                        types.SimpleNamespace(shape=extents))
    jpol = JFabric(dp_axes=("data",), num_workers=mesh[0]).resolve(
        jlike, jplan, pspecs=jspecs)
    jopt = _spec_leaves(j_opt_pspecs(jspecs, jlike, dp_axes=("data",),
                                     dp_size=mesh[0], zero1=True))
    jef = _spec_leaves(JFabric(dp_axes=("data",), num_workers=mesh[0])
                       .ef_specs(jpol, jspecs))
    sh = got.state_shardings
    assert isinstance(sh, TrainState) and sh.step == () and sh.opt.step == ()
    assert T.leaves(sh.model) == _spec_leaves(jspecs)
    assert T.leaves(sh.opt.mu) == jopt
    if opt == "adamw":
        assert T.leaves(sh.opt.nu) == jopt
    else:
        assert sh.opt.nu is None
    assert T.leaves(sh.ef) == jef == T.leaves(got.aux["ef_specs"])
    assert any(len(s) for s in jef)
    assert got.batch_sharding == ("data",)
    assert got.aux["zero"] is not None
    assert None not in got.aux["zero"].dims
    _same_policies(got.aux["policies"], jpol)


def _state(cfg, fabric, optimizer, policies, seed=0):
    model = Transformer(cfg, device="cpu", seed=seed)
    params = model.tree()
    return TrainState(model=model, opt=optimizer.init(params),
                      ef=fabric.init_ef(params, policies))


def _batch(cfg, rng):
    toks = rng.randint(0, cfg.vocab_size, (8, 17))
    return {"tokens": torch.from_numpy(toks[:, :-1]),
            "labels": torch.from_numpy(toks[:, 1:])}


def _bits(tree):
    return [x.detach().contiguous().view(torch.uint8).numpy().tobytes()
            if x.dim() else x.detach().reshape(1).view(torch.uint8)
            .numpy().tobytes() for x in T.leaves(tree)]


@pytest.mark.parametrize("ef", [False, True])
def test_compiled_step_is_bit_equal_to_the_sessions_step(ef):
    """Two steps of the legacy step on W = 4 virtual workers against
    ``Fabric(num_workers=4).build_step`` from the same state and
    batches: losses, parameters, moments, EF rows and aggregates."""
    torch.manual_seed(0)
    cfg = get_config("qwen3_0p6b", True)
    plan = plan_presets(error_feedback=ef)["gbin_packed"]
    like = init_params(cfg, device="meta")
    optimizer = AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    cs = build_train_step(cfg, W, optimizer, plan, like)
    assert cs.aux["zero"] is None and cs.aux["num_workers"] == W
    assert cs.aux["fabric"].dp_axes == ("data",)
    assert repr(cs.aux["fabric"]) == (
        "Fabric(num_workers=4, group=VirtualGroup(4), mesh=None)")
    fabric = Fabric(num_workers=W)
    a = _state(cfg, cs.aux["fabric"], optimizer, cs.aux["policies"])
    # no ZeRO-1 on a worker group: each moment is its spec's block, whole
    extents = {"data": W, "model": 1}
    sh = cs.state_shardings
    assert T.leaves(sh.opt.mu) == T.leaves(sh.opt.nu) == T.leaves(sh.model)
    for moments, specs in ((a.opt.mu, sh.opt.mu), (a.opt.nu, sh.opt.nu)):
        for (path, m), x, spec in zip(T.flatten(moments), T.leaves(like),
                                      T.leaves(specs)):
            assert tuple(m.shape) == local_shape(x.shape, spec, extents) \
                == tuple(x.shape), path
    b = _state(cfg, fabric, optimizer, cs.aux["policies"])
    step = fabric.build_step(optimizer, plan, like, b.model.loss)
    rng = np.random.RandomState(3)
    for k in range(2):
        batch = _batch(cfg, rng)
        b, mb, agg_b = step(b, batch)
        if k == 0:          # the legacy call: (state, metrics)
            a, ma = cs(a, batch)
        else:               # the port's step, with its aggregates
            a, ma, agg_a = cs.step_fn(a, batch)
            assert _bits(agg_a) == _bits(agg_b)
        assert set(ma) == set(mb) == {"loss", "agg_norm"}
        assert float(ma["loss"]) == float(mb["loss"]), k
        assert float(ma["agg_norm"]) == float(mb["agg_norm"]), k
        assert _bits(a.model.tree()) == _bits(b.model.tree()), k
        assert _bits(a.opt.mu) == _bits(b.opt.mu), k
        assert _bits(a.opt.nu) == _bits(b.opt.nu), k
        if ef:
            assert _bits(a.ef) == _bits(b.ef), k
    assert a.step == b.step == 2


def test_per_call_fused_gives_the_same_bits_and_its_own_cache_entry():
    cfg = get_config("qwen3_0p6b", True)
    plan = plan_presets(error_feedback=True)["gbin_packed"]
    like = init_params(cfg, device="meta")
    optimizer = AdamW(peak_lr=1e-3, warmup_steps=1)
    fabric = Fabric(num_workers=W)
    loss = Transformer(cfg, device="meta").loss
    fused = fabric.step_for(optimizer, plan, like, loss)
    per_leaf = fabric.step_for(optimizer, plan, like, loss, fused=False)
    assert per_leaf is not fused and len(fabric._steps) == 2
    assert fabric.step_for(optimizer, plan, like, loss, fused=True) is fused
    assert fused.layout is not None and per_leaf.layout is None
    policies = fused.policies
    states = [_state(cfg, fabric, optimizer, policies) for _ in range(2)]
    batch = _batch(cfg, np.random.RandomState(4))
    outs = [fn(s, batch) for fn, s in zip((fused, per_leaf), states)]
    assert float(outs[0][1]["loss"]) == float(outs[1][1]["loss"])
    assert _bits(outs[0][2]) == _bits(outs[1][2])
    assert _bits(outs[0][0].ef) == _bits(outs[1][0].ef)
    assert _bits(outs[0][0].model.tree()) == _bits(outs[1][0].model.tree())
    # aggregate takes the partition specs and the switch per call too
    agg, _ = Fabric(num_workers=W).aggregate(
        T.map_leaves(lambda x: torch.ones((W, *x.shape), dtype=x.dtype),
                     init_params(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))),
        plan, pspecs=None, fused=False)
    assert all(bool((x == 1).all()) for x in T.leaves(agg))


# ---------------------------------------------------------------------------
# the block initializers
# ---------------------------------------------------------------------------

def _shapes(tree):
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in T.flatten(tree)]


def _j_shapes(fn, *args):
    out = jax.eval_shape(lambda: fn(jax.random.PRNGKey(0), *args))
    return [(p, tuple(x.shape), str(x.dtype))
            for p, x in T.flatten(T.unflatten(
                [(j_path_name(kp), x) for kp, x in
                 jax.tree_util.tree_flatten_with_path(out)[0]]))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_initializers_have_the_references_keys_and_shapes(arch):
    cfg, jcfg = get_config(arch, True), j_get_config(arch, True)
    gen = torch.Generator().manual_seed(0)
    assert _shapes(L.init_rmsnorm(cfg.d_model, "cpu")) == \
        [(p, s, str(d)) for p, s, d in _shapes_of_j(
            JL.init_rmsnorm(cfg.d_model))]
    assert _shapes(L.init_attention(cfg, gen, "cpu")) == \
        _j_shapes(JL.init_attention, jcfg)
    assert _shapes(L.init_cross_attention(cfg, gen, "cpu")) == \
        _j_shapes(JL.init_cross_attention, jcfg)
    width = cfg.d_ff or 24
    assert _shapes(L.init_mlp(cfg, gen, "cpu", width)) == \
        _j_shapes(JL.init_mlp, jcfg, width)
    if cfg.moe is not None:
        assert _shapes(L.init_moe(cfg, gen, "cpu")) == \
            _j_shapes(JL.init_moe, jcfg)
    stacked = L.init_attention(cfg, gen, "meta", lead=(3,))
    assert [s for _, s, _ in _shapes(stacked)] == \
        [(3, *s) for _, s, _ in _j_shapes(JL.init_attention, jcfg)]


def _shapes_of_j(tree):
    return [(p, tuple(np.shape(x)), str(np.asarray(x).dtype))
            for p, x in T.flatten(tree)]


#: sha256 of init_params(SMOKE qwen3-0.6B, a CPU generator seeded 0) over
#: each leaf's path, dtype, shape and bytes in tree order, taken before the
#: initializers moved into models/layers.py
QWEN3_SMOKE_SHA256 = \
    "b7e99684e76fe66fd5604656691ada47bc46ee7152bbe6130a04d06ce4e91add"


def test_init_params_draws_the_same_bits():
    params = init_params(get_config("qwen3_0p6b", True),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    h = hashlib.sha256()
    for path, x in T.flatten(params):
        h.update(path.encode())
        h.update(str(x.dtype).encode())
        h.update(str(tuple(x.shape)).encode())
        h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == QWEN3_SMOKE_SHA256
