"""The port's checkpointing and fault utilities, in one process on the CPU.

  * ``CheckpointManager``: a leftover ``.tmp`` is never restored,
    retention under ``keep``, ``wait()`` fences the async save, the
    controller's state rides in ``extra`` and comes back, and the
    snapshot is taken before ``maybe_save`` returns (parameters updated
    in place right after the call do not reach the checkpoint);
  * the on-disk format is the reference's: the port restores a float32
    smoke-model train state written by ``repro.checkpoint.save_checkpoint``
    and the reference restores the port's, leaf for leaf; bfloat16
    arrays are stored as the reference's ``ml_dtypes`` ones (raw 2-byte
    words) and read back bit for bit;
  * the Trainer restores on start and refuses a failure without
    checkpointing; ``StragglerWatchdog`` and ``FailureInjector`` as the
    reference's (``tests/test_distributed.py::test_straggler_watchdog``).
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import restore_latest as j_restore_latest  # noqa: E402
from repro.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.fabric.session import TrainState as JTrainState  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    load_train_state, restore_latest,
                                    save_checkpoint, train_state_arrays)
from repro_torch.checkpoint import manager as M  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data import SyntheticLMStream  # noqa: E402
from repro_torch.fabric import (Fabric, TrainState, make_controller,  # noqa: E402
                                plan_presets)
from repro_torch.models import ModelConfig, Transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import (FailureInjector, SimulatedFailure,  # noqa: E402
                                 StragglerWatchdog, Trainer, TrainerConfig)


def _tree(step):
    return {"params/w": torch.full((4, 4), float(step)),
            "params/b": torch.zeros(4), "step": torch.tensor(step)}


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

def test_save_restore_round_trip_and_format(tmp_path):
    d = str(tmp_path)
    path = save_checkpoint(d, 7, _tree(7), extra={"plan": "fp32"})
    assert os.path.basename(path) == "step_0000000007"
    step, arrays, extra = restore_latest(d)
    assert step == 7 and extra["plan"] == "fp32"
    assert torch.equal(arrays["params/w"], torch.full((4, 4), 7.0))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["names"] == ["params/w", "params/b", "step"]
    assert manifest["dtypes"] == ["float32", "float32", "int64"]
    assert manifest["shapes"] == [[4, 4], [4], []]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert sorted(data.files) == ["a0", "a1", "a2"]


def test_leftover_tmp_is_never_restored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(3))
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))   # a crash mid-save
    with open(os.path.join(d, "step_0000000009.tmp", "garbage"), "w") as f:
        f.write("partial")
    assert restore_latest(d)[0] == 3
    assert restore_latest(str(tmp_path / "nope")) is None


def test_retention_keeps_the_last_k(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        save_checkpoint(d, s, _tree(s), keep=3)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == [f"step_{s:010d}" for s in (3, 4, 5)]
    assert restore_latest(d)[0] == 5


def test_async_manager_fences_on_wait(tmp_path):
    m = CheckpointManager(str(tmp_path), interval=2, keep=2)
    saved = [m.maybe_save(s, _tree(s)) for s in range(5)]
    assert saved == [True, False, True, False, True] and m.saves == 3
    m.wait()
    step, arrays, _ = m.restore()
    assert step == 4
    assert torch.equal(arrays["params/w"], torch.full((4, 4), 4.0))


def test_snapshot_is_taken_before_maybe_save_returns(tmp_path, monkeypatch):
    """The writer thread is held until the caller has updated the
    parameters in place: the checkpoint still holds the old values."""
    release = threading.Event()
    savez = np.savez

    def held_savez(*args, **kwargs):
        assert release.wait(timeout=30)
        return savez(*args, **kwargs)

    monkeypatch.setattr(M.np, "savez", held_savez)
    tree = _tree(1)
    m = CheckpointManager(str(tmp_path), interval=1)
    calls = []
    assert m.maybe_save(1, lambda: calls.append(1) or tree)
    tree["params/w"].add_(100.0)              # the next step, in place
    release.set()
    m.wait()
    assert calls == [1]
    _, arrays, _ = restore_latest(str(tmp_path))
    assert torch.equal(arrays["params/w"], torch.full((4, 4), 1.0))


def test_writer_error_is_raised_by_wait(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(M.np, "savez", broken)
    m = CheckpointManager(str(tmp_path), interval=1)
    m.maybe_save(1, _tree(1))
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    assert restore_latest(str(tmp_path)) is None


def _observed_paper_controller():
    ctl = make_controller("paper", warmup_steps=2)
    from repro_torch.fabric import Telemetry
    cos = {g: {"gbinary": 0.6, "gternary": 0.5}
           for g in ("backbone", "embed", "head", "norms")}
    for k in range(3):
        ctl.observe(Telemetry(step=k, loss=5.0 - k, cosines=cos))
    return ctl


def test_controller_state_rides_in_the_checkpoint(tmp_path):
    ctl = _observed_paper_controller()
    assert ctl.events
    m = CheckpointManager(str(tmp_path), interval=1)
    m.maybe_save(3, _tree(3), controller=ctl)
    fresh = make_controller("paper", warmup_steps=2)
    step, _, extra = m.restore(controller=fresh)
    assert step == 3 and extra["controller"]["name"] == "paper"
    assert fresh.state_dict() == ctl.state_dict()
    assert fresh.plan.signature() == ctl.plan.signature()
    # another policy keeps its own fresh state
    static = make_controller("static", plan=plan_presets()["gbin_packed"])
    before = static.state_dict()
    m.restore(controller=static)
    assert static.state_dict() == before


# ---------------------------------------------------------------------------
# interchange with the reference
# ---------------------------------------------------------------------------

def _port_state(cfg, seed=0):
    """A port TrainState with random moments, as after some steps."""
    model = Transformer(cfg, device="cpu", seed=seed)
    params = model.tree()
    opt = AdamW().init(params)
    gen = torch.Generator().manual_seed(seed + 1)
    for x in [*T.leaves(opt.mu), *T.leaves(opt.nu)]:
        x.copy_(torch.rand(x.shape, generator=gen))
    opt = opt._replace(step=torch.tensor(3, dtype=torch.int32))
    fabric = Fabric()
    ef = fabric.init_ef(params, fabric.resolve(params,
                                               plan_presets()["gbin_packed"]))
    return TrainState(model=model, opt=opt, ef=ef, step=7)


def _reference_state(seed=0):
    jcfg = j_get_config("qwen3_0p6b", smoke=True)
    params = j_init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    mu = jax.tree.map(lambda p: jnp.asarray(
        rng.rand(*p.shape).astype(np.float32)), params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        rng.rand(*p.shape).astype(np.float32)), params)
    opt = JOptState(step=jnp.asarray(5, jnp.int32), mu=mu, nu=nu)
    ef = jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)
    return JTrainState(params=params, opt=opt, ef=ef,
                       step=jnp.asarray(9, jnp.int32))


def test_port_restores_a_reference_checkpoint(tmp_path):
    jstate = _reference_state()
    j_save_checkpoint(str(tmp_path), 9, jstate)
    state = _port_state(get_config("qwen3_0p6b", smoke=True))
    step, arrays, _ = restore_latest(str(tmp_path))
    assert step == 9
    restored = load_train_state(state, arrays)
    assert restored.step == 9 and int(restored.opt.step) == 5
    assert restored.model is state.model               # in place
    for (p, got), want in zip(T.flatten(restored.model.tree()),
                              jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want), err_msg=p)
    for part in ("mu", "nu"):
        for got, want in zip(T.leaves(getattr(restored.opt, part)),
                             jax.tree.leaves(getattr(jstate.opt, part))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reference_restores_a_port_checkpoint(tmp_path):
    state = _port_state(get_config("qwen3_0p6b", smoke=True))
    save_checkpoint(str(tmp_path), 7, train_state_arrays(state))
    step, jtree, _ = j_restore_latest(str(tmp_path), _reference_state(1))
    assert step == 7 and int(jtree.step) == 7 and int(jtree.opt.step) == 3
    for got, (p, want) in zip(jax.tree.leaves(jtree.params),
                              T.flatten(state.model.tree())):
        np.testing.assert_array_equal(np.asarray(got),
                                      want.detach().numpy(), err_msg=p)
    for got, want in zip(jax.tree.leaves(jtree.opt.nu),
                         T.leaves(state.opt.nu)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_bfloat16_is_stored_as_the_reference_stores_it(tmp_path):
    x = torch.randn(5, 3).to(torch.bfloat16)
    x[0, :3] = torch.tensor([-0.0, float("nan"), float("inf")])
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(mine, 1, {"x": x})
    words = x.view(torch.int16).numpy()
    j_save_checkpoint(theirs, 1, {"x": words.view(ml_dtypes.bfloat16)})
    for d in (mine, theirs):
        path = os.path.join(d, "step_0000000001")
        with open(os.path.join(path, "manifest.json")) as f:
            assert json.load(f)["dtypes"] == ["bfloat16"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            assert data["a0"].dtype == np.dtype("V2")
        _, arrays, _ = restore_latest(d)
        assert arrays["x"].dtype == torch.bfloat16
        assert torch.equal(arrays["x"].view(torch.int16), x.view(torch.int16))


def test_load_refuses_a_tree_of_another_shape(tmp_path):
    cfg = get_config("qwen3_0p6b", smoke=True)
    state = _port_state(cfg)
    arrays = dict(train_state_arrays(state))
    del arrays["opt/nu/head/w"]
    with pytest.raises(ValueError, match="missing"):
        load_train_state(_port_state(cfg), arrays)
    arrays = train_state_arrays(_port_state(cfg))
    arrays["params/head/w"] = arrays["params/head/w"].to(torch.float64)
    with pytest.raises(ValueError, match="params/head/w"):
        load_train_state(_port_state(cfg), arrays)


# ---------------------------------------------------------------------------
# the Trainer's checkpoint path and the fault utilities
# ---------------------------------------------------------------------------

CFG = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                  num_heads=2, num_kv_heads=1, d_ff=64, vocab_size=64,
                  dtype="float32", remat=False)


def _trainer(ckpt_dir=None, **kw):
    data = SyntheticLMStream(vocab=64, seq_len=8, batch=4, seed=0)
    return Trainer(CFG, AdamW(peak_lr=3e-3, warmup_steps=2, total_steps=20),
                   data, plan=plan_presets()["gbin_packed"],
                   fabric=Fabric(num_workers=2), device="cpu",
                   ckpt_dir=ckpt_dir, tcfg=TrainerConfig(
                       checkpoint_interval=3, checkpoint_keep=2), **kw)


def test_trainer_restores_on_start_and_continues(tmp_path):
    whole = _trainer()
    whole.run(8)
    first = _trainer(str(tmp_path))
    first.run(5)                      # saves at 3 and (forced) at 5
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000005"]
    second = _trainer(str(tmp_path))
    second.run(8)
    assert second.history[0]["step"] == 5
    assert [h["loss"] for h in second.history] == \
        [h["loss"] for h in whole.history[5:]]
    for a, b in zip(T.leaves(second.state.model.tree()),
                    T.leaves(whole.state.model.tree())):
        assert torch.equal(a, b)


def test_failure_without_checkpointing_raises():
    tr = _trainer(failure_injector=FailureInjector(at_steps=[1]))
    with pytest.raises(RuntimeError, match="without checkpointing"):
        tr.run(3)


def test_restarts_are_bounded(tmp_path):
    tr = Trainer(CFG, AdamW(), SyntheticLMStream(vocab=64, seq_len=8,
                                                 batch=4, seed=0),
                 fabric=Fabric(num_workers=2), device="cpu",
                 ckpt_dir=str(tmp_path),
                 tcfg=TrainerConfig(max_restarts=1),
                 failure_injector=FailureInjector(at_steps=[1, 2]))
    with pytest.raises(SimulatedFailure, match="step 2"):
        tr.run(4)
    assert tr.restarts == 2


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0, warmup=2)
    flags = [wd.observe(i, d) for i, d in
             enumerate([1.0, 1.0, 1.0, 1.05, 5.0, 1.0])]
    assert flags == [False, False, False, False, True, False]
    assert len(wd.events) == 1 and wd.events[0].step == 4
    # the EWMA is not polluted by the straggler sample
    assert wd.ewma < 1.2


def test_failure_injector_fires_once_per_step():
    inj = FailureInjector(at_steps=[2, 4])
    inj.check(1)
    with pytest.raises(SimulatedFailure, match="step 2"):
        inj.check(2)
    inj.check(2)                       # fired already
    with pytest.raises(SimulatedFailure):
        inj.check(4)
