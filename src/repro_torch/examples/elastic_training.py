"""Elastic training end-to-end: crash, rejoin, stragglers, replay.

Runs a tiny LM over four virtual workers (on one device — no cluster
needed) through a scripted fault scenario:

  * worker 3 **crashes** at step 9 and rejoins at step 14 — the
    trainer rolls back to the last durable checkpoint, replays the lost
    step under the 3-worker fleet, and re-plans again when the worker
    returns;
  * worker 1 **straggles** 6x from step 3 to 12 — the detector flags
    it from per-worker step times, and the ``straggler_aware``
    controller demotes the backbone to G-Binary, recovering to FP32
    once the fleet is stable again.

The same scenario then replays offline through the simulator
(:func:`repro_torch.elastic.replay_schedule`), printing the per-phase
exposed-time decomposition.

Port of ``examples/elastic_training.py``.  Run:

  PYTHONPATH=src python -m repro_torch.examples.elastic_training --device cpu
"""
import argparse
import tempfile

from repro_torch.data import SyntheticLMStream
from repro_torch.elastic import (ElasticConfig, ElasticTrainer,
                                 StragglerAwareController, replay_schedule)
from repro_torch.models import ModelConfig, init_params
from repro_torch.optim import SgdMomentum

WORKERS = 4
STEPS = 24
FAULTS = [("crash", {"worker": 3, "step": 9, "rejoin_step": 14}),
          ("straggler", {"worker": 1, "start": 3, "stop": 12,
                         "factor": 6.0})]


def main(argv=None, *, steps: int = STEPS):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(name="elastic-demo", family="dense", num_layers=2,
                      d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                      vocab_size=128, dtype="float32", remat=False)
    data = SyntheticLMStream(vocab=128, seq_len=16, batch=4, seed=0)
    controller = StragglerAwareController(demote_after=2, recover_after=6)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = ElasticTrainer(
            cfg, SgdMomentum(peak_lr=0.1, total_steps=2 * steps), data,
            WORKERS, controller=controller, faults=FAULTS,
            ckpt_dir=ckpt_dir,
            ecfg=ElasticConfig(checkpoint_interval=4,
                               synthetic_step_time_s=1e-3,
                               log_interval=10_000),
            device=args.device)
        history = trainer.run(steps)

    print(f"{'step':>4} {'W':>2} {'epoch':>5} {'loss':>7} "
          f"{'stragglers':>10}  plan")
    for h in history:
        print(f"{h['step']:>4} {h['num_workers']:>2} "
              f"{h['membership_epoch']:>5} {h['loss']:>7.4f} "
              f"{str(h['stragglers']):>10}  {h['plan'][:40]}")

    report = trainer.report()
    print(f"\nrestarts={report['restarts']} "
          f"replayed_steps={report['replayed_steps']} "
          f"traffic_overhead={report['traffic_overhead']:.4f}x "
          f"compiled_steps={report['compiled_steps']}")
    for rec in report["recoveries"]:
        print(f"crash at step {rec['crash_step']}: restored step "
              f"{rec['restored_step']} ({rec['steps_to_recover']} lost)")
    for ev in controller.events:
        print(f"controller {ev.kind} at step {ev.step}")

    # price the same schedule offline through the simulator
    params = init_params(cfg, device="meta")
    replay = replay_schedule(params, controller.lowbit_plan, WORKERS,
                             steps, faults=FAULTS, topology="cxl_direct",
                             compute_time_s=1e-4)
    print(f"\nreplay: {len(replay.phases)} phases, "
          f"total={replay.total_time_s * 1e3:.3f} ms, "
          f"exposed={replay.exposed_pct:.2f}%")
    for p in replay.phases:
        print(f"  steps [{p.start},{p.stop}) W={p.num_workers} "
              f"epoch={p.epoch} straggler={p.straggler_scale:.1f}x "
              f"step={p.step_time_s * 1e3:.4f} ms "
              f"exposed={p.exposed_pct:.2f}%")
    return history


if __name__ == "__main__":
    main()
