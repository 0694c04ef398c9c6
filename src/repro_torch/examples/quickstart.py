"""Quickstart: train a small LM with NEURON-Fabric low-bit gradient
aggregation on a (data 4) x (model 2) process mesh, watching traffic
drop ~28x for the admitted backbone while loss converges.

Port of ``examples/quickstart.py``.  Run (eight ranks; ``--device cpu``
on the CPU over gloo, ``cuda:0`` for eight ranks on one card):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      -m repro_torch.examples.quickstart --device cpu
"""
import argparse

from repro_torch.examples import init_mesh, lead


def main(argv=None, *, steps: int = 120, batch: int = 16,
         seq_len: int = 64):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=steps)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import AdmissionPlan, AggregationMode, Schedule
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, layout_kernel_stats
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig

    # 8 ranks: 4-way data parallel x 2-way tensor parallel
    mesh, device = init_mesh((4, 2), args.device)
    try:
        # One Fabric session owns the aggregation surface: worker count,
        # policy resolution, schedule-backend dispatch.
        fabric = Fabric(mesh=mesh)

        cfg = get_config("qwen3_0p6b", smoke=True)  # reduced qwen3 family
        data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=seq_len,
                                 batch=batch, seed=0)

        # The paper's recovered operating point: G-Binary backbone via the
        # packed controller schedule, FP32 head/embeddings/norms.
        plan = AdmissionPlan.lowbit_backbone(AggregationMode.G_BINARY,
                                             schedule=Schedule.PACKED_A2A)

        # Simulate the plan before training it: the bucket layout the
        # train step will launch, replayed by the discrete-event
        # simulator on two interconnects.
        params = init_params(cfg, device="meta")
        for topo in ("ici_ring", "cxl_switched"):
            rep = fabric.simulate(params, plan, topology=topo,
                                  compute_time_s=1e-3)
            state = "hidden" if rep.hidden else "exposed"
            if lead():
                print(f"[sim:{topo}] launches={rep.num_launches} "
                      f"step={rep.step_time_s * 1e3:.2f}ms "
                      f"exposed={rep.exposed_pct:.2f}% of step "
                      f"(datapath {state})")

        # Fused datapath: codecs that bring a kernel set run each bucket's
        # encode -> vote -> decode as fused CUDA kernels, bit-identical to
        # the staged path, with fewer launches and less memory traffic.
        layout = fabric.layout_for(params, plan)
        stats = layout_kernel_stats(layout, fabric.num_workers)
        if lead():
            print(f"[kernels] buckets={stats['collectives']} "
                  f"launches fused={stats['launches_fused']} "
                  f"vs unfused={stats['launches_unfused']}, HBM/step "
                  f"{stats['hbm_bytes_fused'] / 2**20:.0f}MiB fused vs "
                  f"{stats['hbm_bytes_unfused'] / 2**20:.0f}MiB unfused "
                  f"(opt out: Fabric(..., fused_kernels=False))")
        assert stats["launches_fused"] < stats["launches_unfused"]

        trainer = Trainer(cfg, AdamW(peak_lr=2e-3, total_steps=200), data,
                          plan=plan, fabric=fabric,
                          tcfg=TrainerConfig(log_interval=20), device=device)
        history = trainer.run(args.steps)
    finally:
        dist.destroy_process_group()

    first, last = history[0], history[-1]
    if lead():
        print(f"\nloss {first['loss']:.3f} -> {last['loss']:.3f} over "
              f"{len(history)} steps")
        print(f"gradient traffic vs FP32: {last['traffic_ratio']:.4f} "
              f"(G-Binary backbone + FP32 head)")
    assert last["loss"] < first["loss"], "did not converge"
    if lead():
        print("OK")
    return history


if __name__ == "__main__":
    main()
