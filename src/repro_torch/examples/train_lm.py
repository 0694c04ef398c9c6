"""End-to-end LM training: train a configurable LM for a few
hundred steps on a learnable synthetic Markov stream with the full
stack — a (data, model) process mesh, low-bit aggregation, ZeRO-1,
checkpointing.

Port of ``examples/train_lm.py``.  The default is a CPU-sized model;
``--preset 100m`` selects a ~100M-parameter bf16 configuration.  The
mesh is (WORLD_SIZE / 2) x 2, as the reference lays out its devices.
Run:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      -m repro_torch.examples.train_lm --device cpu --steps 200
"""
import argparse
import os

from repro_torch.examples import init_mesh, lead
from repro_torch.models import ModelConfig

PRESETS = {
    "tiny": ModelConfig(name="tiny-lm", family="dense", num_layers=4,
                        d_model=128, num_heads=8, num_kv_heads=4, d_ff=512,
                        vocab_size=2048, dtype="float32", remat=False),
    "20m": ModelConfig(name="lm-20m", family="dense", num_layers=8,
                       d_model=384, num_heads=8, num_kv_heads=4, d_ff=1536,
                       vocab_size=8192, qk_norm=True, dtype="float32",
                       remat=True),
    "100m": ModelConfig(name="lm-100m", family="dense", num_layers=12,
                        d_model=768, num_heads=12, num_kv_heads=4,
                        d_ff=3072, vocab_size=32768, qk_norm=True,
                        dtype="bfloat16", remat=True),
}


def main(argv=None, *, steps: int = 200, batch: int = 16,
         seq_len: int = 128):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--batch", type=int, default=batch)
    ap.add_argument("--seq-len", type=int, default=seq_len)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--plan", default="gbin_packed",
                    choices=["fp32", "gbin", "gbin_packed"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core import AdmissionPlan, AggregationMode, Schedule
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = PRESETS[args.preset]
    ndev = int(os.environ.get("WORLD_SIZE", "1"))
    model_par = 2 if ndev % 2 == 0 else 1
    mesh, device = init_mesh((ndev // model_par, model_par), args.device)

    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=args.seq_len,
                             batch=args.batch, seed=0)
    plan = {
        "fp32": AdmissionPlan.fp32_all(),
        "gbin": AdmissionPlan.lowbit_backbone(AggregationMode.G_BINARY),
        "gbin_packed": AdmissionPlan.lowbit_backbone(
            AggregationMode.G_BINARY, schedule=Schedule.PACKED_A2A),
    }[args.plan]

    try:
        trainer = Trainer(
            cfg, AdamW(peak_lr=args.lr, total_steps=args.steps), data,
            plan=plan, fabric=Fabric(mesh=mesh),
            tcfg=TrainerConfig(log_interval=20, checkpoint_interval=100),
            ckpt_dir=args.ckpt_dir, device=device)
        hist = trainer.run(args.steps)
    finally:
        dist.destroy_process_group()
    first10 = float(np.mean([h["loss"] for h in hist[:10]]))
    last10 = float(np.mean([h["loss"] for h in hist[-10:]]))
    if lead():
        print(f"\n{cfg.name}: loss {first10:.3f} -> {last10:.3f} "
              f"({args.steps} steps, traffic "
              f"{hist[-1]['traffic_ratio']:.4f}x)")
    return hist


if __name__ == "__main__":
    main()
