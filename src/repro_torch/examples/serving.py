"""Continuous-batching serving example: paged KV cache + sim replay.

Serves a staggered multi-request trace through
:class:`repro_torch.serve.ServeEngine` on a block pool small enough to
force preemption and CXL spill, with the KV cache quantized through the
``int4`` codec, then replays the decode timeline's fabric traffic on
both CXL topologies.

Port of ``examples/serving.py``.  Run:

  PYTHONPATH=src python -m repro_torch.examples.serving --device cpu
"""
import argparse
import time

from repro_torch.models import ModelConfig
from repro_torch.serve import ServeEngine

TRACE = (
    {"prompt": [11, 7, 5, 3, 2, 13, 17, 19], "max_new_tokens": 10,
     "arrival_step": 0},
    {"prompt": [4, 8, 15, 16, 23, 42], "max_new_tokens": 12,
     "arrival_step": 0},
    {"prompt": [1, 2, 3, 5, 8, 13, 21, 34, 55], "max_new_tokens": 8,
     "arrival_step": 1},
    {"prompt": [9, 9, 9, 9, 9], "max_new_tokens": 11, "arrival_step": 3},
)
CONFIG = ModelConfig(name="serving_toy", family="dense", num_layers=2,
                     d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                     vocab_size=97, dtype="float32", remat=False)


def main(argv=None, *, params=None):
    """``params`` (a parameter tree on the device) replaces the engine's
    seeded weights, as a caller holding another implementation's draws
    passes them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = CONFIG
    eng = ServeEngine(cfg, params, max_batch=3, max_seq=32, num_blocks=10,
                      block_size=4, kv_codec="int4", policy="fcfs",
                      device=args.device)

    t0 = time.perf_counter()
    outputs = eng.serve(TRACE)
    dt = time.perf_counter() - t0

    tl = eng.timeline()
    print(f"served {len(outputs)} requests, {tl.total_new_tokens} tokens "
          f"in {tl.num_steps} steps / {dt:.2f}s "
          f"({tl.total_new_tokens / dt:.1f} tok/s on {eng.device.type})")
    print(f"preemptions={tl.total_preemptions} "
          f"spills={eng.cache.tier.spills} fetches={eng.cache.tier.fetches} "
          f"kv_wire_bytes={tl.total_wire_bytes:.0f} (int4-priced)")
    for rid, toks in sorted(outputs.items()):
        print(f"  request {rid}: {toks}")

    for topo in ("cxl_direct", "cxl_switched"):
        rep = eng.simulate(tl, topology=topo, step_compute_s=1e-3)
        print(f"sim/{topo}: step_time={rep.step_time_s * 1e3:.2f}ms "
              f"launches={rep.num_launches} "
              f"exposed={rep.exposed_pct:.1f}%")

    assert all(len(t) == e["max_new_tokens"]
               for t, e in zip((outputs[r] for r in sorted(outputs)), TRACE))
    assert tl.total_preemptions > 0
    print("OK")
    return outputs


if __name__ == "__main__":
    main()
