"""Drive the PyTorch/CUDA port of NEURON-Fabric on one GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. require CUDA; print the card's name and power limit;
  2. build every kernel of the main path from ``src/repro_torch/csrc``
     (one ``nvcc`` per source, in parallel) into ``build/kernels``;
  3. hold each kernel (sign_pack, vote_combine, unpack_ternary) against
     its plain PyTorch twin on the card, byte for byte: ragged sizes,
     W in {1, 3, 4, 31, 128, 256}, G-Binary and G-Ternary gates, float32
     and bfloat16 planes, and the main path's largest bucket
     (88,080,384 bf16 elements, W = 4), where each kernel is timed
     against its twin and its memory bound;
  4. train the full qwen3-0.6B (28 layers, d 1024, vocab 151,936, bf16,
     remat) for 5 AdamW steps with W = 4 virtual data-parallel workers
     under the ``gbin_packed`` plan, global batch 16 x 128 tokens, and
     check: finite losses, backbone aggregates in {-1, 0, +1}, every
     kernel launched once per low-bit bucket per step, and one step's
     aggregates equal to the plain twins' on the same per-worker grads;
  5. print the kernels line, then ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bounds below
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, for the operation bound
OPS_PER_S = 67e12
MAIN_N = 88_080_384          # w_down / w_gate / w_up bucket of qwen3-0.6B
MAIN_W = 4
LOWBIT_BUCKETS = 7           # packed G-Binary buckets of gbin_packed


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_words(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte equality (NaN-safe: compares bit patterns)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return torch.equal(a, b)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def check_kernels() -> dict:
    from repro_torch.kernels import fused, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    # ragged sizes and every W, through the wrappers vs the twins
    for n in (1, 4095, 4097, 3 * 4096 + 77, 100_003):
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn((3, n), device="cuda", generator=gen).to(dt)
            special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                                    -float("inf"), 1e-30, -1e-30, 0.0])[:n]
            g[0, :special.numel()] = special
            plane = ref.to_plane(g)
            if not same(ops.pack_signs(plane), ref.sign_pack(plane)):
                fail(f"sign_pack differs from its twin (n={n}, {dt})")
    for w in (1, 3, 4, 31, 128, 256):
        for rows in (1, 2):     # word rows per owner shard
            for ternary in (False, True):
                routed = rand_words((w, rows * w, 128), gen)
                gate = (fused.local_gate_words(rows * w, ternary=True,
                                               gate_phase=w % 3,
                                               device="cuda")
                        if ternary else fused.local_gate_words(
                            rows * w, ternary=False, device="cuda"))
                got = ops.vote_combine(routed, gate, num_workers=w)
                want = ref.vote_combine(routed, w, gate)
                # the per-owner view a virtual all_to_all hands the kernel
                view = routed.reshape(w, w, rows, 128).transpose(0, 1)
                g4 = gate.reshape(w, rows, 128)
                got4 = ops.vote_combine(view, g4, num_workers=w)
                want4 = ref.vote_combine(view, w, g4)
                if not all(same(a, b) for a, b in
                           zip(got + got4, want + want4)):
                    fail(f"vote_combine differs (W={w}, rows={rows}, "
                         f"ternary={ternary})")
    for rows in (1, 5, 129):
        s, m = rand_words((rows, 128), gen), rand_words((rows, 128), gen)
        if not same(ops.unpack_ternary(s, m), ref.unpack_ternary(s, m)):
            fail(f"unpack_ternary differs (rows={rows})")

    # the main path's largest bucket: W = 4 bf16 planes of 88,080,384
    n, w = MAIN_N, MAIN_W
    plane = ref.to_plane(torch.randn((w, n), device="cuda",
                                     generator=gen).to(torch.bfloat16))
    words = ops.pack_signs(plane)
    if not same(words, ref.sign_pack(plane)):
        fail("sign_pack differs at the main-path bucket")
    r = words.shape[1]
    rw = r // w
    routed = words.reshape(w, w, rw, 128).transpose(0, 1)
    gate = fused.shard_gate_words(range(w), rw, ternary=False, device="cuda")
    sw, mw = ops.vote_combine(routed, gate, num_workers=w)
    want = ref.vote_combine(routed, w, gate)
    if not (same(sw, want[0]) and same(mw, want[1])):
        fail("vote_combine differs at the main-path bucket")
    sw_all, mw_all = sw.reshape(r, 128), mw.reshape(r, 128)
    u = ops.unpack_ternary(sw_all, mw_all)
    u_plain = ref.unpack_ternary(sw_all, mw_all)
    if not same(u, u_plain):
        fail("unpack_ternary differs at the main-path bucket")
    dense = ref.gbinary_aggregate_dense(ref.from_plane(plane, n))
    if not same(ref.from_plane(u, n), dense):
        fail("packed vote differs from the dense Section-2 oracle")
    torch.cuda.synchronize()

    rows = {
        "sign_pack": dict(
            source="src/repro_torch/csrc/sign_pack.cu",
            replaces="src/repro/kernels/sign_pack.py:26",
            ms=time_ms(lambda: ops.pack_signs(plane)),
            plain_ms=time_ms(lambda: ref.sign_pack(plane), 3, 1),
            bytes=w * n * 2 + w * n / 8, ops=w * n * 3,
            err=max_abs_err(words, ref.sign_pack(plane))),
        "vote_combine": dict(
            source="src/repro_torch/csrc/vote_combine.cu",
            replaces="src/repro/kernels/fused.py:110",
            ms=time_ms(lambda: ops.vote_combine(routed, gate,
                                                num_workers=w)),
            plain_ms=time_ms(lambda: ref.vote_combine(routed, w, gate), 3, 1),
            bytes=w * n / 8 + n / 8 + 2 * n / 8, ops=n * (2 * w + 4),
            err=max(max_abs_err(sw, want[0]), max_abs_err(mw, want[1]))),
        "unpack_ternary": dict(
            source="src/repro_torch/csrc/unpack_ternary.cu",
            replaces="src/repro/kernels/apply_update.py:26",
            ms=time_ms(lambda: ops.unpack_ternary(sw_all, mw_all)),
            plain_ms=time_ms(lambda: ref.unpack_ternary(sw_all, mw_all), 3, 1),
            bytes=2 * n / 8 + 4 * n, ops=n * 4,
            err=max_abs_err(u, u_plain)),
    }
    for name, row in rows.items():
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["ops"] / OPS_PER_S * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"kernel {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
              f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"n={n} W={w}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path — a data-parallel qwen3-0.6B training run
# ---------------------------------------------------------------------------

def twin_packed_vote(flat: torch.Tensor) -> torch.Tensor:
    """The packed G-Binary vote of a (W, N) bucket with the plain twins."""
    from repro_torch.kernels import ref
    w, n = flat.shape
    words = ref.sign_pack(ref.to_plane(flat))
    gate = torch.full(words.shape[1:], ref.ALL_ONES, dtype=torch.int32,
                      device=flat.device)
    sw, mw = ref.vote_combine(words, w, gate)
    return ref.from_plane(ref.unpack_ternary(sw, mw), n).to(flat.dtype)


def train(steps: int = 5) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, layout_kernel_stats, plan_presets
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    cfg = get_config("qwen3_0p6b")
    plan = plan_presets()["gbin_packed"]
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=16,
                             seed=0, learnable=False)
    fabric = Fabric(num_workers=MAIN_W)
    trainer = Trainer(cfg, AdamW(peak_lr=3e-4, warmup_steps=2,
                                 total_steps=steps),
                      data, plan=plan, fabric=fabric, seed=0, device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = state.model.tree()
    layout = fabric.layout_for(params, plan)
    lowbit = [b for b in layout.buckets if b.key.schedule == "packed_a2a"]
    if len(layout.buckets) != 9 or len(lowbit) != LOWBIT_BUCKETS:
        fail(f"layout has {len(layout.buckets)} buckets, {len(lowbit)} "
             f"low-bit; expected 9 and {LOWBIT_BUCKETS}")
    backbone = {s.name for b in lowbit for s in b.slots}
    print(f"model {cfg.name}: {sum(p.numel() for p in T.leaves(params))} "
          f"params, {len(layout.buckets)} buckets ({len(lowbit)} packed "
          f"G-Binary), modeled {layout_kernel_stats(layout, MAIN_W)}",
          flush=True)

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for k in range(steps):
        before = {name: fn.launches for name, fn in wrappers.items()}
        trainer.run(k + 1)
        rec = trainer.history[-1]
        delta = {name: fn.launches - before[name]
                 for name, fn in wrappers.items()}
        if any(d != LOWBIT_BUCKETS for d in delta.values()):
            fail(f"step {k}: kernel launches {delta}, expected "
                 f"{LOWBIT_BUCKETS} each (one per low-bit bucket)")
        if not np.isfinite(rec["loss"]):
            fail(f"step {k}: loss {rec['loss']}")
        for path, u in T.flatten(trainer.last_aggregates):
            if path in backbone:
                vals = torch.unique(u.to(torch.float32))
                if not set(vals.tolist()) <= {-1.0, 0.0, 1.0}:
                    fail(f"step {k}: aggregate {path} holds {vals[:8]}")
        print(f"step {k}: loss {rec['loss']:.6f} time {rec['step_time_s']:.4f}"
              f" s traffic_ratio {rec['traffic_ratio']:.6f} "
              f"launches {delta}", flush=True)
    launches = {name: fn.launches for name, fn in wrappers.items()}

    # one step's aggregates against the plain twins on the same grads
    batch = {k: torch.as_tensor(v).cuda()
             for k, v in data.batch_at(steps).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = fabric.worker_grads(params, batch, state.model.loss)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    agg, _ = fabric.aggregate(grads, plan)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gl = dict(T.flatten(grads))
    for bucket in lowbit:
        flat = torch.cat([gl[s.name].reshape(MAIN_W, -1)
                          for s in bucket.slots], dim=1)
        want = twin_packed_vote(flat)
        for s in bucket.slots:
            got = dict(T.flatten(agg))[s.name].reshape(-1)
            if not same(got, want[s.offset:s.offset + s.size]):
                fail(f"aggregate {s.name} differs from the plain twins")
    hist = trainer.history
    return {"launches": launches, "init_s": init_s,
            "step_s": [h["step_time_s"] for h in hist],
            "loss": [h["loss"] for h in hist],
            "traffic_ratio": hist[-1]["traffic_ratio"],
            "grads_s": t1 - t0, "aggregate_s": t2 - t1,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs the port on a GPU")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"built {built} in {time.perf_counter() - t0:.2f} s", flush=True)

    rows = check_kernels()
    print("kernel checks: byte-equal to the plain twins", flush=True)
    run = train()
    print(f"train: losses {run['loss']}", flush=True)
    print(f"train: step seconds {run['step_s']} (init {run['init_s']:.2f} s)",
          flush=True)
    print(f"train: worker grads {run['grads_s']:.4f} s, bucketed aggregate "
          f"{run['aggregate_s']:.4f} s, peak memory {run['peak_gib']:.2f} GiB,"
          f" traffic ratio {run['traffic_ratio']:.6f}", flush=True)

    kernels = [{"name": name, "route": "cuda", "source": row["source"],
                "replaces": row["replaces"],
                "launches": run["launches"][name],
                "max_abs_err": row["err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": None}
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
