"""Drive the PyTorch/CUDA port of NEURON-Fabric on one GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. require CUDA; print the card's name and power limit;
  2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, in parallel) into ``build/kernels``;
  3. hold each of the eleven kernels against its plain PyTorch twin on
     the card, byte for byte: ragged sizes, W in {1, 3, 4, 31, 128, 256}
     (vote_combine: W = 2^k - 1, 2^k, 2^k + 1 for k = 1..12 and 65,537,
     every count-plane width of its dispatch up to 13, and 17;
     vote_pipeline: W = 1-5, 31-33, 128, 255-257 and 65,537, with a tie
     and columns of -0.0, NaN, +-inf and +-subnormals, decoded to
     float32 and bfloat16), G-Binary and G-Ternary gates, strided owner
     views, float32 and bfloat16 planes and decodes, +-0, NaN, +-inf,
     operands whose exponents lie far apart, int4 .5 ties, zero / NaN /
     inf planes and top-k ties at the threshold (also subnormals, a
     negative, an infinite and a NaN threshold, and 70,000 planes;
     apply_sign_update with +-0, +-inf, NaN and subnormal parameters
     under scales 1e-3, -0.37, +-0, inf and NaN, each given as a float
     and as a one-element tensor); then time each at
     the main path's largest leaf (88,080,384 elements) against its twin
     and its bound, on the device clock alone (a spin kernel keeps the
     card busy while the host enqueues the timed launches); vote_combine
     also cold, after a 128 MiB write that flushes L2 before each launch,
     unpack_ternary and vote_pipeline in float32 and bfloat16 out, and
     threshold_mask in bfloat16 and float32 beside
     ``torch.nn.functional.hardshrink`` on the same planes (its library
     time; it drops the ties at t that threshold_mask keeps), and
     apply_sign_update with its scale as a tensor on the card (the
     kernel's own time), a float scale (passed by value) beside;
  4. train the full qwen3-0.6B (28 layers, d 1024, vocab 151,936, bf16,
     remat) with W = 4 virtual data-parallel workers, AdamW, global batch
     16 x 128 tokens, in five runs, each checking finite losses, its
     low-bit aggregates ({-1, 0, +1} for the votes, finite for the means)
     and its own table of kernel launches per step (one per low-bit
     bucket or leaf; int4_quant counts its two launches):
       gbin_packed  5 steps, bucketed, fused kernels: sign_pack,
                    vote_combine, unpack_ternary (every decode straight
                    into the bf16 payload); one step's aggregates equal
                    to the plain twins' on the same grads;
       A. per-leaf EF  3 steps, ``Fabric(fused=False)``, gbin_packed with
                    error feedback: encode_pack_ef, vote_combine,
                    unpack_ternary, ef_residual; one step's aggregates and
                    residuals equal to the twin chain's;
       B. staged    2 steps, ``Fabric(fused_kernels=False)``, a packed
                    G-Ternary backbone: sign_pack, popcount_stack,
                    majority_decode, unpack_ternary; equal to the fused
                    chain's aggregates;
       C. int4      3 steps of ``int4_backbone``: int4_quant; one step's
                    bucket means equal to the twin chain's (per-worker
                    twin encode, then the same mean) and, on the same
                    kernels, to ``Fabric(fused_kernels=False)``'s;
       D. top-k     3 steps of ``topk_backbone``: threshold_mask; the same
                    check, and each bucket's nonzeros within W * k plus
                    the ties at the thresholds;
     then E. host-local: one worker's gradients (4 x 128 tokens) through
     ``Fabric(group=LocalGroup())`` under gbin_packed, a packed G-Ternary
     backbone and per-leaf gbin_packed with EF: one vote_pipeline launch
     per low-bit bucket or leaf (plus ef_residual under EF), equal to the
     three-kernel chain of ``Fabric(num_workers=1)`` and the staged chain,
     every vote_pipeline launch decoding straight into bf16; then
     ``torch.profiler`` over 5 more gbin_packed aggregates gives
     vote_pipeline's device time inside the path, beside its bound;
  5. the control plane:
       F. paper     5 steps of the full model, W = 4, through
                    ``Trainer(controller=make_controller("paper",
                    commander=Commander(schedule=PACKED_A2A),
                    warmup_steps=2))``: steps 0-1 on FP32 with cosine
                    diagnostics and no kernel launch, the cosines held to
                    a float64 recomputation from the same aggregates
                    (1e-5), events (1, warmup_end) and (1, admitted), the
                    admitted plan the Commander's proposal on the printed
                    cosines with a packed low-bit bucket, and each later
                    step launching what the admitted layout models;
       G. grad_accum  2 steps of ``build_step(..., grad_accum=2)`` under
                    gbin_packed: float32 gradients on the bf16-planned
                    buckets, float32 aggregates, 7 sign_pack, vote_combine
                    and float32 unpack_ternary launches a step, one
                    aggregation byte-equal to the plain twins;
       H. harness   the virtual-worker accuracy harness on the card: the
                    four HARD runs of ``benchmarks/bench_convergence.py``
                    (traffic ratios equal to the reference's, G-Binary
                    everywhere 4 points under FP32, the FP32 head 5
                    points over it) and the guarded pilot of
                    ``benchmarks/bench_recovery.py`` (admitted, recovery
                    and readmitted);
  6. data parallelism across processes:
       I. nccl      full qwen3-0.6B on ``Fabric(group=DistributedGroup)``
                    over NCCL at world size 1 (the group set up in this
                    process, a ``file://`` store under build/), gbin_packed,
                    4 x 128 tokens (one worker's share of the main cell),
                    5 steps: 7 launches each of sign_pack, vote_combine
                    and bf16 unpack_ternary a step, the group's calls and
                    bytes by op a step (7 all_to_all, 14 all_gather, one
                    all_reduce a FP32 bucket and one of the loss) and
                    their host time, each synchronised; then one set of
                    this rank's gradients through it and through
                    ``Fabric(num_workers=1)`` under gbin_packed, packed
                    G-Ternary, per-leaf EF, the staged chain,
                    int4_backbone, topk_backbone and fp32: aggregates and
                    EF residuals byte-equal, zeros of either sign as
                    zeros;
       J. replay    qwen3-0.6B at full width and 2 layers (a depth cut:
                    ~1.9 GB a checkpoint) over NCCL, gbin_packed under the
                    paper controller (warm-up 2), 8 steps, a checkpoint
                    every 4 (keep 1) under build/, removed after: once as
                    it is and once with a failure injected at step 6;
                    restarts 0 and 1, the last loss, every parameter, the
                    admitted plan and the events equal; the save and
                    restore timed;
       K. gloo      two ranks spawned on cuda:0 over gloo, the bf16 smoke
                    model, gbin_packed, 2 steps: every step's aggregates,
                    the losses and the parameters equal to
                    ``Fabric(num_workers=2)``'s;
  7. the model zoo at full width:
       attention  one gemma3-27b layer's q, k, v at 4096 tokens (bf16):
                    the blocked path against the full-scores path, forward
                    and the gradient of a fixed cotangent, on a local
                    (window 1024) and the global layer, to 2 bf16 ulps of
                    the largest value; both timed, beside
                    ``scaled_dot_product_attention`` (a yardstick only);
       L. gemma3    gemma3-27b cut to 6 layers (one 5:1 local:global
                    period; 3,886,618,368 parameters), W = 2 workers of one
                    4096-token sequence each (the blocked path),
                    gbin_packed, SgdMomentum, 3 steps: 9 buckets, 7 packed
                    (sign_pack, vote_combine, bf16 unpack_ternary on leaves
                    of up to 693,633,024 elements), the reference's traffic
                    ratio 0.3825361348161055;
       M. moe       deepseek-moe-16b cut to 3 layers (the dense first layer
                    and 2 MoE layers of 64 experts, top-6, 2 shared;
                    1,681,143,808 parameters), W = 4, 16 x 512 tokens,
                    gbin_packed, AdamW, 3 steps: 15 buckets, 12 packed, the
                    traffic ratio 0.27310381290117447;
       N. xlstm     xlstm-125m whole (9 mLSTM and 3 sLSTM blocks;
                    183,565,128 parameters), W = 2, 8 x 256 tokens (the
                    scans in 16 checkpointed chunks of 16 steps),
                    gbin_packed, AdamW, 2 steps: 11 buckets, 8 packed, one
                    of them float32 (w_if, r), the traffic ratio
                    0.4391217050767943;
       O. hymba     hymba-1.5b cut to 5 layers (0, 2, 4 global, 1 and 3 in
                    the 1024-token window; attention beside a Mamba head;
                    304,036,800 parameters), W = 2, 4 x 2048 tokens,
                    gbin_packed, AdamW, 2 steps: 12 buckets, 9 packed, two
                    of them float32 (w_dt; w_bc and a_log), the traffic
                    ratio 0.3576435484125606;
       P. whisper   whisper-tiny whole (4 encoder, 4 decoder layers;
                    36,586,752 parameters), W = 4, 16 x 448 tokens and
                    16 x 1500 x 384 seeded frames a step, gbin_packed,
                    AdamW, 3 steps: 4 buckets, 1 packed, the traffic ratio
                    0.5627112239971452;
     each of L to P with one step's aggregates byte-equal to the plain
     twins, its launches a step by kernel and by decode dtype (bf16 and
     float32 unpack_ternary, a count each from the layout), and its
     losses, step seconds, peak memory and layout printed;
  8. tensor parallelism and ZeRO-1:
       Q. tp        full qwen3-0.6B on a (data 2) x (model 2) process
                    mesh: four gloo ranks spawned on cuda:0 (``chip_smoke.py
                    --run-q-rank r dir``), gbin_packed, AdamW with ZeRO-1,
                    2 x 4 x 128 tokens, 2 steps of "full" remat: finite
                    losses equal on every rank, 7 launches a step each of
                    sign_pack, vote_combine and bf16 unpack_ternary (the
                    five tensor-parallel leaves per leaf, wk and wv a
                    bucket each), step 0's aggregates byte-equal to the
                    plain twins' per-shard vote on the data ranks'
                    gathered gradients, replicated leaves bit-equal on
                    every rank and blocks on both data ranks after each
                    step, the traffic ratio 0.2842221000549753, ZeRO-1
                    moments half of whole, one "dots" and one "full"
                    backward (the same gradients, one model-group
                    all-reduce fewer a layer); then, in this process, the
                    unsharded model on the same parameters and data rank
                    0's batch: its loss, and each step-0 gradient block
                    no further from the float32 gradient than twice the
                    unsharded bf16 gradient's distance (plus 2^-8);
  9. hop plans and the simulator:
       R. hier      full qwen3-0.6B under ``hier_fp32_gbinary`` on W = 16
                    virtual workers as ``VirtualGroup((2, 8))``: hop 0 the
                    FP32 mean over each inner 8, hop 1 the vote_psum
                    G-Binary vote over the outer 2; 16 x 128 tokens,
                    AdamW, 3 steps, no kernel launch a step; each step's
                    aggregates byte-equal to sign(sum_outer(vote(
                    mean_inner(g)))) on the step's own gradients through
                    the same group sums; then on step 0's gradients the
                    same route with a ``packed_a2a`` backbone (a
                    registered plan): 7 each of sign_pack, vote_combine
                    and float32 unpack_ternary over the outer group (hop 0
                    hands float32 on, as the reference's does), byte-equal
                    to R's; the per-hop wire bytes summing to each
                    launch's; the traffic ratio the reference's
                    0.2842221000549753; ``fabric.simulate`` of R's layout
                    on ``ici_ring`` and ``multihop`` and the paper's
                    operating points (full_miss exposed within 1.67%,
                    bandwidth_pressure 0), printed as modeled figures
                    under the reference's constants;
 10. the autotuner and the tuned controller:
       S. tuned     ``Fabric.autotune`` on full qwen3-0.6B's ``meta``
                    parameters (W = 4, ``ici_ring``; the reference's
                    winner, the backbone and the tied embedding on the
                    packed vote), ``tuned.apply(fabric)``, the ``tuned``
                    controller, then the Trainer, as ``launch/train.py
                    --autotune`` does: 16 x 128 tokens, AdamW, 7 steps;
                    each step's launches those of its latched plan's
                    layout (the winner: 8 each of sign_pack, vote_combine
                    and bf16 unpack_ternary; the int4 plan: 2 int4_quant a
                    bucket), its low-bit aggregates equal to the twins' on
                    its own gradients (the packed vote byte for byte, the
                    embedding's vote_psum to zeros of either sign, int4's
                    means byte for byte), and the retune events equal to
                    the reference's rule on the measured step times, the
                    first to the int4 backbone; before it, sign_pack,
                    vote_combine and bf16 unpack_ternary held to their
                    twins and timed at the 155,582,464-element embedding
                    bucket, beside their bounds;
 11. the serving engine:
       T. serve     full qwen3-0.6B (bf16 weights, a float32 KV cache)
                    through ``ServeEngine`` on the card: max_batch 4,
                    max_seq 256, blocks of 16 in a 38-block pool, six
                    requests (prompts of 16-128 tokens, 16-48 new ones,
                    arriving over steps 0-6, FCFS): a preemption and a
                    spill/fetch round trip, the pool drained, each
                    request's logits bit-identical to its solo run at the
                    same max_batch; the same trace under the int4 KV codec
                    with finite logits and every record's wire bytes the
                    codec's price of its elements plus the step's spill
                    and fetch bytes; ``simulate(topology="cxl_switched")``
                    of the timeline; decode-step ms, prefill seconds a
                    prompt, tokens a second, one decode step's kernel
                    launch calls and peak memory printed;
 12. the recurrent and cross-attention decode:
       U. decode    xlstm-125m (12 blocks), hymba-1.5b (32 layers) and
                    whisper-tiny (4 + 4 layers, 4 x 1500 seeded frames)
                    whole, each through ``build_cached_prefill`` and
                    ``build_serve_step`` on the default bf16 cache: batch
                    4, 64-token prompts, 32 greedy tokens, after one
                    untimed step; every logit finite; for xlstm and
                    hymba the teacher-forced decode of the 96 tokens
                    against the model's forward on the card, within 2^-4
                    of the largest logit in bf16 and 1e-4 on a float32
                    copy of the weights; for whisper each layer's
                    cross-attention term of a decode step exactly zero
                    (the reference's zero cross cache, ROADMAP queue 3);
                    decode-step ms, prefill seconds, tokens a second,
                    one step's kernel launch calls and peak memory;
 13. elastic training of full qwen3-0.6B (``ElasticTrainer``, W = 4
     virtual workers, each on its own stream of 4 x 128 tokens,
     SgdMomentum, synthetic step times):
       V. crash     the static ``gbin_packed`` plan (bucketed, fused
                    kernels), 10 steps, a checkpoint every 4 (keep 1)
                    under build/, removed after, worker 3 crashing at
                    step 6 and rejoining at 8: restarts 1, 2 steps
                    rolled back and replayed, 3 built steps, the final
                    view epoch 2 with workers 0-3, the history's W 4,
                    then 3, then 4 from step 8, the parameters restored
                    bit-equal to those saved at step 4, 7 launches each
                    of sign_pack, vote_combine and bf16 unpack_ternary a
                    step at W = 4 and 3, the first step of each view
                    byte-equal to the plain twins; step seconds by view,
                    the saves and the restore timed, the checkpoint's
                    bytes, peak memory and ``replay_schedule`` of the
                    scenario on ``cxl_direct`` (modeled); then 6 steps of
                    the Trainer on the same model, plan, optimizer and
                    16 x 128 tokens, V's steps' yardstick in the call;
       V'. straggler  7 steps, worker 1 six times slow on steps 1-2,
                    ``straggler_aware`` (gbin_packed with EF after 2
                    flagged steps, FP32 after 2 stable ones): the events
                    (2, demoted) and (6, recovered), as on the CPU
                    (``tests/test_torch_elastic.py``), each low-bit step
                    launching what ``layout_kernel_stats`` models, the EF
                    rows finite;
 15. serving on a process mesh:
       W. serve-mesh  full qwen3-0.6B (bf16, the default bf16 cache) on a
                    (data 2) x (model 2) process mesh: four gloo ranks
                    spawned on cuda:0 (``chip_smoke.py --run-w-rank r
                    dir``), each holding its blocks of the parameters
                    (heads, MLP columns and vocabulary over the model
                    ranks) and of the cache; the batched layout (batch 4,
                    2 rows a data rank, the 256 cache positions 128 a
                    model rank) and the shard_seq layout (batch 1, 64
                    positions a rank), each a 64-token prompt through the
                    mesh's ``build_cached_prefill`` and 32 greedy tokens
                    through its ``build_serve_step``; the ranks' logits and
                    tokens equal; then, in this process, the one-device
                    step teacher-forced on the same tokens: the logits
                    within 2^-4 of the largest, a float32 pass (8 prompt
                    tokens, 8 greedy) within 1e-4 and its greedy tokens
                    equal, the bf16 greedy tokens equal wherever the
                    one-device top-2 margin exceeds twice the bf16
                    distance (bf16 logits tie); decode-step ms,
                    one step's launch calls and collectives by op, prefill
                    seconds and peak memory a rank;
 16. the reference's examples:
       X. examples  quickstart (2 steps), train_lm (the bf16 100m preset,
                    2 steps) and serve_lm (8 tokens) under ``torchrun
                    --nproc-per-node 8`` (``chip_smoke.py --run-x-rank``),
                    every rank on cuda:0 over gloo, the three at once;
                    serving, autotune_plan, elastic_training,
                    layer_aware_admission (60 and 110 steps) and
                    guarded_recovery in this process; each with its own
                    assertions, the training examples' rank 0 launching
                    sign_pack, vote_combine and unpack_ternary (bf16 for
                    the bf16 preset); each one's seconds;
 17. expert parallelism:
       Z. moe-mesh  deepseek-moe-16b at full width cut to run M's 3 layers
                    on a (data 2) x (model 2) process mesh: four gloo
                    ranks spawned on cuda:0 (``chip_smoke.py --run-z-rank r
                    dir``), the 64 routed experts 32 a model rank, the
                    router replicated, the shared experts, attention, MLP
                    and vocabulary split as the dense family's.  Z.1:
                    gbin_packed, AdamW with ZeRO-1, 2 steps, one
                    1024-token dispatch group (2 x 512) a data rank:
                    finite losses equal on every rank, a launch a step
                    each of sign_pack, vote_combine and bf16
                    unpack_ternary for each tensor-parallel low-bit leaf
                    and low-bit bucket of the layout, the traffic ratio
                    the unsharded Fabric's 0.27310381290117447, ZeRO-1
                    moments half of whole, replicated leaves bit-equal on
                    every rank and blocks on both data ranks after the
                    last step, each model rank's step-0 routing equal;
                    then, in this process, the unsharded model on the
                    same parameters and data rank 0's batch: its loss,
                    each step-0 gradient block within run Q's bf16-noise
                    yardstick, and the count of the step-0 forward's
                    top-k choices that differ from it (printed).  Z.2:
                    the seed's parameters, batch 4, 64-token prompts
                    through the mesh's cached prefill and 16 greedy
                    tokens, bf16 cache (128 positions, 64 a model rank):
                    the logits within 2^-4 of the largest of the
                    one-device step's teacher-forced on the same tokens
                    at every (position, row) whose step chose the same
                    experts on both (a bf16 near-tie flips a choice: the
                    flips and their distance printed), and a float32 pass
                    (float32 weights and cache, 8 prompt tokens, 8
                    greedy) within 1e-4 everywhere, its greedy tokens
                    equal; decode-step ms, launch calls and collectives a
                    step, peak memory a rank and the run's seconds
                    printed;
 18. the launch tooling:
       Y. dryrun    Y.1, started in the background right after the build
                    (CPU work only) and read here: ``python -m
                    repro_torch.launch.dryrun`` on full
                    qwen3-0.6B's four cells on both production meshes
                    (16 x 16 and 2 x 16 x 16: 256 and 512 ranks played
                    by one process under a fake process group, on
                    ``meta`` tensors; long_500k skipped), then
                    ``decode_32k`` of every architecture on 16 x 16: the
                    failures exactly the families whose tensor
                    parallelism is still to port (xlstm-125m, hymba-1.5b,
                    whisper-tiny), each a NotImplementedError, the MoE
                    configs (experts over 16 model ranks), the VLM and
                    qwen2.5-14B (40 query heads on 16 ranks: 320 columns
                    a rank, 2.5 heads) tracing; the report's tables.  Y.2, beside it: run Q's train step and run
                    W's batched decode step on four gloo ranks on cuda:0
                    (``chip_smoke.py --run-y-rank r dir``), and the
                    dry-run's trace of the same cells on a fake (2, 2)
                    mesh: collective calls and bytes by group and op,
                    FLOPs (``FlopCounterMode``) and kernel calls equal,
                    the traced peak within Y_PEAK_BAND of the rank's
                    ``max_memory_allocated``, the roofline bound no
                    longer than the measured step;
 19. print the kernels line (launches summed over the runs, runs Q's, X's
     mesh examples', Z's and Y's from rank 0), the card, then ``{"ok":
     true, "device": {...}}`` last.
"""
from __future__ import annotations

import atexit
import contextlib
import gc
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
MAIN_N = 88_080_384          # w_down / w_gate / w_up leaf of qwen3-0.6B
MAIN_W = 4
LOWBIT_BUCKETS = 7           # low-bit buckets (= leaves) per step
SOURCES = {
    "sign_pack": ("sign_pack.cu", "src/repro/kernels/sign_pack.py:26"),
    "vote_combine": ("vote_combine.cu", "src/repro/kernels/fused.py:110"),
    "unpack_ternary": ("unpack_ternary.cu",
                       "src/repro/kernels/apply_update.py:26"),
    "unpack_ternary_bf16": ("unpack_ternary.cu",
                            "src/repro/kernels/apply_update.py:26"),
    "encode_pack_ef": ("encode_pack_ef.cu", "src/repro/kernels/fused.py:96"),
    "ef_residual": ("ef_residual.cu", "src/repro/kernels/fused.py:151"),
    "popcount_stack": ("popcount_stack.cu",
                       "src/repro/kernels/popcount_majority.py:38"),
    "majority_decode": ("majority_decode.cu",
                        "src/repro/kernels/popcount_majority.py:73"),
    "vote_pipeline": ("vote_pipeline.cu", "src/repro/kernels/fused.py:131"),
    "vote_pipeline_bf16": ("vote_pipeline.cu",
                           "src/repro/kernels/fused.py:131"),
    "apply_sign_update": ("apply_sign_update.cu",
                          "src/repro/kernels/apply_update.py:59"),
    "int4_quant": ("int4_quant.cu", "src/repro/kernels/fused.py:158"),
    "threshold_mask": ("threshold_mask.cu", "src/repro/kernels/fused.py:185"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


#: GPU clock cycles a spin kernel holds the stream (~1 ms at 1.98 GHz)
#: while the host enqueues what follows it, so that the events time the
#: device's work and not the wrappers' host overhead
SPIN_CYCLES = 2_000_000


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * max(1, iters // 10))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call of ``fn`` after a 128 MiB write has
    flushed the 50 MB L2; only the call is timed."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for k, (start, end) in enumerate(events):
        flush.fill_(k)
        torch.cuda._sleep(SPIN_CYCLES // 8)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def rand_words(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte equality, NaNs included: the kernels and PyTorch's CUDA ops
    round with the same instructions, so even NaN bits must agree."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return torch.equal(a, b)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|; NaNs (checked by bit pattern in ``same``) and
    equal infinities count as no error."""
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return float(torch.nan_to_num(d, nan=0.0).max())


def spread(shape, gen) -> torch.Tensor:
    """float32 values with exponents 2**-24 .. 2**24 (pairs of them lie
    far more than 16 binades apart), led by the special values."""
    x = torch.randn(shape, device="cuda", generator=gen)
    x = x * torch.exp2(torch.randint(-24, 25, shape, device="cuda",
                                     generator=gen).to(torch.float32))
    special = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            -float("inf"), 1e-30, -1e-30, 1.0])
    flat = x.reshape(-1)
    k = min(flat.numel(), special.numel())
    flat[:k] = special[:k]
    return x


def free() -> None:
    # a finished run's trainer may sit in reference cycles that hold its
    # tensors until the collector runs: collect them before the next peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

RAGGED = (1, 4095, 4097, 3 * 4096 + 77, 100_003)
WORKERS = (1, 3, 4, 31, 128, 256)
#: vote_combine's: every count-plane width P = bit_length(W) up to 13, and
#: 17, each at W = 2^k - 1, 2^k and 2^k + 1 (the transposed owner view
#: needs W * rows rows, so it runs at W <= 256 only)
VOTE_WORKERS = sorted({2 ** k + d for k in range(1, 13) for d in (-1, 0, 1)}
                      | {65_537})


def check_vote_kernels(gen) -> None:
    """sign_pack, vote_combine, unpack_ternary: the bucketed vote's."""
    from repro_torch.kernels import fused, ops, ref

    for n in RAGGED:
        for dt in (torch.float32, torch.bfloat16):
            plane = ref.to_plane(spread((3, n), gen).to(dt))
            if not same(ops.pack_signs(plane), ref.sign_pack(plane)):
                fail(f"sign_pack differs from its twin (n={n}, {dt})")
    for w in VOTE_WORKERS:
        for rows in ((1,) if w > 4097 else (1, 2)):   # word rows an owner
            for ternary in (False, True):
                # one owner, with a tie (W // 2 ones) and a unanimous column
                routed = rand_words((w, rows, 128), gen)
                routed[:w // 2, 0, :32] = -1
                routed[w // 2:, 0, :32] = 0
                routed[:, 0, 32:36] = -1
                gate = fused.local_gate_words(rows, ternary=ternary,
                                              gate_phase=w % 3,
                                              device="cuda")
                got = ops.vote_combine(routed, gate, num_workers=w)
                want = ref.vote_combine(routed, w, gate)
                if w <= 256:
                    # W owners: the view a virtual all_to_all hands the
                    # kernel
                    packed = rand_words((w, rows * w, 128), gen)
                    view = packed.reshape(w, w, rows, 128).transpose(0, 1)
                    g4 = fused.local_gate_words(
                        rows * w, ternary=ternary, gate_phase=w % 3,
                        device="cuda").reshape(w, rows, 128)
                    got = got + ops.vote_combine(view, g4, num_workers=w)
                    want = want + ref.vote_combine(view, w, g4)
                if not all(same(a, b) for a, b in zip(got, want)):
                    fail(f"vote_combine differs (W={w}, rows={rows}, "
                         f"ternary={ternary})")
    for rows in (1, 5, 129):
        s, m = rand_words((rows, 128), gen), rand_words((rows, 128), gen)
        for dt in (torch.float32, torch.bfloat16):
            if not same(ops.unpack_ternary(s, m, dtype=dt),
                        ref.unpack_ternary(s, m, dt)):
                fail(f"unpack_ternary differs (rows={rows}, {dt})")


def check_ef_and_staged_kernels(gen) -> None:
    """encode_pack_ef, ef_residual, popcount_stack, majority_decode."""
    from repro_torch.kernels import fused, ops, ref

    for n in RAGGED:
        for gdt in (torch.float32, torch.bfloat16):
            for edt in (torch.float32, torch.bfloat16):
                g = ref.to_plane(spread((3, n), gen).to(gdt))
                e = ref.to_plane(spread((3, n), gen).to(edt))
                got, want = ops.encode_pack_ef(g, e), ref.encode_pack_ef(g, e)
                if not (same(got[0], want[0]) and same(got[1], want[1])):
                    fail(f"encode_pack_ef differs (n={n}, g {gdt}, e {edt})")
        for dt, out in ((torch.float32, torch.float32),
                        (torch.bfloat16, torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
            x = ref.to_plane(spread((3, n), gen).to(dt))
            beta = torch.tensor([0.75, 3e-5, float("inf")], device="cuda")
            got = ops.ef_residual_plane(x, beta, out_dtype=out)
            if not same(got, ref.ef_residual(x, beta).to(out)):
                fail(f"ef_residual differs (n={n}, {dt} -> {out})")
    for w in WORKERS:
        for rows in (1, 2):
            packed = rand_words((w, rows * w, 128), gen)
            view = packed.reshape(w, w, rows, 128).transpose(0, 1)
            for p in (packed, view):
                counts = ops.popcount_stack(p)
                if not same(counts, ref.popcount_stack(p)):
                    fail(f"popcount_stack differs (W={w}, rows={rows}, "
                         f"shape {tuple(p.shape)})")
                r = counts.shape[-2] // 32
                for ternary in (False, True):
                    gate = fused.local_gate_words(
                        r * (w if p is view else 1), ternary=ternary,
                        gate_phase=w % 3, device="cuda")
                    gate = gate.reshape(counts.shape[:-2] + (r, 128))
                    got = ops.majority_decode(counts, gate, num_workers=w)
                    want = ref.majority_decode(counts, w, gate)
                    if not all(same(a, b) for a, b in zip(got, want)):
                        fail(f"majority_decode differs (W={w}, rows={rows},"
                             f" ternary={ternary})")


def bound(row: dict) -> None:
    t_bytes = row.pop("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = row.pop("ops") / OPS_PER_S * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def check_kernels() -> dict:
    from repro_torch.kernels import fused, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    check_vote_kernels(gen)
    check_ef_and_staged_kernels(gen)
    check_slice3_kernels(gen)

    # the main path's largest leaf: W = 4 bf16 planes of 88,080,384 and
    # their float32 residuals
    n, w = MAIN_N, MAIN_W
    plane = ref.to_plane(torch.randn((w, n), device="cuda",
                                     generator=gen).to(torch.bfloat16))
    e_plane = 1e-3 * torch.randn(plane.shape, device="cuda", generator=gen)
    words = ops.pack_signs(plane)
    if not same(words, ref.sign_pack(plane)):
        fail("sign_pack differs at the main-path leaf")
    r = words.shape[1]
    rw = r // w
    routed = words.reshape(w, w, rw, 128).transpose(0, 1)
    gate = fused.shard_gate_words(range(w), rw, ternary=False, device="cuda")
    sw, mw = ops.vote_combine(routed, gate, num_workers=w)
    want = ref.vote_combine(routed, w, gate)
    if not (same(sw, want[0]) and same(mw, want[1])):
        fail("vote_combine differs at the main-path leaf")
    sw_all, mw_all = sw.reshape(r, 128), mw.reshape(r, 128)
    u = ops.unpack_ternary(sw_all, mw_all)
    u_plain = ref.unpack_ternary(sw_all, mw_all)
    if not same(u, u_plain):
        fail("unpack_ternary differs at the main-path leaf")
    dense = ref.gbinary_aggregate_dense(ref.from_plane(plane, n))
    if not same(ref.from_plane(u, n), dense):
        fail("packed vote differs from the dense Section-2 oracle")
    # the main path's decode: straight into the bf16 payload's dtype
    u16 = ops.unpack_ternary(sw_all, mw_all, dtype=torch.bfloat16)
    u16_plain = ref.unpack_ternary(sw_all, mw_all, torch.bfloat16)
    if not (same(u16, u16_plain) and same(u16, u.to(torch.bfloat16))):
        fail("unpack_ternary differs at the main-path leaf (bf16)")
    ef_words, g_eff = ops.encode_pack_ef(plane, e_plane)
    ef_want = ref.encode_pack_ef(plane, e_plane)
    if not (same(ef_words, ef_want[0]) and same(g_eff, ef_want[1])):
        fail("encode_pack_ef differs at the main-path leaf")
    ef_err = max(max_abs_err(ef_words, ef_want[0]),
                 max_abs_err(g_eff, ef_want[1]))
    del ef_want
    beta = g_eff.reshape(w, -1).abs().mean(dim=1)
    resid = ops.ef_residual_plane(g_eff, beta, out_dtype=torch.float32)
    resid_plain = ref.ef_residual(g_eff, beta).to(torch.float32)
    if not same(resid, resid_plain):
        fail("ef_residual differs at the main-path leaf")
    counts = ops.popcount_stack(routed)
    counts_plain = ref.popcount_stack(routed)
    if not same(counts, counts_plain):
        fail("popcount_stack differs at the main-path leaf")
    del counts_plain
    smw = ops.majority_decode(counts, gate, num_workers=w)
    smw_plain = ref.majority_decode(counts, w, gate)
    if not all(same(a, b) for a, b in zip(smw + want, smw_plain + smw)):
        fail("majority_decode differs at the main-path leaf (or from the "
             "fused vote_combine)")
    torch.cuda.synchronize()

    bf16, f32 = 2, 4
    rows = {
        "sign_pack": dict(
            ms=time_ms(lambda: ops.pack_signs(plane)),
            plain_ms=time_ms(lambda: ref.sign_pack(plane), 3, 1),
            bytes=w * n * (bf16 + 1 / 8), ops=w * n * 3,
            err=max_abs_err(words, ref.sign_pack(plane))),
        # ms cold: L2 flushed before each launch, as the ratio to the
        # bound wants; warm (words left in L2 by the last launch, as
        # sign_pack leaves them on the path) is printed beside it
        "vote_combine": dict(
            ms=time_cold_ms(lambda: ops.vote_combine(routed, gate,
                                                     num_workers=w)),
            warm_ms=time_ms(lambda: ops.vote_combine(routed, gate,
                                                     num_workers=w)),
            plain_ms=time_ms(lambda: ref.vote_combine(routed, w, gate), 3, 1),
            bytes=w * n / 8 + n / 8 + 2 * n / 8, ops=n * (2 * w + 4),
            err=max(max_abs_err(sw, want[0]), max_abs_err(mw, want[1]))),
        "unpack_ternary": dict(
            ms=time_ms(lambda: ops.unpack_ternary(sw_all, mw_all)),
            plain_ms=time_ms(lambda: ref.unpack_ternary(sw_all, mw_all), 3, 1),
            bytes=2 * n / 8 + f32 * n, ops=n * 4,
            err=max_abs_err(u, u_plain), shape=f"n={n} f32"),
        "unpack_ternary_bf16": dict(
            ms=time_ms(lambda: ops.unpack_ternary(sw_all, mw_all,
                                                  dtype=torch.bfloat16)),
            plain_ms=time_ms(lambda: ref.unpack_ternary(
                sw_all, mw_all, torch.bfloat16), 3, 1),
            bytes=2 * n / 8 + bf16 * n, ops=n * 4,
            err=max_abs_err(u16, u16_plain), shape=f"n={n} bf16"),
        "encode_pack_ef": dict(
            ms=time_ms(lambda: ops.encode_pack_ef(plane, e_plane)),
            plain_ms=time_ms(lambda: ref.encode_pack_ef(plane, e_plane), 3, 1),
            bytes=w * n * (bf16 + f32 + bf16 + 1 / 8), ops=w * n * 4,
            err=ef_err),
        "ef_residual": dict(
            ms=time_ms(lambda: ops.ef_residual_plane(
                g_eff, beta, out_dtype=torch.float32)),
            plain_ms=time_ms(lambda: ref.ef_residual(g_eff, beta)
                             .to(torch.float32), 3, 1),
            bytes=w * n * (bf16 + f32), ops=w * n * 4,
            err=max_abs_err(resid, resid_plain)),
        "popcount_stack": dict(
            ms=time_ms(lambda: ops.popcount_stack(routed)),
            plain_ms=time_ms(lambda: ref.popcount_stack(routed), 3, 1),
            bytes=w * n / 8 + f32 * n, ops=n * 2 * w,
            err=max_abs_err(counts, ref.popcount_stack(routed))),
        "majority_decode": dict(
            ms=time_ms(lambda: ops.majority_decode(counts, gate,
                                                   num_workers=w)),
            plain_ms=time_ms(lambda: ref.majority_decode(counts, w, gate),
                             3, 1),
            bytes=f32 * n + n / 8 + 2 * n / 8, ops=n * 5,
            err=max(max_abs_err(a, b) for a, b in zip(smw, smw_plain))),
    }
    finish_rows(rows, f"n={n} W={w}")
    return rows


def finish_rows(rows: dict, shape: str) -> None:
    for name, row in rows.items():
        src, replaces = SOURCES[name]
        row["source"] = f"src/repro_torch/csrc/{src}"
        row["replaces"] = replaces
        bound(row)
        row.setdefault("library_ms", None)
        warm = row.pop("warm_ms", None)
        when = "" if warm is None else f" cold, {warm:.4f} ms warm"
        by_value = row.pop("float_scale_ms", None)
        if by_value is not None:
            when = f" tensor scale, {by_value:.4f} ms float scale"
        lib = row["library_ms"]
        lib = "" if lib is None else f", library {lib:.4f} ms"
        print(f"kernel {name}: {row['ms']:.4f} ms{when}, plain "
              f"{row['plain_ms']:.4f} ms{lib}, bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']}), {row.pop('shape', shape)}",
              flush=True)


def int4_planes(gen) -> torch.Tensor:
    """float32 planes, one int4 scale each: random magnitudes, exact
    scales (absmax 7 * 2**e) holding .5 ties, +-0.0 and 1e-30, a zero
    plane, a plane with a NaN and one with an inf."""
    base = torch.randn(3 * 4096, device="cuda", generator=gen)
    planes = [base * 10.0 ** e for e in (-30, -3, 0, 4)]
    ties = torch.tensor([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 6.5, -6.5, 7.0,
                         -0.0, 0.0, 1e-30], device="cuda")
    for e in (-20, 3):
        x = base.clamp(-6.9, 6.9) * 2.0 ** e
        x[:ties.numel()] = ties * 2.0 ** e
        planes.append(x)
    planes.append(torch.zeros_like(base))
    for special in (float("nan"), float("inf")):
        x = base * 30
        x[7] = special
        planes.append(x)
    return torch.stack(planes)


#: vote_pipeline's W: ties at even W, and counts past every narrow integer
#: the reference once wrapped
PIPELINE_WORKERS = (1, 2, 3, 4, 5, 31, 32, 33, 128, 255, 256, 257, 65_537)


def check_vote_pipeline(gen) -> None:
    """vote_pipeline against its twin, decoded to float32 and bfloat16:
    ragged sizes, a tie in row 0 (W // 2 positive workers) and columns of
    -0.0, NaN, +inf, -inf and +-subnormals in row 1; W = 65,537 on one
    word row."""
    from repro_torch.kernels import fused, ops, ref

    for w in PIPELINE_WORKERS:
        for n in ((4000,) if w > 257 else (4000, 3 * 4096 + 77)):
            x = torch.randn((w, n), device="cuda", generator=gen)
            x[:w // 2, :8] = 1.0
            x[w // 2:, :8] = -1.0
            x[:, 128:134] = torch.tensor([-0.0, float("nan"), float("inf"),
                                          -float("inf"), 1e-40, -1e-40])
            for dt in (torch.float32, torch.bfloat16):
                stack = ref.to_plane(x.to(dt))
                for ternary in (False, True):
                    gate = fused.local_gate_words(
                        stack.shape[1] // 32, ternary=ternary,
                        gate_phase=w % 3, device="cuda")
                    want = ref.vote_pipeline_dense(stack, w, gate)
                    for out in (torch.float32, torch.bfloat16):
                        got = ops.vote_pipeline(stack, gate, num_workers=w,
                                                dtype=out)
                        if not same(got, want.to(out)):
                            fail(f"vote_pipeline differs (W={w}, n={n}, "
                                 f"{dt} -> {out}, ternary={ternary})")
                del stack, want
            del x


def check_threshold_special(gen) -> None:
    """threshold_mask with ties at t, NaN, +-0, +-inf and subnormals under
    thresholds 0.75, 0, a subnormal, -1 (keeps all but NaN), +inf and NaN
    (keeps nothing), on 300 planes of 33 rows and 70,000 planes of one
    row (more than a grid's y dimension holds)."""
    from repro_torch.kernels import ops, ref

    specials = torch.tensor([0.75, -0.75, float("nan"), 0.0, -0.0,
                             float("inf"), -float("inf"), 1e-40, -3e-39,
                             1e-30, -1.0, 1.0], device="cuda")
    ts = torch.tensor([0.75, 0.0, 1e-40, -1.0, float("inf"), float("nan")],
                      device="cuda")
    for planes, rows in ((300, 33), (70_000, 1)):
        x = torch.randn((planes, rows, 128), device="cuda", generator=gen)
        x[:, 0, :specials.numel()] = specials
        thresh = ts.repeat(planes // ts.numel() + 1)[:planes]
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            if not same(ops.threshold_mask_plane(xd, thresh),
                        ref.threshold_mask_plane(xd, thresh.to(dt))):
                fail(f"threshold_mask differs ({planes} planes of {rows} "
                     f"rows, {dt}, special values and thresholds)")


def check_slice3_kernels(gen) -> None:
    """vote_pipeline, int4_quant, threshold_mask, apply_sign_update."""
    from repro_torch.kernels import ops, ref

    check_vote_pipeline(gen)
    planes = ref.to_plane(int4_planes(gen))
    if not same(ops.int4_quant_plane(planes), ref.int4_quant_plane(planes)):
        fail("int4_quant differs from its twin")
    for p in range(planes.shape[0]):
        if not same(ops.int4_quant_plane(planes[p]),
                    ref.int4_quant_plane(planes[p])):
            fail(f"int4_quant differs on plane {p} alone")
    check_threshold_special(gen)
    for n in RAGGED:
        for dt in (torch.float32, torch.bfloat16):
            x = spread((3, n), gen)
            if n >= 12:
                x[:, 8:12] = torch.tensor([0.75, -0.75, 0.75, 1.5])  # ties
            planes = ref.to_plane(x.to(dt))
            thresh = torch.tensor([0.75, 1.5, 0.0], device="cuda")
            if not same(ops.threshold_mask_plane(planes, thresh),
                        ref.threshold_mask_plane(planes, thresh.to(dt))):
                fail(f"threshold_mask differs (n={n}, {dt})")
            param = ref.to_plane(spread((n,), gen).to(dt))
            check_apply_sign_update(param, gen, (1e-3, -0.37), f"n={n}")
    for dt in (torch.float32, torch.bfloat16):
        param = ref.to_plane(spread((5 * 4096,), gen))
        param[:32, :8] = ASU_SPECIAL[(torch.arange(32)[:, None]
                                      + torch.arange(8)) % 8]
        check_apply_sign_update(param.to(dt), gen, ASU_SCALES,
                                "special values")


#: apply_sign_update's special parameters, planted in rows 0-31, lanes 0-7
#: (each meets every bit of random sign and mask words), and its scales
ASU_SPECIAL = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                            -float("inf"), 1e-40, -3e-39, -9.2e-41])
ASU_SCALES = (1e-3, -0.37, 0.0, -0.0, float("inf"), float("nan"))


def check_apply_sign_update(param, gen, scales, what: str) -> None:
    """apply_sign_update on random words under each scale, given as a
    float and as a one-element tensor, against its twin."""
    from repro_torch.kernels import ops, ref

    r = param.shape[0] // 32
    sw, mw = rand_words((r, 128), gen), rand_words((r, 128), gen)
    for scale in scales:
        for arg in (scale, torch.tensor([scale], device="cuda")):
            if not same(ops.apply_sign_update(param, sw, mw, arg),
                        ref.apply_sign_update(param, sw, mw, arg)):
                fail(f"apply_sign_update differs ({what}, {param.dtype}, "
                     f"scale={scale} as {type(arg).__name__})")


def time_slice3_kernels(gen) -> dict:
    """The four kernels of the third slice at the main path's largest
    leaf: vote_pipeline on one worker's bf16 plane (run E's shape),
    decoded to float32 and to bfloat16, int4 on W = 4 float32 planes and
    threshold_mask on W = 4 bf16 planes (runs C and D; float32 printed
    beside), apply_sign_update on a bf16 and a float32 parameter plane
    (float32 printed beside)."""
    from repro_torch.kernels import fused, ops, ref

    n, w, bf16, f32 = MAIN_N, MAIN_W, 2, 4
    rows = {}
    one = ref.to_plane(torch.randn((1, n), device="cuda",
                                   generator=gen).to(torch.bfloat16))
    gate = fused.local_gate_words(one.shape[1] // 32, ternary=False,
                                  device="cuda")
    u_plain = ref.vote_pipeline_dense(one, 1, gate)
    for name, out in (("vote_pipeline", torch.float32),
                      ("vote_pipeline_bf16", torch.bfloat16)):
        u = ops.vote_pipeline(one, gate, num_workers=1, dtype=out)
        if not same(u, u_plain.to(out)):
            fail(f"vote_pipeline differs at the main-path leaf ({out})")
        size = u.element_size()
        rows[name] = dict(
            ms=time_ms(lambda: ops.vote_pipeline(one, gate, num_workers=1,
                                                 dtype=out)),
            plain_ms=time_ms(lambda: ref.vote_pipeline_dense(one, 1, gate)
                             .to(out), 3, 1),
            bytes=n * (bf16 + 1 / 8 + size), ops=n * 6,
            err=max_abs_err(u, u_plain), shape=f"n={n} W=1 bf16 -> {out}")
        del u
    del one, gate, u_plain

    planes = ref.to_plane(torch.randn((w, n), device="cuda", generator=gen)
                          .to(torch.bfloat16).to(torch.float32))
    q = ops.int4_quant_plane(planes)
    q_plain = ref.int4_quant_plane(planes)
    if not same(q, q_plain):
        fail("int4_quant differs at the main-path leaf")
    rows["int4_quant"] = dict(
        ms=time_ms(lambda: ops.int4_quant_plane(planes)),
        plain_ms=time_ms(lambda: ref.int4_quant_plane(planes), 3, 1),
        bytes=w * n * 3 * f32, ops=w * n * 8,
        err=max_abs_err(q, q_plain), shape=f"n={n} W={w} f32, 2 launches")
    del planes, q, q_plain

    # threshold_mask in bf16 (run D's payload) and float32, each beside
    # one hardshrink call on the same planes: the same bytes, and the same
    # values but at ties |x| == t, which hardshrink drops
    x = torch.randn((w, n), device="cuda", generator=gen)
    for dt in (torch.bfloat16, torch.float32):
        planes = ref.to_plane(x.to(dt))
        thresh = torch.full((w,), 1.862, device="cuda").to(dt)
        lambd = float(thresh[0])
        m = ops.threshold_mask_plane(planes, thresh)
        m_plain = ref.threshold_mask_plane(planes, thresh)
        if not same(m, m_plain):
            fail(f"threshold_mask differs at the main-path leaf ({dt})")
        size = planes.element_size()
        row = dict(
            ms=time_ms(lambda: ops.threshold_mask_plane(planes, thresh)),
            plain_ms=time_ms(lambda: ref.threshold_mask_plane(planes,
                                                              thresh), 3, 1),
            library_ms=time_ms(lambda: torch.nn.functional.hardshrink(
                planes, lambd)),
            bytes=w * n * 2 * size, ops=w * n * 2,
            err=max_abs_err(m, m_plain), shape=f"n={n} W={w} {dt}")
        if dt == torch.float32:     # printed, and kept in PERF.md
            finish_rows({"threshold_mask": row}, "")
        else:
            rows["threshold_mask"] = row
        del planes, m, m_plain
    del x

    # apply_sign_update: its ms is the kernel's own, with the scale as a
    # tensor made once; the float scale (passed by value) is timed beside
    r = n // 4096
    sw, mw = rand_words((r, 128), gen), rand_words((r, 128), gen)
    scale = torch.tensor(1e-3, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        param = ref.to_plane(torch.randn((n,), device="cuda", generator=gen)
                             .to(dt))
        a = ops.apply_sign_update(param, sw, mw, scale)
        a_plain = ref.apply_sign_update(param, sw, mw, scale)
        if not (same(a, a_plain)
                and same(ops.apply_sign_update(param, sw, mw, 1e-3), a)):
            fail(f"apply_sign_update differs at the main-path leaf ({dt})")
        size = param.element_size()
        row = dict(
            ms=time_ms(lambda: ops.apply_sign_update(param, sw, mw, scale)),
            float_scale_ms=time_ms(lambda: ops.apply_sign_update(
                param, sw, mw, 1e-3)),
            plain_ms=time_ms(lambda: ref.apply_sign_update(param, sw, mw,
                                                           scale), 3, 1),
            bytes=n * (2 * size + 1 / 4), ops=n * 6,
            err=max_abs_err(a, a_plain), shape=f"n={n} {dt}")
        if dt == torch.float32:     # printed, and kept in PERF.md
            finish_rows({"apply_sign_update": row}, "")
        else:
            rows["apply_sign_update"] = row
        del param, a, a_plain
    finish_rows(rows, "")
    return rows


# ---------------------------------------------------------------------------
# phase 4: the main path — data-parallel qwen3-0.6B training runs
# ---------------------------------------------------------------------------

def twin_vote(flat: torch.Tensor) -> torch.Tensor:
    """The packed G-Binary vote of a (W, N) bucket with the plain twins."""
    from repro_torch.kernels import ref
    w, n = flat.shape
    words = ref.sign_pack(ref.to_plane(flat))
    return twin_combine_decode(words, n).to(flat.dtype)


def twin_combine_decode(words: torch.Tensor, n: int) -> torch.Tensor:
    """(W, R, LANE) sign words -> the decoded flat G-Binary aggregate
    (n,), with the twins.  Word rows vote independently, so one combine
    over all rows equals the per-owner combines the all_to_all sets up."""
    from repro_torch.kernels import ref
    w = words.shape[0]
    gate = torch.full(words.shape[1:], ref.ALL_ONES, dtype=torch.int32,
                      device=words.device)
    sw, mw = ref.vote_combine(words, w, gate)
    return ref.from_plane(ref.unpack_ternary(sw, mw), n)


def drive(name: str, fabric, plan, steps: int, expect: dict,
          on_step=None, batch: int = 16, cfg=None, seq_len: int = 128,
          optimizer=None, buckets: tuple = (9, LOWBIT_BUCKETS),
          decodes: dict | None = None) -> dict:
    """Train ``cfg`` (full qwen3-0.6B by default) ``steps`` steps under
    ``plan`` on global batches of ``batch`` x ``seq_len`` tokens (AdamW by
    default; an encoder-decoder's batches carry seeded ``frames``); check
    the layout's ``buckets`` (all, low-bit[, float32 low-bit]), finite
    losses, the low-bit aggregates ({-1, 0, +1} for a vote codec, finite
    for a mean codec) and, per step, exactly ``expect[k]`` launches of
    each kernel k (0 for the others) and, given ``decodes``, exactly
    ``decodes[dtype]`` unpack_ternary launches into each output dtype."""
    from repro_torch.configs import get_config
    from repro_torch.core import codec_name
    from repro_torch.core import tree as T
    from repro_torch.data import FramesStream, SyntheticLMStream
    from repro_torch.fabric import get_codec, layout_kernel_stats
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    cfg = cfg or get_config("qwen3_0p6b")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=seq_len,
                             batch=batch, seed=0, learnable=False)
    if cfg.family == "encdec":
        data = FramesStream(data, cfg.encoder_seq, cfg.d_model)
    optimizer = optimizer or AdamW(peak_lr=3e-4, warmup_steps=2,
                                   total_steps=steps)
    trainer = Trainer(cfg, optimizer, data, plan=plan, fabric=fabric, seed=0,
                      device="cuda")
    t0 = time.perf_counter()
    state = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = state.model.tree()
    layout = fabric.layout_for(params, plan)
    lowbit = [b for b in layout.buckets if codec_name(b.key.mode) != "fp32"]
    got = (len(layout.buckets), len(lowbit),
           sum(b.key.dtype == "float32" for b in lowbit))[:len(buckets)]
    if got != tuple(buckets):
        fail(f"{name}: layout has (buckets, low-bit, float32 low-bit) "
             f"{got}; expected {buckets}")
    codec = get_codec(lowbit[0].key.mode)
    if codec.reduction == "hierarchical":       # a hop plan: its backbone
        codec = get_codec(codec.plan.hops[-1].codec)
    votes = codec.reduction == "vote"
    backbone = {s.name for b in lowbit for s in b.slots}
    print(f"[{name}] model {cfg.name}: "
          f"{sum(p.numel() for p in T.leaves(params))} params, "
          f"{len(lowbit)} low-bit {lowbit[0].key.schedule} "
          f"{'buckets' if fabric.fused else 'leaves'}, modeled "
          f"{layout_kernel_stats(layout, fabric.num_workers)}", flush=True)

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    by_dtype = dict(wrappers["unpack_ternary"].launches_by_dtype)
    decode_by = wrappers["unpack_ternary"].launches_by_dtype
    for k in range(steps):
        before = {kn: fn.launches for kn, fn in wrappers.items()}
        dtype_before = dict(decode_by)
        ef_before = trainer.state.ef
        trainer.run(k + 1)
        rec = trainer.history[-1]
        delta = {kn: fn.launches - before[kn] for kn, fn in wrappers.items()}
        want = {kn: expect.get(kn, 0) for kn in wrappers}
        if delta != want:
            fail(f"{name} step {k}: kernel launches {delta}, expected {want}")
        split = {dt: n - dtype_before[dt] for dt, n in decode_by.items()}
        if decodes is not None and split != decodes:
            fail(f"{name} step {k}: unpack_ternary launches by output dtype "
                 f"{split}, expected {decodes}")
        if not np.isfinite(rec["loss"]):
            fail(f"{name} step {k}: loss {rec['loss']}")
        for path, u in T.flatten(trainer.last_aggregates):
            if path in backbone and votes:
                vals = torch.unique(u.to(torch.float32))
                if not set(vals.tolist()) <= {-1.0, 0.0, 1.0}:
                    fail(f"{name} step {k}: aggregate {path} holds "
                         f"{vals[:8]}")
            elif path in backbone and not bool(torch.isfinite(u).all()):
                fail(f"{name} step {k}: aggregate {path} is not finite")
        if on_step is not None:
            on_step(k, ef_before, trainer.state.ef)
        print(f"[{name}] step {k}: loss {rec['loss']:.6f} time "
              f"{rec['step_time_s']:.4f} s traffic_ratio "
              f"{rec['traffic_ratio']:.6f} launches "
              f"{ {kn: d for kn, d in delta.items() if d} }", flush=True)
    launches = {kn: fn.launches for kn, fn in wrappers.items()}
    # the decode's launches by output dtype: a row each in the kernels line
    split = {dt: v - by_dtype[dt] for dt, v in
             wrappers["unpack_ternary"].launches_by_dtype.items()}
    launches["unpack_ternary"] = split[torch.float32]
    launches["unpack_ternary_bf16"] = split[torch.bfloat16]
    hist = trainer.history
    batch = {kk: torch.as_tensor(v).cuda()
             for kk, v in data.batch_at(steps).items()}
    return {"trainer": trainer, "params": params, "lowbit": lowbit,
            "batch": batch, "launches": launches, "init_s": init_s,
            "step_s": [h["step_time_s"] for h in hist],
            "loss": [h["loss"] for h in hist],
            "traffic_ratio": hist[-1]["traffic_ratio"]}


def report(name: str, run: dict, extra: str = "") -> None:
    print(f"[{name}] losses {run['loss']}", flush=True)
    print(f"[{name}] step seconds {run['step_s']} (init {run['init_s']:.2f} "
          f"s), peak memory {run['peak_gib']:.2f} GiB, traffic ratio "
          f"{run['traffic_ratio']:.6f}{extra}", flush=True)


def run_gbin_packed(steps: int = 5) -> dict:
    """The main path: bucketed gbin_packed on the fused kernels."""
    from repro_torch.fabric import Fabric, plan_presets

    plan = plan_presets()["gbin_packed"]
    fabric = Fabric(num_workers=MAIN_W)
    run = drive("gbin_packed", fabric, plan, steps,
                dict.fromkeys(("sign_pack", "vote_combine", "unpack_ternary"),
                              LOWBIT_BUCKETS))
    if (run["launches"]["unpack_ternary_bf16"] != steps * LOWBIT_BUCKETS
            or run["launches"]["unpack_ternary"]):
        fail(f"gbin_packed: the bf16 buckets' decodes were not all bf16 "
             f"launches: {run['launches']}")
    extra = check_twin_step("gbin_packed", fabric, plan, run)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    report("gbin_packed", run, extra)
    return run


#: elements of a bucket the twins vote on at once (whole sign words)
TWIN_CHUNK = 2 ** 25


def check_twin_step(name: str, fabric, plan, run: dict) -> str:
    """One more step's worker gradients through ``fabric.aggregate`` and
    through the plain twins, bucket by bucket: the vote aggregates must be
    byte-equal.  Returns the timing text for :func:`report`."""
    from repro_torch.core import tree as T
    trainer = run["trainer"]
    trainer.last_aggregates = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = fabric.worker_grads(run["params"], run["batch"],
                                   trainer.state.model.loss)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    agg, _ = fabric.aggregate(grads, plan)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gl, al = dict(T.flatten(grads)), dict(T.flatten(agg))
    w = fabric.num_workers
    for bucket in run["lowbit"]:
        flat = torch.cat([gl[s.name].reshape(w, -1) for s in bucket.slots],
                         dim=1)
        got = torch.cat([al[s.name].reshape(-1) for s in bucket.slots])
        # elements vote independently: the twins take the bucket in
        # chunks of whole sign words, which bounds their int64 unpacking
        for c in range(0, bucket.size, TWIN_CHUNK):
            if not same(got[c:c + TWIN_CHUNK],
                        twin_vote(flat[:, c:c + TWIN_CHUNK])):
                names = [s.name for s in bucket.slots
                         if s.offset < c + TWIN_CHUNK
                         and c < s.offset + s.size]
                fail(f"{name}: aggregate {names} differs from the plain "
                     f"twins in elements {c}..{c + TWIN_CHUNK}")
        del flat, got
    print(f"[{name}] one step's aggregates byte-equal to the plain twins",
          flush=True)
    return (f", worker grads {t1 - t0:.4f} s, bucketed aggregate "
            f"{t2 - t1:.4f} s")


def run_per_leaf_ef(steps: int = 3) -> dict:
    """Run A: per-leaf aggregation with error feedback in the kernels."""
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.kernels import ref

    plan = plan_presets(error_feedback=True)["gbin_packed"]
    fabric = Fabric(num_workers=MAIN_W, fused=False)
    ef_paths = set()

    def residuals_updated(k, before, after):
        moved = {p for (p, a), (_, b) in zip(T.flatten(before),
                                             T.flatten(after))
                 if a.dim() and not torch.equal(a, b)}
        if not moved or moved != {p for p, a in T.flatten(after) if a.dim()}:
            fail(f"A step {k}: residuals updated on {sorted(moved)} only")
        ef_paths.update(moved)

    run = drive("A per-leaf EF", fabric, plan, steps,
                dict.fromkeys(("encode_pack_ef", "vote_combine",
                               "unpack_ternary", "ef_residual"),
                              LOWBIT_BUCKETS), on_step=residuals_updated)
    trainer = run["trainer"]
    backbone = {s.name for b in run["lowbit"] for s in b.slots}
    if ef_paths != backbone:
        fail(f"A: EF on {sorted(ef_paths)}, backbone {sorted(backbone)}")
    for p, e in T.flatten(trainer.state.ef):
        if p in backbone and (e.dtype != torch.float32
                              or e.shape[0] != MAIN_W):
            fail(f"A: residual {p} is {e.dtype} {tuple(e.shape)}")
    # one step's aggregates and residuals against the twin chain on the
    # same grads, the same residuals and the same beta
    grads, _ = fabric.worker_grads(run["params"], run["batch"],
                                   trainer.state.model.loss)
    ef = trainer.state.ef
    t0 = time.perf_counter()
    agg, new_ef = fabric.aggregate(grads, plan, ef=ef)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    gl, el = dict(T.flatten(grads)), dict(T.flatten(ef))
    al, nl = dict(T.flatten(agg)), dict(T.flatten(new_ef))
    for p in sorted(backbone):
        g, e = gl[p], el[p]
        n = g[0].numel()
        words, geff = ref.encode_pack_ef(ref.to_plane(g.reshape(MAIN_W, n)),
                                         ref.to_plane(e.reshape(MAIN_W, n)))
        u = twin_combine_decode(words, n).reshape(g.shape[1:]).to(g.dtype)
        if not same(al[p], u):
            fail(f"A: aggregate {p} differs from the twin chain")
        del words, u
        beta = ref.from_plane(geff, n).abs().mean(dim=1)
        resid = ref.from_plane(ref.ef_residual(geff, beta).to(e.dtype), n)
        if not same(nl[p], resid.reshape(e.shape)):
            fail(f"A: residual {p} differs from the twin chain")
        del geff, resid
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    report("A per-leaf EF", run, f", per-leaf EF aggregate {agg_s:.4f} s")
    return run


def run_staged(steps: int = 2) -> dict:
    """Run B: a packed G-Ternary backbone on the staged four-kernel chain."""
    from repro_torch.core import AdmissionPlan, AggregationMode, Schedule
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric

    plan = AdmissionPlan.lowbit_backbone(AggregationMode.G_TERNARY,
                                         schedule=Schedule.PACKED_A2A)
    fabric = Fabric(num_workers=MAIN_W, fused_kernels=False)
    run = drive("B staged", fabric, plan, steps,
                dict.fromkeys(("sign_pack", "popcount_stack",
                               "majority_decode", "unpack_ternary"),
                              LOWBIT_BUCKETS))
    trainer = run["trainer"]
    grads, _ = fabric.worker_grads(run["params"], run["batch"],
                                   trainer.state.model.loss)
    t0 = time.perf_counter()
    staged, _ = fabric.aggregate(grads, plan)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    fused_agg, _ = Fabric(num_workers=MAIN_W).aggregate(grads, plan)
    gated = 0
    for (p, a), (_, b) in zip(T.flatten(staged), T.flatten(fused_agg)):
        if not same(a, b):
            fail(f"B: staged aggregate {p} differs from the fused chain's")
        gated += int((a == 0).sum())
    if not gated:
        fail("B: no G-Ternary zero in the aggregates")
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    report("B staged", run, f", staged bucketed aggregate {agg_s:.4f} s")
    return run


def run_mean_codec(name: str, preset: str, kernel: str,
                   steps: int = 3) -> dict:
    """Runs C and D: a mean codec on the backbone's ``psum`` buckets."""
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric, get_codec, plan_presets
    from repro_torch.kernels import kernel_wrappers, ref

    plan = plan_presets()[preset]
    fabric = Fabric(num_workers=MAIN_W)
    per_bucket = 2 if kernel == "int4_quant" else 1     # int4: two launches
    run = drive(name, fabric, plan, steps,
                {kernel: per_bucket * LOWBIT_BUCKETS})
    trainer = run["trainer"]
    # one step's bucket means against the twin chain on the same grads:
    # each worker's twin encode, then the session's own mean
    grads, _ = fabric.worker_grads(run["params"], run["batch"],
                                   trainer.state.model.loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg, _ = fabric.aggregate(grads, plan)
    torch.cuda.synchronize()
    agg_s = time.perf_counter() - t0
    # the kernel switch off: a mean codec has no staged chain, so the
    # same kernels run and give the same bits
    wrapper = kernel_wrappers()[kernel]
    wrapper.launches = 0
    pinned, _ = Fabric(num_workers=MAIN_W,
                       fused_kernels=False).aggregate(grads, plan)
    if wrapper.launches != per_bucket * LOWBIT_BUCKETS:
        fail(f"{name}: fused_kernels=False launched {kernel} "
             f"{wrapper.launches} times")
    for (p, a), (_, b) in zip(T.flatten(pinned), T.flatten(agg)):
        if not same(a, b):
            fail(f"{name}: fused_kernels=False changed aggregate {p}")
    del pinned
    codec = get_codec(run["lowbit"][0].key.mode)
    gl, al = dict(T.flatten(grads)), dict(T.flatten(agg))
    topk_s = 0.0
    for bucket in run["lowbit"]:
        flat = torch.cat([gl[s.name].reshape(MAIN_W, -1)
                          for s in bucket.slots], dim=1)
        n = flat.shape[1]
        if kernel == "int4_quant":
            enc = ref.from_plane(ref.int4_quant_plane(
                ref.to_plane(flat.to(torch.float32))), n).to(flat.dtype)
        else:
            k = max(1, int(n * codec.fraction))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            thresh = torch.topk(flat.to(torch.float32).abs(), k,
                                dim=1).values[:, -1].to(flat.dtype)
            torch.cuda.synchronize()
            topk_s += time.perf_counter() - t1
            enc = ref.from_plane(ref.threshold_mask_plane(
                ref.to_plane(flat), thresh), n)
            ties = int((flat.abs() == thresh[:, None]).sum())
        want = fabric.group.all_reduce_mean(enc.to(torch.float32))
        for s in bucket.slots:
            if not same(al[s.name].reshape(-1),
                        want[s.offset:s.offset + s.size]):
                fail(f"{name}: aggregate {s.name} differs from the twin "
                     f"chain")
        if kernel == "threshold_mask":
            nz = int((want != 0).sum())
            if not 0 < nz <= MAIN_W * k + ties:
                fail(f"{name}: bucket of {n} holds {nz} nonzeros, more than "
                     f"W * k = {MAIN_W * k} plus {ties} ties")
        del flat, enc, want
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    extra = f", bucketed aggregate {agg_s:.4f} s"
    if kernel == "threshold_mask":
        extra += f" (torch.topk alone, timed apart: {topk_s:.4f} s)"
    report(name, run, extra)
    return run


def time_in_path(fabric, grads, plan, lowbit, aggregates: int = 5) -> None:
    """vote_pipeline's device time inside run E's own aggregates, in the
    memory state the path leaves (blocks the caching allocator hands out
    again): ``torch.profiler`` over a few more aggregates; the sum of an
    aggregate's launches and the launches on the largest buckets, each
    beside the bound of the bytes they move."""
    from torch.profiler import ProfilerActivity, profile

    sizes = sorted(b.size for b in lowbit)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(aggregates):
            fabric.aggregate(grads, plan)
        torch.cuda.synchronize()
    ms = [e.device_time / 1e3 for e in sorted(
        prof.events(), key=lambda e: e.time_range.start)
          if "vote_pipeline_kernel" in e.name]
    if len(ms) != aggregates * len(sizes):
        print(f"[E host-local] vote_pipeline in the path: not measured "
              f"({len(ms)} kernel events traced)", flush=True)
        return
    per = len(sizes)
    totals = [sum(ms[i:i + per]) for i in range(0, len(ms), per)]
    # the launches on the largest buckets: the longest of each aggregate
    top = sizes.count(sizes[-1])
    big = [t for i in range(0, len(ms), per)
           for t in sorted(ms[i:i + per])[-top:]]
    bound_ms = [n * (2 + 1 / 8 + 2) / HBM_BYTES_PER_S * 1e3
                for n in (sum(sizes), sizes[-1])]
    for what, ts, b in ((f"all {per} launches of an aggregate", totals,
                         bound_ms[0]),
                        (f"a launch at n={sizes[-1]}", big, bound_ms[1])):
        print(f"[E host-local] vote_pipeline bf16 -> bf16 in the path, "
              f"{what}: median {np.median(ts):.4f} ms over {len(ts)}, "
              f"range {min(ts):.4f}-{max(ts):.4f}, bound {b:.4f} ms "
              f"({np.median(ts) / b:.2f}x)", flush=True)


def run_host_local() -> dict:
    """Run E: one worker's gradients through the host-local session."""
    from repro_torch.configs import get_config
    from repro_torch.core import (AdmissionPlan, AggregationMode, LocalGroup,
                                  Schedule, codec_name)
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.models import Transformer

    cfg = get_config("qwen3_0p6b")
    model = Transformer(cfg, device="cuda", seed=0)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=4,
                             seed=0, learnable=False)
    batch = {k: torch.as_tensor(v).cuda() for k, v in data.batch_at(0).items()}
    params = model.tree()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, loss = Fabric(group=LocalGroup()).worker_grads(params, batch,
                                                          model.loss)
    torch.cuda.synchronize()
    print(f"[E host-local] one worker's gradients on 4 x 128 tokens: loss "
          f"{float(loss):.6f}, {time.perf_counter() - t0:.4f} s", flush=True)
    like = T.map_leaves(lambda g: g[0], grads)
    ternary = AdmissionPlan.lowbit_backbone(AggregationMode.G_TERNARY,
                                            schedule=Schedule.PACKED_A2A)
    cases = (("gbin_packed", plan_presets()["gbin_packed"], True),
             ("packed G-Ternary", ternary, True),
             ("gbin_packed EF, per leaf",
              plan_presets(error_feedback=True)["gbin_packed"], False))
    wrappers = kernel_wrappers()
    by_dtype = wrappers["vote_pipeline"].launches_by_dtype
    launches = dict.fromkeys(wrappers, 0)
    launches["vote_pipeline_bf16"] = 0
    for label, plan, fused in cases:
        fabric = Fabric(group=LocalGroup(), fused=fused)
        lowbit = [b for b in fabric.layout_for(like, plan).buckets
                  if codec_name(b.key.mode) != "fp32"]
        backbone = {s.name for b in lowbit for s in b.slots}
        if len(lowbit) != LOWBIT_BUCKETS or len(backbone) != LOWBIT_BUCKETS:
            fail(f"E {label}: {len(lowbit)} low-bit buckets")
        ef = None if fused else fabric.init_ef(like,
                                               fabric.resolve(like, plan))
        expect = dict.fromkeys(wrappers, 0)
        expect["vote_pipeline"] = LOWBIT_BUCKETS
        if ef is not None:
            expect["ef_residual"] = LOWBIT_BUCKETS
        for rnd in range(1 if ef is None else 2):   # EF: zero, then moved
            for fn in wrappers.values():
                fn.launches = 0
            bf16_before = by_dtype[torch.bfloat16]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agg, new_ef = fabric.aggregate(grads, plan, ef=ef)
            torch.cuda.synchronize()
            agg_s = time.perf_counter() - t0
            got = {kn: fn.launches for kn, fn in wrappers.items()}
            if got != expect:
                fail(f"E {label}: kernel launches {got}, expected {expect}")
            # the bf16 gradients' votes decode straight into bf16
            bf16 = by_dtype[torch.bfloat16] - bf16_before
            if bf16 != got["vote_pipeline"]:
                fail(f"E {label}: {got['vote_pipeline'] - bf16} of "
                     f"{got['vote_pipeline']} vote_pipeline launches did "
                     f"not decode into bf16")
            for kn, v in got.items():
                launches[kn] += v
            launches["vote_pipeline"] -= bf16
            launches["vote_pipeline_bf16"] += bf16
            al = dict(T.flatten(agg))
            for p in backbone:
                vals = set(torch.unique(al[p].to(torch.float32)).tolist())
                if not vals <= {-1.0, 0.0, 1.0}:
                    fail(f"E {label}: aggregate {p} holds {sorted(vals)[:8]}")
            for other, chain in (
                    (Fabric(num_workers=1, fused=fused), "three-kernel"),
                    (Fabric(group=LocalGroup(), fused=fused,
                            fused_kernels=False), "staged")):
                b_agg, b_ef = other.aggregate(grads, plan, ef=ef)
                bl = dict(T.flatten(b_agg))
                be = {} if ef is None else dict(T.flatten(b_ef))
                ne = {} if ef is None else dict(T.flatten(new_ef))
                for p in backbone:
                    if not same(al[p], bl[p]) or (
                            ef is not None and not same(ne[p], be[p])):
                        fail(f"E {label}: {p} differs from the {chain} "
                             f"chain")
                del b_agg, b_ef
            print(f"[E host-local] {label}{' round ' + str(rnd) if ef else ''}"
                  f": aggregate {agg_s:.4f} s, launches "
                  f"{ {k: v for k, v in got.items() if v} }, equal to the "
                  f"three-kernel and staged chains", flush=True)
            if label == "gbin_packed":
                time_in_path(fabric, grads, plan, lowbit)
            ef = new_ef
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[E host-local] peak memory {peak:.2f} GiB", flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# the control plane: the paper controller, grad_accum, the accuracy harness
# ---------------------------------------------------------------------------

def _launch_deltas(wrappers, before, by_dtype_before) -> dict:
    """Launches since ``before``, with unpack_ternary split by dtype."""
    delta = {kn: fn.launches - before[kn] for kn, fn in wrappers.items()}
    split = wrappers["unpack_ternary"].launches_by_dtype
    delta["unpack_ternary"] = split[torch.float32] - \
        by_dtype_before[torch.float32]
    delta["unpack_ternary_bf16"] = split[torch.bfloat16] - \
        by_dtype_before[torch.bfloat16]
    return delta


def cosines_f64(agg, groups) -> dict:
    """The per-group cosines of ``core/diagnostics.py`` recomputed in
    float64 from the same aggregates."""
    from repro_torch.core import tree as T
    acc: dict = {}
    for leaf, group in zip(T.leaves(agg), T.leaves(groups)):
        g = leaf.to(torch.float64).reshape(-1)
        ubin = torch.where(g == 0, g, torch.sign(g))
        idx = torch.arange(g.numel(), device=g.device)
        uter = ubin * ((idx % 3) != 2).to(torch.float64)
        d = acc.setdefault(group, [0.0] * 5)
        for i, v in enumerate((ubin @ g, uter @ g, g @ g, ubin @ ubin,
                               uter @ uter)):
            d[i] += float(v)
        del g, ubin, idx, uter
    return {group: {"gbinary": nb / (np.sqrt(gg) * np.sqrt(bb) + 1e-12),
                    "gternary": nt / (np.sqrt(gg) * np.sqrt(tt) + 1e-12)}
            for group, (nb, nt, gg, bb, tt) in acc.items()}


def run_paper_controller(steps: int = 5, warmup: int = 2) -> dict:
    """Run F: the paper controller on full qwen3-0.6B, W = 4.

    Steps 0 and 1 run on the FP32 bypass with diagnostics and launch no
    kernel; the Commander admits its plan from step 1's cosines (printed,
    and held to a float64 recomputation from the same aggregates); each
    later step launches what the admitted layout models."""
    from repro_torch.configs import get_config
    from repro_torch.core import (Commander, Schedule, cosines_to_host,
                                  group_cosines_from_mean)
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import (Fabric, Telemetry, get_codec,
                                    layout_kernel_stats, make_controller)
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    cfg = get_config("qwen3_0p6b")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=16,
                             seed=0, learnable=False)
    commander = Commander(schedule=Schedule.PACKED_A2A)
    controller = make_controller("paper", commander=commander,
                                 warmup_steps=warmup)
    fabric = Fabric(num_workers=MAIN_W)
    trainer = Trainer(cfg, AdamW(peak_lr=3e-4, warmup_steps=2,
                                 total_steps=steps),
                      data, controller=controller, fabric=fabric, seed=0,
                      device="cuda")
    state = trainer.init_state()
    params = state.model.tree()
    groups = fabric.groups(params)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    by_dtype = dict(wrappers["unpack_ternary"].launches_by_dtype)
    launches: dict = {}
    for k in range(steps):
        before = {kn: fn.launches for kn, fn in wrappers.items()}
        dt_before = dict(wrappers["unpack_ternary"].launches_by_dtype)
        plan = controller.plan
        calibrating = controller.wants_diagnostics
        trainer.run(k + 1)
        rec = trainer.history[-1]
        delta = _launch_deltas(wrappers, before, dt_before)
        if not np.isfinite(rec["loss"]):
            fail(f"F step {k}: loss {rec['loss']}")
        cos = Telemetry.from_metrics(k, rec).cosines
        if k < warmup:
            if not calibrating or cos is None or any(delta.values()):
                fail(f"F step {k}: the FP32 warm-up ran without "
                     f"diagnostics or launched {delta}")
            want = cosines_f64(trainer.last_aggregates, groups)
            err = max(abs(cos[g][m] - want[g][m])
                      for g in want for m in ("gbinary", "gternary"))
            print(f"[F paper] step {k} cosines " + ", ".join(
                f"{g}: gbinary {cos[g]['gbinary']:.6f} gternary "
                f"{cos[g]['gternary']:.6f}" for g in sorted(cos))
                + f"; float64 recomputation within {err:.2e}", flush=True)
            if set(cos) != set(want) or err > 1e-5:
                fail(f"F step {k}: cosines {cos} differ from their float64 "
                     f"recomputation {want}")
            cosines = cos
            # the diagnostics' own cost: the step's cosines again, alone
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cosines_to_host(group_cosines_from_mean(
                    trainer.last_aggregates, groups))
                ms.append((time.perf_counter() - t0) * 1e3)
            print(f"[F paper] step {k} diagnostics alone: "
                  f"{', '.join(f'{m:.2f}' for m in ms)} ms", flush=True)
        else:
            layout = fabric.layout_for(params, plan)
            packed = [b for b in layout.buckets
                      if b.key.schedule == "packed_a2a"
                      and get_codec(b.key.mode).reduction == "vote"]
            bf16 = sum(b.key.dtype == "bfloat16" for b in packed)
            expect = {"sign_pack": len(packed), "vote_combine": len(packed),
                      "unpack_ternary": len(packed) - bf16,
                      "unpack_ternary_bf16": bf16}
            want = {kn: expect.get(kn, 0) for kn in delta}
            modeled = layout_kernel_stats(layout, MAIN_W)["launches_fused"]
            if delta != want or sum(delta.values()) != modeled:
                fail(f"F step {k}: launches {delta}, the admitted layout "
                     f"models {want} ({modeled} in all)")
        for kn, v in delta.items():
            launches[kn] = launches.get(kn, 0) + v
        print(f"[F paper] step {k}: loss {rec['loss']:.6f} time "
              f"{rec['step_time_s']:.4f} s traffic_ratio "
              f"{rec['traffic_ratio']:.6f} plan {rec['plan']} launches "
              f"{ {kn: d for kn, d in delta.items() if d} }", flush=True)
    events = [(e.step, e.kind) for e in controller.events]
    proposed = commander.propose(cosines)
    admitted = controller.plan
    print(f"[F paper] events "
          f"{[(e.step, e.kind, e.plan_signature) for e in controller.events]}",
          flush=True)
    if events != [(warmup - 1, "warmup_end"), (warmup - 1, "admitted")]:
        fail(f"F: events {events}")
    if admitted.signature() != proposed.signature():
        fail(f"F: admitted {admitted.signature()}, the Commander proposes "
             f"{proposed.signature()} on the printed cosines")
    if "packed_a2a" not in admitted.signature():
        fail(f"F: no packed low-bit bucket admitted: {admitted.signature()}")
    if any(e.dim() for e in T.leaves(trainer.state.ef)):
        fail("F: error-feedback state built past the warm-up plan")
    hist = trainer.history
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[F paper] losses {[h['loss'] for h in hist]}", flush=True)
    print(f"[F paper] step seconds {[h['step_time_s'] for h in hist]}, peak "
          f"memory {peak:.2f} GiB", flush=True)
    return {"launches": launches}


def run_grad_accum(steps: int = 2) -> dict:
    """Run G: ``build_step(..., grad_accum=2)`` under gbin_packed.  The
    gradients accumulate in float32, so the bf16-planned buckets carry
    float32 payloads: float32 aggregates and float32 decodes."""
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, TrainState, plan_presets
    from repro_torch.fabric.session import aggregate_tree_bucketed
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.models import Transformer
    from repro_torch.optim import AdamW

    cfg = get_config("qwen3_0p6b")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=16,
                             seed=0, learnable=False)
    model = Transformer(cfg, device="cuda", seed=0)
    fabric = Fabric(num_workers=MAIN_W)
    plan = plan_presets()["gbin_packed"]
    opt = AdamW(peak_lr=3e-4, warmup_steps=2, total_steps=steps)
    params = model.tree()
    step = fabric.build_step(opt, plan, params, model.loss, grad_accum=2)
    lowbit = [b for b in step.layout.buckets
              if b.key.schedule == "packed_a2a"]
    if len(lowbit) != LOWBIT_BUCKETS or \
            {b.key.dtype for b in lowbit} != {"bfloat16"}:
        fail(f"G: {len(lowbit)} packed buckets, dtypes "
             f"{ {b.key.dtype for b in lowbit} }")
    backbone = {s.name for b in lowbit for s in b.slots}
    state = TrainState(model=model, opt=opt.init(params),
                       ef=fabric.init_ef(params, step.policies))
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    launches: dict = {}
    expect = {"sign_pack": LOWBIT_BUCKETS, "vote_combine": LOWBIT_BUCKETS,
              "unpack_ternary": LOWBIT_BUCKETS}
    for k in range(steps):
        batch = {kk: torch.as_tensor(v).cuda()
                 for kk, v in data.batch_at(k).items()}
        before = {kn: fn.launches for kn, fn in wrappers.items()}
        dt_before = dict(wrappers["unpack_ternary"].launches_by_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics, agg = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        delta = _launch_deltas(wrappers, before, dt_before)
        if delta != {kn: expect.get(kn, 0) for kn in delta}:
            fail(f"G step {k}: launches {delta}, expected {expect}")
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            fail(f"G step {k}: loss {loss}")
        for path, u in T.flatten(agg):
            if u.dtype != torch.float32:
                fail(f"G step {k}: aggregate {path} is {u.dtype}")
            if path in backbone and not set(torch.unique(u).tolist()) <= \
                    {-1.0, 0.0, 1.0}:
                fail(f"G step {k}: aggregate {path} is not a vote")
        for kn, v in delta.items():
            launches[kn] = launches.get(kn, 0) + v
        print(f"[G grad_accum] step {k}: loss {loss:.6f} time {dt:.4f} s "
              f"launches { {kn: d for kn, d in delta.items() if d} }",
              flush=True)
    # one step's aggregation against the plain twins on the same float32
    # gradients
    batch = {kk: torch.as_tensor(v).cuda()
             for kk, v in data.batch_at(steps).items()}
    grads, _ = fabric.worker_grads(params, batch, model.loss, grad_accum=2)
    agg, _ = aggregate_tree_bucketed(fabric.context, grads, step.policies,
                                     layout=step.layout)
    gl, al = dict(T.flatten(grads)), dict(T.flatten(agg))
    for bucket in lowbit:
        flat = torch.cat([gl[s.name].reshape(MAIN_W, -1)
                          for s in bucket.slots], dim=1)
        if flat.dtype != torch.float32:
            fail(f"G: bucket payload is {flat.dtype}")
        want = twin_vote(flat)
        for s in bucket.slots:
            if not same(al[s.name].reshape(-1),
                        want[s.offset:s.offset + s.size]):
                fail(f"G: aggregate {s.name} differs from the plain twins")
        del flat, want
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[G grad_accum] aggregates float32, byte-equal to the plain "
          f"twins; peak memory {peak:.2f} GiB", flush=True)
    return {"launches": launches}


#: the HARD settings of benchmarks/bench_convergence.py
HARD = dict(steps=700, batch=64, warmup_fp32=50, seed=0)
HARD_RUNS = {"fp32_all": dict(policy="fp32"),
             "gbinary_all": dict(policy="gbinary", lr=2e-4),
             "gbinary_backbone_fp32_head": dict(policy="gbinary",
                                                head_policy="fp32", lr=2e-4),
             "sign_of_mean": dict(policy="sign_of_mean", lr=2e-4)}
#: repro.core.experiments.run_training's (accuracy, traffic ratio) on the
#: same settings, JAX 0.9.0 on the CPU (the reference; recomputed by
#: tests/test_torch_experiments.py)
REFERENCE_CPU = {"fp32_all": (0.890625, 1.0),
                 "gbinary_all": (0.81201171875, 0.10044642857142858),
                 "gbinary_backbone_fp32_head": (0.9189453125,
                                                0.31424555173306806),
                 "sign_of_mean": (0.95654296875, 1.0),
                 "pilot": (0.875, None)}


def run_harness() -> dict:
    """Run H: the virtual-worker accuracy harness on the card: the four
    HARD runs and the guarded pilot of ``benchmarks/bench_recovery.py``."""
    from repro_torch.core import Commander, CusumGuard, Supervisor
    from repro_torch.core.experiments import hard_task, run_training
    from repro_torch.fabric import Telemetry, make_controller

    acc = {}
    for name, kw in HARD_RUNS.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_training(hard_task(), device="cuda", **HARD, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref_acc, ref_ratio = REFERENCE_CPU[name]
        print(f"[H harness] {name}: accuracy {r.final_acc:.6f} (reference "
              f"on the CPU {ref_acc:.6f}), traffic ratio "
              f"{r.traffic_ratio!r}, {dt:.2f} s", flush=True)
        if abs(r.traffic_ratio - ref_ratio) > 1e-9:
            fail(f"H {name}: traffic ratio {r.traffic_ratio}, the "
                 f"reference's {ref_ratio}")
        if not all(np.isfinite(r.losses)):
            fail(f"H {name}: non-finite loss")
        acc[name] = r.final_acc
    if acc["gbinary_all"] > acc["fp32_all"] - 0.04:
        fail(f"H: gbinary_all {acc['gbinary_all']} is not 4 points under "
             f"fp32_all {acc['fp32_all']}")
    if acc["gbinary_backbone_fp32_head"] < acc["gbinary_all"] + 0.05:
        fail(f"H: the layer-aware run {acc['gbinary_backbone_fp32_head']} "
             f"is not 5 points over gbinary_all {acc['gbinary_all']}")

    # benchmarks/bench_recovery.py::_pilot(degrade=(250, 280))
    cp = make_controller(
        "paper", commander=Commander(tau_binary=0.2),
        supervisor=Supervisor(guard=CusumGuard(kappa=0.02, h=0.6),
                              cooldown_steps=60),
        warmup_steps=50)
    lowbit = []

    def callback(step, loss):
        plan = cp.observe(Telemetry(step=step, loss=loss, cosines={
            "backbone": {"gbinary": 0.8, "gternary": 0.7},
            "head": {"gbinary": 0.8, "gternary": 0.7}}))
        lowbit.append("gbinary" in plan.signature())
        return ("gbinary", "gbinary") if lowbit[-1] else ("fp32", "fp32")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = run_training(hard_task(), policy="fp32", steps=600, batch=64,
                     lr=2e-4, warmup_fp32=0, degrade=(250, 280),
                     plan_callback=callback, seed=0, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    kinds = [e.kind for e in cp.events]
    traffic = sum(1 / 32 if lb else 1.0 for lb in lowbit) / len(lowbit)
    print(f"[H harness] pilot: accuracy {r.final_acc:.6f} (reference on the "
          f"CPU {REFERENCE_CPU['pilot'][0]:.6f}), low-bit steps "
          f"{sum(lowbit)} of {len(lowbit)}, traffic ratio {traffic!r}, "
          f"{dt:.2f} s, events {[(e.step, e.kind) for e in cp.events]}",
          flush=True)
    if not {"admitted", "recovery", "readmitted"} <= set(kinds):
        fail(f"H pilot: events {kinds}")
    return {"launches": {}}


# ---------------------------------------------------------------------------
# the model zoo: blocked attention at 4096 tokens, gemma3-27b and
# deepseek-moe-16b at full width
# ---------------------------------------------------------------------------

ATTN_TOKENS = 4096
#: the blocked and the full-scores paths agree to 2 bf16 ulps of the
#: largest value (each rounds p to bf16 for the PV product, over other
#: partial sums, and the output to bf16)
ATTN_BOUND = 2.0 ** -6


def check_blocked_attention() -> dict:
    """One gemma3-27b layer's q, k and v at full width and 4096 tokens
    (bf16, weights from a seed): the blocked path against the full-scores
    path, forward and the gradient of a fixed cotangent, on a local
    (window 1024) and the global layer; each path timed forward and
    backward, and ``scaled_dot_product_attention`` on the same shapes as
    a yardstick only (the port never calls it)."""
    import math

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config("gemma3_27b")
    s, d, h, kv, hd = (ATTN_TOKENS, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.hd)
    g = h // kv
    gen = torch.Generator(device="cuda").manual_seed(11)

    def weight(n, m):
        return (torch.randn((n, m), generator=gen, device="cuda")
                / math.sqrt(n)).to(torch.bfloat16)

    p = {"wq": weight(d, h * hd), "wk": weight(d, kv * hd),
         "wv": weight(d, kv * hd),
         "q_norm": {"scale": torch.ones(hd, device="cuda")},
         "k_norm": {"scale": torch.ones(hd, device="cuda")}}
    x = torch.randn((1, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        q, k, v = L._qkv(p, x, cfg, torch.arange(s, device="cuda")[None])
    ct = torch.randn((1, s, h * hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    pos = torch.arange(s, device="cuda")

    def blocked(q, k, v, is_global):
        return L._flash_attention(
            q.reshape(1, s, kv, g, hd), k, v, causal=True,
            window=cfg.sliding_window, is_global=is_global,
            scale=1.0 / math.sqrt(hd)).reshape(1, s, h * hd)

    def full(q, k, v, is_global):
        return L._full_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window,
                                 is_global=is_global)

    def sdpa(q, k, v, is_global):
        mask = L._mask_block(pos, pos, causal=True, window=cfg.sliding_window,
                             is_global=is_global)
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
        return out.transpose(1, 2).reshape(1, s, h * hd)

    def fwd_bwd(fn, is_global):
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        out = fn(qq, kk, vv, is_global)
        return (out.detach(), *torch.autograd.grad(out, (qq, kk, vv), ct))

    for is_global in (False, True):
        layer = "global" if is_global else "local"
        got, want = fwd_bwd(blocked, is_global), fwd_bwd(full, is_global)
        errs = []
        for part, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            err = max_abs_err(a, b)
            bound = ATTN_BOUND * float(b.float().abs().max())
            if not (bool(torch.isfinite(a).all()) and err <= bound):
                fail(f"blocked attention, {layer} layer: {part} is "
                     f"{err} from the full-scores path (bound {bound})")
            errs.append(f"{part} {err:.6g} (bound {bound:.6g})")
        del got, want
        ms = {name: time_ms(lambda fn=fn: fwd_bwd(fn, is_global), iters=5,
                            warmup=1)
              for name, fn in (("blocked", blocked), ("full", full),
                               ("sdpa", sdpa))}
        print(f"[attention] gemma3-27b {layer} layer, {s} tokens, bf16: "
              f"blocked vs full-scores max abs err {', '.join(errs)}; "
              f"forward+backward {ms['blocked']:.4f} ms blocked, "
              f"{ms['full']:.4f} ms full scores, {ms['sdpa']:.4f} ms "
              f"scaled_dot_product_attention (yardstick only), on "
              f"{card_line()}", flush=True)
    return {"launches": {}}


def drive_zoo(name: str, cfg, *, workers: int, seq_len: int, batch: int,
              optimizer, buckets: tuple, ratio: float, params: int,
              steps: int = 3) -> dict:
    """Train ``cfg`` under bucketed gbin_packed on the fused kernels:
    ``buckets`` = (all, low-bit, float32 low-bit) in the layout, the
    low-bit ones each a sign_pack, vote_combine and unpack_ternary launch
    a step, the decode into each bucket's dtype (bfloat16 or float32, a
    count a step for each, from the layout), the reference's traffic ratio
    and parameter count, and one step's aggregates byte-equal to the
    plain twins."""
    from repro_torch.core import codec_name
    from repro_torch.fabric import Fabric, plan_presets

    plan = plan_presets()["gbin_packed"]
    fabric = Fabric(num_workers=workers)
    lowbit, lowbit_f32 = buckets[1], buckets[2]
    decodes = {torch.float32: lowbit_f32,
               torch.bfloat16: lowbit - lowbit_f32}
    run = drive(name, fabric, plan, steps,
                dict.fromkeys(("sign_pack", "vote_combine", "unpack_ternary"),
                              lowbit),
                batch=batch, cfg=cfg, seq_len=seq_len, optimizer=optimizer,
                buckets=buckets, decodes=decodes)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if (run["launches"]["unpack_ternary_bf16"],
            run["launches"]["unpack_ternary"]) != (
            steps * decodes[torch.bfloat16], steps * decodes[torch.float32]):
        fail(f"{name}: decodes by dtype {run['launches']}, expected "
             f"{steps} x {decodes}")
    if abs(run["traffic_ratio"] - ratio) > 1e-12:
        fail(f"{name}: traffic ratio {run['traffic_ratio']!r}, the "
             f"reference's {ratio!r}")
    n = sum(t.numel() for t in run["trainer"].state.model.parameters())
    if n != params:
        fail(f"{name}: {n} parameters, expected {params}")
    layout = fabric.layout_for(run["params"], plan)
    for b in layout.buckets:
        print(f"[{name}] bucket {codec_name(b.key.mode)} {b.key.schedule} "
              f"{b.key.dtype} {b.size} elements: "
              f"{', '.join(s.name for s in b.slots)}", flush=True)
    print(f"[{name}] launches a step: sign_pack, vote_combine, "
          f"unpack_ternary {lowbit} each; unpack_ternary into float32 "
          f"{lowbit_f32}, into bfloat16 {lowbit - lowbit_f32}", flush=True)
    extra = check_twin_step(name, fabric, plan, run)
    extra += (f", {n} parameters, peak with the twin check "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    report(name, run, extra)
    return run


def run_gemma_4k(steps: int = 3) -> dict:
    """Run L: gemma3-27b at full width cut to 6 layers (one 5:1 period:
    five local layers, window 1024, and a global one), W = 2 workers of
    one 4096-token sequence each, gbin_packed, SgdMomentum."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.optim import SgdMomentum

    cfg = dataclasses.replace(get_config("gemma3_27b"), num_layers=6)
    return drive_zoo("L gemma3-27b", cfg, workers=2, seq_len=4096, batch=2,
                     optimizer=SgdMomentum(peak_lr=1e-3, warmup_steps=2,
                                           total_steps=steps),
                     buckets=(9, 7, 0), ratio=0.3825361348161055,
                     params=3_886_618_368, steps=steps)


def run_deepseek_moe(steps: int = 3) -> dict:
    """Run M: deepseek-moe-16b at full width cut to 3 layers (the dense
    first layer and 2 MoE layers of 64 routed experts, top-6, and 2
    shared), W = 4 workers, 16 x 512 tokens a step (two 1024-token
    dispatch groups a worker), gbin_packed, AdamW."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config("deepseek_moe_16b"), num_layers=3)
    return drive_zoo("M deepseek-moe-16b", cfg, workers=4, seq_len=512,
                     batch=16,
                     optimizer=AdamW(peak_lr=3e-4, warmup_steps=2,
                                     total_steps=steps),
                     buckets=(15, 12, 0), ratio=0.27310381290117447,
                     params=1_681_143_808, steps=steps)


#: tokens a sequence in run N: 256 runs the scans chunked (16 x 16); at
#: 1024 a step took 64-82 s on the H100, a Python loop's launches
N_TOKENS = 256


def run_xlstm(steps: int = 2) -> dict:
    """Run N: xlstm-125m at full width and depth (9 mLSTM and 3 sLSTM
    blocks), W = 2 workers, 8 x ``N_TOKENS`` tokens a step (the chunked
    scans), gbin_packed, AdamW: 8 packed buckets, one of them float32
    (w_if, r)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW

    return drive_zoo("N xlstm-125m", get_config("xlstm_125m"), workers=2,
                     seq_len=N_TOKENS, batch=8,
                     optimizer=AdamW(peak_lr=3e-4, warmup_steps=2,
                                     total_steps=steps),
                     buckets=(11, 8, 1), ratio=0.4391217050767943,
                     params=183_565_128, steps=steps)


def run_hymba(steps: int = 2) -> dict:
    """Run O: hymba-1.5b at full width cut to 5 layers (0, 2 and 4 global,
    1 and 3 in the 1024-token window), W = 2, 4 x 2048 tokens, gbin_packed,
    AdamW: 9 packed buckets, two of them float32 (w_dt; w_bc and a_log)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config("hymba_1p5b"), num_layers=5)
    return drive_zoo("O hymba-1.5b", cfg, workers=2, seq_len=2048, batch=4,
                     optimizer=AdamW(peak_lr=3e-4, warmup_steps=2,
                                     total_steps=steps),
                     buckets=(12, 9, 2), ratio=0.3576435484125606,
                     params=304_036_800, steps=steps)


def run_whisper(steps: int = 3) -> dict:
    """Run P: whisper-tiny at full width and depth (4 encoder and 4
    decoder layers), W = 4, 16 x 448 decoder tokens and 16 x 1500 x 384
    seeded frames a step, gbin_packed, AdamW: one packed bucket."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamW

    return drive_zoo("P whisper-tiny", get_config("whisper_tiny"),
                     workers=4, seq_len=448, batch=16,
                     optimizer=AdamW(peak_lr=3e-4, warmup_steps=2,
                                     total_steps=steps),
                     buckets=(4, 1, 0), ratio=0.5627112239971452,
                     params=36_586_752, steps=steps)


# ---------------------------------------------------------------------------
# data parallelism across processes: NCCL at world size 1, gloo on the card
# ---------------------------------------------------------------------------

def same_numbers(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Byte equality, except that a zero equals a zero of either sign: a
    virtual sum of ranks starts from +0.0, NCCL's and gloo's keep the
    sign of a zero sum."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    zero = (a == 0) & (b == 0)
    return same(a.masked_fill(zero, 0.0), b.masked_fill(zero, 0.0))


def nccl_group():
    """One NCCL rank in this process (a ``file://`` store under build/)."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core import DistributedGroup

    store = os.path.join(ROOT, "build", "nccl_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    group = DistributedGroup(device="cuda:0")
    print(f"[I nccl] {group!r}, initialised in "
          f"{time.perf_counter() - t0:.4f} s", flush=True)
    return group


def timed_group():
    """A DistributedGroup whose collectives synchronise the card before
    and after, and add their host time to ``seconds`` by op."""
    from repro_torch.core import DistributedGroup

    class TimedGroup(DistributedGroup):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.seconds: dict = {}

        def _timed(self, op, fn, x):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x)
            torch.cuda.synchronize()
            self.seconds[op] = self.seconds.get(op, 0.0) + \
                time.perf_counter() - t0
            return out

        def psum(self, x):
            return self._timed("all_reduce", super().psum, x)

        def all_to_all(self, x):
            return self._timed("all_to_all", super().all_to_all, x)

        def all_gather(self, x):
            return self._timed("all_gather", super().all_gather, x)

    return TimedGroup(device="cuda:0")


def run_nccl(group, steps: int = 5) -> dict:
    """Run I: full qwen3-0.6B on ``Fabric(group=DistributedGroup)`` over
    NCCL at world size 1, gbin_packed, one worker's share of the main
    cell (4 x 128 tokens); then one set of this rank's gradients through
    it and through ``Fabric(num_workers=1)`` under seven plans, equal
    byte for byte (zeros of either sign as zeros)."""
    from repro_torch.core import AdmissionPlan, AggregationMode, Schedule
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric, plan_presets

    plan = plan_presets()["gbin_packed"]
    fabric = Fabric(group=group)
    traffic = []

    def count(k, before, after):
        traffic.append((dict(group.calls_by_op), dict(group.bytes_by_op)))
        group.reset_counts()

    group.reset_counts()
    run = drive("I nccl", fabric, plan, steps,
                dict.fromkeys(("sign_pack", "vote_combine", "unpack_ternary"),
                              LOWBIT_BUCKETS), on_step=count, batch=4)
    if (run["launches"]["unpack_ternary_bf16"] != steps * LOWBIT_BUCKETS
            or run["launches"]["unpack_ternary"]):
        fail(f"I: the bf16 buckets' decodes were not all bf16 launches: "
             f"{run['launches']}")
    calls, nbytes = traffic[-1]
    # a step: one all_to_all and two all_gathers a packed bucket, one
    # all_reduce a FP32 bucket (embedding, norms) and one of the loss
    means = sum(key.schedule == "psum" for key, _ in
                fabric.layout_for(run["params"], plan).launches())
    want = {"all_to_all": LOWBIT_BUCKETS, "all_gather": 2 * LOWBIT_BUCKETS,
            "all_reduce": means + 1}
    if calls != want:
        fail(f"I: a step's collectives {calls}, expected {want}")
    print(f"[I nccl] a step's collectives (step {steps - 1}): calls {calls}, "
          f"bytes {nbytes}", flush=True)
    # layout_kernel_stats keeps the reference's model, which takes a
    # world of one for the host-local session (one vote_pipeline a
    # bucket); the group runs the three-kernel chain, counted above
    print(f"[I nccl] launches a step: {3 * LOWBIT_BUCKETS} counted (sign_pack, "
          f"vote_combine, unpack_ternary a bucket); the layout model's "
          f"{LOWBIT_BUCKETS} is the reference's world-of-one count",
          flush=True)
    trainer = run["trainer"]
    loss = trainer.state.model.loss

    # the host time of a step's collectives, each synchronised
    tg = timed_group()
    timed = Fabric(group=tg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, _ = timed.worker_grads(run["params"], run["batch"], loss)
    agg, _ = timed.aggregate(grads, plan)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    print(f"[I nccl] a step's collectives, synchronised: "
          f"{ {k: round(v, 6) for k, v in tg.seconds.items()} } s "
          f"({sum(tg.seconds.values()):.6f} s of the {total:.4f} s of "
          f"worker grads and aggregate; calls {tg.calls_by_op})", flush=True)
    del agg

    like = T.map_leaves(lambda g: g[0], grads)
    presets = plan_presets()
    cases = (
        ("gbin_packed", plan, {}),
        ("packed G-Ternary", AdmissionPlan.lowbit_backbone(
            AggregationMode.G_TERNARY, schedule=Schedule.PACKED_A2A), {}),
        ("gbin_packed EF, per leaf",
         plan_presets(error_feedback=True)["gbin_packed"], {"fused": False}),
        ("staged", plan, {"fused_kernels": False}),
        ("int4_backbone", presets["int4_backbone"], {}),
        ("topk_backbone", presets["topk_backbone"], {}),
        ("fp32", AdmissionPlan.fp32_all(), {}))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, p, kw in cases:
        a, b = Fabric(group=group, **kw), Fabric(num_workers=1, **kw)
        ef = None
        if not kw.get("fused", True):
            ef = a.init_ef(like, a.resolve(like, p))
            for e in T.leaves(ef):
                if e.dim():
                    e.copy_(1e-3 * torch.randn(e.shape, device="cuda",
                                               generator=gen))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, got_ef = a.aggregate(grads, p, ef=ef)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        want, want_ef = b.aggregate(grads, p, ef=ef)
        pairs = list(zip(T.flatten(got), T.leaves(want)))
        if ef is not None:
            pairs += [(("ef/" + q, x), y) for (q, x), y in
                      zip(T.flatten(got_ef), T.leaves(want_ef)) if x.dim()]
        signed = 0
        for (q, x), y in pairs:
            if not same_numbers(x, y):
                fail(f"I {label}: {q} differs from Fabric(num_workers=1)")
            signed += int(((x == 0) & (torch.signbit(x)
                                      != torch.signbit(y))).sum())
        print(f"[I nccl] {label}: aggregate {dt:.4f} s, equal to "
              f"Fabric(num_workers=1) on {len(pairs)} leaves "
              f"({signed} zeros of the other sign)", flush=True)
        del got, got_ef, want, want_ef, ef
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    report("I nccl", run)
    return run


def run_restore_replay(group, steps: int = 8, fail_at: int = 6) -> dict:
    """Run J: qwen3-0.6B at full width and 2 layers over NCCL at world
    size 1, gbin_packed under the paper controller, checkpoints every 4
    steps: once as it is and once with a failure at step 6, restored
    and replayed to the same bits."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import (CheckpointManager, load_train_state,
                                        restore_latest, train_state_arrays)
    from repro_torch.configs import get_config
    from repro_torch.core import Commander, Schedule
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, make_controller
    from repro_torch.optim import AdamW
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("qwen3_0p6b"), num_layers=2)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=4,
                             seed=0, learnable=False)
    root = os.path.join(ROOT, "build", "ckpt_run_j")
    shutil.rmtree(root, ignore_errors=True)

    def one(failing: bool):
        ctl = make_controller("paper", warmup_steps=2,
                              commander=Commander(
                                  schedule=Schedule.PACKED_A2A))
        tr = Trainer(cfg, AdamW(peak_lr=3e-4, warmup_steps=2,
                                total_steps=steps), data, controller=ctl,
                     fabric=Fabric(group=group), seed=0, device="cuda",
                     ckpt_dir=os.path.join(root, str(int(failing))),
                     tcfg=TrainerConfig(checkpoint_interval=4,
                                        checkpoint_keep=1),
                     failure_injector=FailureInjector(at_steps=[fail_at])
                     if failing else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(steps)
        torch.cuda.synchronize()
        return tr, time.perf_counter() - t0

    try:
        a, ta = one(False)
        b, tb = one(True)
        la, lb = [h["loss"] for h in a.history], [h["loss"] for h in b.history]
        print(f"[J replay] unbroken: {ta:.2f} s, losses {la}", flush=True)
        print(f"[J replay] failure at step {fail_at}: {tb:.2f} s, losses "
              f"{lb}", flush=True)
        if (a.restarts, b.restarts) != (0, 1):
            fail(f"J: restarts {a.restarts}, {b.restarts}; expected 0, 1")
        if la[-1] != lb[-1] or not all(np.isfinite(la)):
            fail(f"J: last losses {la[-1]} and {lb[-1]} differ")
        for (p, x), y in zip(T.flatten(a.state.model.tree()),
                             T.leaves(b.state.model.tree())):
            if not same(x.detach(), y.detach()):
                fail(f"J: parameter {p} differs after the replay")
        events = [[(e.step, e.kind, e.plan_signature)
                   for e in tr.controller.events] for tr in (a, b)]
        plans = [tr.controller.plan.signature() for tr in (a, b)]
        if events[0] != events[1] or plans[0] != plans[1]:
            fail(f"J: controllers part: {events}, {plans}")
        print(f"[J replay] equal: the last loss, every parameter, the plan "
              f"{plans[0]} and the events {events[0]}", flush=True)

        # the save (snapshot, then the write) and the restore, timed
        mgr = CheckpointManager(os.path.join(root, "timed"), interval=1,
                                keep=1, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.maybe_save(steps, lambda: train_state_arrays(b.state, group))
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        path = os.path.join(root, "timed", f"step_{steps:010d}")
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        t3 = time.perf_counter()
        _, arrays, _ = restore_latest(os.path.join(root, "timed"))
        t4 = time.perf_counter()
        load_train_state(b.state, arrays, group)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        print(f"[J replay] checkpoint {size} bytes: snapshot to host "
              f"{t1 - t0:.4f} s, write {t2 - t1:.4f} s; restore: read "
              f"{t4 - t3:.4f} s, copy into the state {t5 - t4:.4f} s",
              flush=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[J replay] peak memory {peak:.2f} GiB", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": {}}


K_STEPS = 2


def k_trainer(group, device):
    """Run K's trainer: the bf16 smoke model, gbin_packed, W = 2."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    cfg = dataclasses.replace(get_config("qwen3_0p6b", smoke=True),
                              dtype="bfloat16")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=16, batch=8,
                             seed=0)
    fabric = Fabric(group=group) if group is not None else \
        Fabric(num_workers=2)
    return Trainer(cfg, AdamW(peak_lr=1e-3, warmup_steps=1, total_steps=10),
                   data, plan=plan_presets()["gbin_packed"], fabric=fabric,
                   seed=0, device=device)


def spawn_ranks(flag: str, world: int, timeout: int = 900,
                extra=None) -> tuple:
    """``chip_smoke.py <flag> r dir`` for r < world: each rank's
    ``rank{r}.pt``, ``extra(dir)`` (what else the ranks wrote) and the
    spawn's seconds."""
    import shutil
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   flag, str(r), out])
                 for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            fail(f"{flag}: rank exit codes {[p.returncode for p in procs]}")
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
                 for r in range(world)]
        return ranks, extra(out) if extra else None, spawn_s
    finally:
        shutil.rmtree(out, ignore_errors=True)


def run_k_rank(rank: int, out: str) -> None:
    """One rank of run K: gloo over CUDA tensors on cuda:0."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core import DistributedGroup
    from repro_torch.core import tree as T
    from repro_torch.kernels import kernel_wrappers

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=60))
    group = DistributedGroup(device="cuda:0")
    trainer = k_trainer(group, "cuda:0")
    for fn in kernel_wrappers().values():
        fn.launches = 0
    aggs = []
    for k in range(K_STEPS):
        trainer.run(k + 1)
        aggs.append({p: u.cpu() for p, u in
                     T.flatten(trainer.last_aggregates)})
    torch.save({"aggs": aggs,
                "losses": [h["loss"] for h in trainer.history],
                "params": {p: x.detach().cpu() for p, x in
                           T.flatten(trainer.state.model.tree())},
                "launches": {n: fn.launches
                             for n, fn in kernel_wrappers().items()},
                "calls": dict(group.calls_by_op)},
               os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_gloo_on_card() -> dict:
    """Run K: two ranks spawned on cuda:0 over gloo (torch 2.11's gloo
    takes CUDA tensors in all_reduce, all_to_all_single and
    all_gather_into_tensor), 2 steps of gbin_packed on the bf16 smoke
    model: every step's aggregates, the losses and the parameters equal
    to Fabric(num_workers=2)'s, zeros of either sign as zeros."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import kernel_wrappers

    ranks, _, spawn_s = spawn_ranks("--run-k-rank", 2, timeout=300)
    trainer = k_trainer(None, "cuda")
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    for k in range(K_STEPS):
        trainer.run(k + 1)
        for p, u in T.flatten(trainer.last_aggregates):
            for r, got in enumerate(ranks):
                if not same_numbers(got["aggs"][k][p], u.cpu()):
                    fail(f"K step {k}: rank {r}'s aggregate {p} differs "
                         f"from Fabric(num_workers=2)'s")
    virtual = {n: fn.launches for n, fn in wrappers.items()}
    for r, got in enumerate(ranks):
        if got["losses"] != [h["loss"] for h in trainer.history]:
            fail(f"K: rank {r}'s losses {got['losses']}")
        for p, x in T.flatten(trainer.state.model.tree()):
            if not same_numbers(got["params"][p], x.detach().cpu()):
                fail(f"K: rank {r}'s parameter {p} differs")
        if got["launches"] != virtual or not virtual["vote_combine"]:
            fail(f"K: rank {r} launched {got['launches']}, the virtual run "
                 f"{virtual}")
    print(f"[K gloo on the card] 2 ranks on cuda:0, {K_STEPS} steps: "
          f"aggregates, losses {ranks[0]['losses']} and parameters equal to "
          f"Fabric(num_workers=2)'s; each rank launched "
          f"{ {n: v for n, v in virtual.items() if v} } and called "
          f"{ranks[0]['calls']}; {spawn_s:.2f} s for the two ranks",
          flush=True)
    return {"launches": {}}


# ---------------------------------------------------------------------------
# phase 8: tensor parallelism and ZeRO-1 (run Q)
# ---------------------------------------------------------------------------

Q_MESH = (2, 2)             # (data, model)
Q_STEPS = 2
Q_SHARD = 4                 # sequences of 128 tokens a data rank
#: the step-0 gradients' tolerance, in bf16 noise: per leaf, the tensor-
#: parallel gradient's distance from the unsharded model's gradient in
#: float32 (relative L2 norm) may be at most Q_GRAD_NOISE times the
#: unsharded bf16 gradient's own distance from it, plus 2^-8 (the
#: row-parallel and vocab-parallel sums add in another order, in bf16)
Q_GRAD_NOISE = 2.0
Q_LOSS_RTOL = 1e-3


def q_config():
    """Run Q's model: the full qwen3-0.6B (28 layers, d 1024, vocab
    151,936, bf16, remat)."""
    from repro_torch.configs import get_config
    return get_config("qwen3_0p6b")


def q_data(cfg):
    from repro_torch.data import SyntheticLMStream
    return SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128,
                             batch=Q_MESH[0] * Q_SHARD, seed=0,
                             learnable=False)


def _q_same_across(group, x: torch.Tensor) -> bool:
    """Is ``x`` bit-equal on every rank of ``group`` (against the group's
    rank 0, broadcast)?"""
    ref = x.detach().clone()
    group.broadcast(ref, src=0)
    flag = torch.tensor([int(same(ref, x.detach()))], device=x.device)
    return int(group.all_reduce(flag).item()) == group.size


def run_q_rank(rank: int, out: str) -> None:
    """One rank of run Q: full qwen3-0.6B on a (data 2) x (model 2) mesh,
    four gloo ranks on cuda:0, gbin_packed, AdamW with ZeRO-1."""
    import dataclasses
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core import ProcessMesh, codec_name
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=Q_MESH[0] * Q_MESH[1],
                            timeout=timedelta(seconds=120))
    mesh = ProcessMesh(Q_MESH, device="cuda:0")
    cfg = q_config()
    data = q_data(cfg)
    plan = plan_presets()["gbin_packed"]
    fabric = Fabric(mesh=mesh)
    trainer = Trainer(cfg, AdamW(peak_lr=3e-4, warmup_steps=2,
                                 total_steps=Q_STEPS), data, plan=plan,
                      fabric=fabric, seed=0, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.init_state()
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0, "coords": mesh.coords}
    model = trainer.state.model
    params = model.tree()
    layout = fabric.layout_for(params, plan, trainer.pspecs)
    packed = [(key, n) for key, n in layout.launches()
              if codec_name(key.mode) != "fp32"]
    if any(key.schedule != "packed_a2a" for key, _ in packed):
        fail(f"Q: low-bit launches off the packed schedule: {packed}")
    specs = dict(T.flatten(trainer.pspecs))
    res["unfused"] = [u.name for u in layout.unfused]
    res["buckets"] = [[s.name for s in b.slots] for b in layout.buckets]
    # the low-bit launches' leaves: a bucket's, or one per-leaf leaf
    lowbit = [[s.name for s in b.slots] for b in layout.buckets
              if codec_name(b.key.mode) != "fp32"] + \
        [[u.name] for u in layout.unfused if codec_name(u.key.mode) != "fp32"]
    st = trainer.state.opt
    res["moment_bytes"] = sum(m.numel() * 4 for m in
                              T.leaves(st.mu) + T.leaves(st.nu))
    res["whole_moment_bytes"] = sum(2 * 4 * p.numel()
                                    for p in T.leaves(params))
    res["params_local"] = sum(p.numel() for p in T.leaves(params))

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    decode_by = wrappers["unpack_ternary"].launches_by_dtype
    res.update(loss=[], step_s=[], launches=[], calls=[], replicas=[])
    for k in range(Q_STEPS):
        batch = {n: torch.as_tensor(v).cuda()
                 for n, v in data.batch_at(k).items()}
        if k == 0:
            # this step's gradients, recomputed, for the twins and the
            # parent's unsharded model
            grads, _ = fabric.worker_grads(params, batch, model.loss)
            if mesh.data_index == 0:
                torch.save({p: g[0].cpu() for p, g in T.flatten(grads)},
                           os.path.join(out, f"grads{rank}.pt"))
            names = {n for group in lowbit for n in group}
            peers = {p: mesh.data_group.all_gather(g[None])
                     for p, g in T.flatten(grads) if p in names}
            del grads
        before = {n: fn.launches for n, fn in wrappers.items()}
        dtype_before = dict(decode_by)
        mesh.reset_counts()
        trainer.run(k + 1)
        rec = trainer.history[-1]
        delta = {n: fn.launches - before[n] for n, fn in wrappers.items()}
        split = {str(dt): n - dtype_before[dt] for dt, n in decode_by.items()}
        want = {n: len(packed) if n in ("sign_pack", "vote_combine",
                                        "unpack_ternary") else 0
                for n in wrappers}
        if delta != want or split["torch.bfloat16"] != len(packed):
            fail(f"Q rank {rank} step {k}: launches {delta} ({split} by "
                 f"decode dtype), the layout models {want}, all bf16")
        if not np.isfinite(rec["loss"]):
            fail(f"Q rank {rank} step {k}: loss {rec['loss']}")
        res["loss"].append(rec["loss"])
        res["step_s"].append(rec["step_time_s"])
        res["traffic_ratio"] = rec["traffic_ratio"]
        res["launches"].append({n: d for n, d in delta.items() if d})
        res["calls"].append({
            name: (dict(g.calls_by_op), dict(g.bytes_by_op))
            for name, g in (("data", mesh.data_group),
                            ("model", mesh.model_group),
                            ("world", mesh.world))})
        agg = dict(T.flatten(trainer.last_aggregates))
        if k == 0:
            for names in lowbit:
                flat = torch.cat([peers[n].reshape(Q_MESH[0], -1)
                                  for n in names], dim=1)
                got = torch.cat([agg[n].reshape(-1) for n in names])
                for c in range(0, got.numel(), TWIN_CHUNK):
                    if not same(got[c:c + TWIN_CHUNK],
                                twin_vote(flat[:, c:c + TWIN_CHUNK])):
                        fail(f"Q rank {rank}: aggregate {names} differs "
                             f"from the per-shard twins")
            res["twin_checked"] = len(peers)
            del peers, flat, got
        del agg
        # replicas: a replicated leaf on all four ranks, a block on both
        # data ranks that hold it
        bad = []
        for p, x in T.flatten(model.tree()):
            sharded = any(e is not None for e in specs[p])
            group = mesh.data_group if sharded else mesh.world
            if not _q_same_across(group, x):
                bad.append(p)
        if bad:
            fail(f"Q rank {rank} step {k}: replicas differ on {bad}")
        res["replicas"].append(True)

    # "dots" against "full": the same gradients, fewer all-reduces
    batch = {n: torch.as_tensor(v).cuda()[mesh.data_index * Q_SHARD:
                                          (mesh.data_index + 1) * Q_SHARD]
             for n, v in data.batch_at(Q_STEPS).items()}
    leaves = T.leaves(params)
    got = {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        mesh.model_group.reset_counts()
        g = torch.autograd.grad(loss_fn(params, c, batch, trainer.tp),
                                leaves)
        got[policy] = (g, mesh.model_group.calls_by_op["all_reduce"])
    res["remat_all_reduce"] = {p: n for p, (_, n) in got.items()}
    res["dots_equal"] = all(same(a, b) for a, b in
                            zip(got["full"][0], got["dots"][0]))
    del got
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["kernel_launches"] = {n: fn.launches for n, fn in wrappers.items()}
    res["kernel_launches_bf16"] = decode_by[torch.bfloat16]
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


@contextlib.contextmanager
def record_routing():
    """The MoE layers' top-k expert indices (``topi``) of the forwards run
    inside, in call order (a recompute in the backward appends again).
    They stay on the device until the block ends, then move to the host
    in one pass: no host sync inside a timed step."""
    import repro_torch.models.layers as L
    picks, real = [], L._top_k

    def recording(x, k):
        v, i = real(x, k)
        picks.append(i.detach())
        return v, i
    L._top_k = recording
    try:
        yield picks
    finally:
        L._top_k = real
        picks[:] = [t.cpu() for t in picks]


def unsharded_yardstick(name: str, cfg, batch: dict, grads: dict, mesh_shape,
                        shard: int, routing: list | None = None) -> tuple:
    """The unsharded model (seed 0, as the ranks') on the same parameters:
    its mean loss over the data ranks' shards of ``batch``, and each
    step-0 gradient block of data rank 0's model ranks (``grads[m]``,
    path -> block) against it on that rank's shard: the relative L2
    distance from the float32 gradient, tensor-parallel and unsharded
    bf16; fails where the first is beyond Q_GRAD_NOISE x the second plus
    2^-8.  ``routing`` collects the bf16 forward's expert choices.
    Returns (mean loss, {path: distances}, the worst leaf, the model)."""
    import dataclasses

    from repro_torch.core import tree as T
    from repro_torch.models import Transformer, loss_fn
    from repro_torch.models.transformer import param_pspecs
    from repro_torch.runtime.shardings import sanitize_pspecs, shard_of

    model = Transformer(cfg, device="cuda", seed=0)
    params = model.tree()
    full_batch = {n: torch.as_tensor(v).cuda() for n, v in batch.items()}
    shards = [{n: v[d * shard:(d + 1) * shard]
               for n, v in full_batch.items()} for d in range(mesh_shape[0])]
    with torch.no_grad():
        mean = sum(float(loss_fn(params, cfg, b)) for b in shards) / \
            mesh_shape[0]
    leaves = T.leaves(params)
    with record_routing() as picks:
        loss = loss_fn(params, cfg, shards[0])
    if routing is not None:
        routing.extend(picks)
    whole = torch.autograd.grad(loss, leaves)
    del loss
    # the same model in float32: the yardstick of the bf16 noise
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.map_leaves(
        lambda x: x.detach().to(torch.float32).requires_grad_(), params)
    whole32 = torch.autograd.grad(loss_fn(params32, cfg32, shards[0]),
                                  T.leaves(params32))
    del params32
    extents = {"data": mesh_shape[0], "model": mesh_shape[1]}
    specs = T.leaves(sanitize_pspecs(param_pspecs(cfg), params, extents))

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    errs = {}                   # leaf -> (tensor-parallel, unsharded bf16)
    for r, blocks in grads.items():
        coords = {"data": 0, "model": r}
        for (p, _), g, g32, spec in zip(T.flatten(params), whole, whole32,
                                        specs):
            want = shard_of(g32, spec, extents, coords)
            e = (rel(blocks[p].cuda().to(torch.float32), want),
                 rel(shard_of(g, spec, extents, coords).to(torch.float32),
                     want))
            errs[p] = max(errs.get(p, e), e)
    del whole, whole32, leaves
    free()
    bad = {p: e for p, e in errs.items()
           if e[0] > Q_GRAD_NOISE * e[1] + 2 ** -8}
    if bad:
        fail(f"{name}: step-0 gradient blocks (relative L2 distance from "
             f"the float32 gradient, tensor-parallel and unsharded bf16) "
             f"beyond {Q_GRAD_NOISE}x the bf16 noise: {bad}")
    worst = max(errs, key=lambda p: errs[p][0] / max(errs[p][1], 1e-30))
    return mean, errs, worst, model


def run_tp_on_card() -> dict:
    """Run Q: the full qwen3-0.6B on a (data 2) x (model 2) process mesh,
    four gloo ranks spawned on cuda:0 (the machine has one card), 2 steps
    of gbin_packed with AdamW and ZeRO-1; then the step-0 gradients and
    loss of data rank 0's ranks against the unsharded model on the same
    parameters and batch, in this process."""
    world = Q_MESH[0] * Q_MESH[1]
    ranks, grads, spawn_s = spawn_ranks(
        "--run-q-rank", world,
        extra=lambda out: {r: torch.load(os.path.join(out, f"grads{r}.pt"))
                           for r in range(Q_MESH[1])})
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        if res["loss"] != r0["loss"]:
            fail(f"Q: rank {r}'s losses {res['loss']}, rank 0's "
                 f"{r0['loss']}")
        if res["traffic_ratio"] != 0.2842221000549753:
            fail(f"Q: rank {r}'s traffic ratio {res['traffic_ratio']}")
        if not res["dots_equal"]:
            fail(f"Q: rank {r}'s 'dots' gradients differ from 'full'")
        n = res["remat_all_reduce"]
        if n["full"] - n["dots"] != q_config().num_layers:
            fail(f"Q: rank {r}'s model-group all-reduces {n}: 'dots' "
                 f"should run one fewer a layer")
        if 2 * res["moment_bytes"] != res["whole_moment_bytes"]:
            fail(f"Q: rank {r}'s ZeRO-1 moments {res['moment_bytes']} B, "
                 f"not half of {res['whole_moment_bytes']} B")
    cfg = q_config()
    mean, errs, worst, model = unsharded_yardstick(
        "Q", cfg, q_data(cfg).batch_at(0), grads, Q_MESH, Q_SHARD)
    del model, grads
    loss_err = abs(r0["loss"][0] - mean) / abs(mean)
    if loss_err > Q_LOSS_RTOL:
        fail(f"Q: step-0 loss {r0['loss'][0]} against the unsharded "
             f"{mean} (relative {loss_err})")
    print(f"[Q tp] {world} gloo ranks on cuda:0 as a (data, model) = "
          f"{Q_MESH} mesh, {cfg.name} ({cfg.num_layers} layers, "
          f"{r0['params_local']} parameters a rank), gbin_packed, AdamW "
          f"with ZeRO-1, {Q_MESH[0]} x {Q_SHARD} x 128 tokens", flush=True)
    print(f"[Q tp] per-leaf (tensor-parallel) low-bit leaves "
          f"{r0['unfused']}; buckets {r0['buckets']}", flush=True)
    print(f"[Q tp] losses {r0['loss']} (the unsharded model's step-0 "
          f"loss {mean:.6f}, relative {loss_err:.3e}); traffic ratio "
          f"{r0['traffic_ratio']}", flush=True)
    print(f"[Q tp] step seconds by rank "
          f"{[res['step_s'] for res in ranks]}; init seconds "
          f"{[round(res['init_s'], 2) for res in ranks]}; spawn "
          f"{spawn_s:.2f} s", flush=True)
    print(f"[Q tp] peak memory by rank (GiB) "
          f"{[round(res['peak_gib'], 2) for res in ranks]}", flush=True)
    print(f"[Q tp] optimizer state a rank: {r0['moment_bytes']} B with "
          f"ZeRO-1, {r0['whole_moment_bytes']} B without", flush=True)
    print(f"[Q tp] launches a step by kernel (rank 0) {r0['launches']}, "
          f"every decode bf16", flush=True)
    for k, calls in enumerate(r0["calls"]):
        print(f"[Q tp] step {k} collectives of rank 0 (calls, bytes) by "
              f"group: {calls}", flush=True)
    print(f"[Q tp] step 0's aggregates byte-equal to the per-shard twins "
          f"on {r0['twin_checked']} low-bit leaves a rank; replicated "
          f"leaves bit-equal on all ranks and blocks on both data ranks "
          f"after every step; step-0 gradient blocks within "
          f"{Q_GRAD_NOISE}x the bf16 noise (relative L2 distance from the "
          f"float32 gradient, tensor-parallel against unsharded bf16: "
          f"{ {p: (round(a, 5), round(b, 5)) for p, (a, b) in errs.items()} }"
          f"; the largest ratio {worst}); "
          f"'dots' gradients bit-equal to 'full' with model-group "
          f"all-reduces {r0['remat_all_reduce']}", flush=True)
    launches = dict(r0["kernel_launches"])
    launches["unpack_ternary_bf16"] = r0["kernel_launches_bf16"]
    launches["unpack_ternary"] -= r0["kernel_launches_bf16"]
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 9: hop plans and the simulator
# ---------------------------------------------------------------------------

R_SHAPE = (2, 8)            # (outer, inner) virtual workers: W = 16
R_STEPS = 3
#: the reference's traffic ratio of qwen3-0.6B under hier_fp32_gbinary
#: (tests/test_torch_hierarchical.py computes it with the reference)
R_TRAFFIC_RATIO = 0.2842221000549753
R_LOWBIT = 7                # low-bit buckets (= backbone leaves)


def twin_hier(g: torch.Tensor) -> torch.Tensor:
    """The plain twin of hier_fp32_gbinary on one (W, N) leaf:
    sign(sum_outer(vote(mean_inner(g)))), the inner means through the same
    group sums as hop 0 (whole rows of the leaf, as its bucket holds
    them), the votes summed in int32."""
    from repro_torch.core import VirtualGroup
    outer, inner = R_SHAPE
    inner_group = VirtualGroup(inner)
    margin = None
    for o in range(outer):
        m = inner_group.all_reduce_mean(
            g[o * inner:(o + 1) * inner].to(torch.float32))
        v = torch.where(m > 0, 1, -1).to(torch.int32)
        margin = v if margin is None else margin + v
        del m
    return torch.sign(margin.to(torch.float32))


def run_hier() -> dict:
    """Run R: full qwen3-0.6B under hier_fp32_gbinary on W = 16 virtual
    workers as (outer 2) x (inner 8): hop 0 the FP32 mean over each inner
    8, hop 1 the vote_psum G-Binary vote over the outer 2; 16 x 128
    tokens, AdamW, R_STEPS steps, each step's aggregates byte-equal to
    ``twin_hier`` on the step's own stacked gradients.  On step 0's
    gradients the same route with a packed_a2a backbone (a registered
    plan): byte-equal, with one sign_pack, vote_combine and float32
    unpack_ternary launch a bucket over the outer group (hop 0 hands
    float32 to hop 1, as the reference's fp32_allreduce does).  Then the
    per-hop wire bytes of the layout and the simulator on it (modeled,
    the reference's constants)."""
    from repro_torch import sim
    from repro_torch.core import (AdmissionPlan, VirtualGroup, codec_name,
                                  hop_wire_bytes_per_device,
                                  wire_bytes_per_device)
    from repro_torch.core import tree as T
    from repro_torch.fabric import (HopPlan, HopSpec, register_hop_plan,
                                    unregister_hop_plan)
    from repro_torch.fabric import session as S
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.kernels import kernel_wrappers

    plan = plan_presets()["hier_fp32_gbinary"]
    fabric = Fabric(group=VirtualGroup(R_SHAPE))
    stash: dict = {}
    real = S.aggregate_tree_bucketed

    def keep(ctx, grads, policies, ef_states=None, **kw):
        out = real(ctx, grads, policies, ef_states=ef_states, **kw)
        stash["grads"], stash["agg"] = grads, out[0]
        # the step's peak: its gradients and aggregation (the optimizer
        # after it allocates less); read before the stash holds the
        # gradients past the step
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return out

    wrappers = kernel_wrappers()
    packed_name = "r_hier_fp32_gbinary_packed"
    peaks: list = []            # GiB: a step's grads and aggregation
    twin_s: list = []
    packed: dict = {}

    def on_step(k, ef_before, ef_after):
        grads, agg = dict(T.flatten(stash.pop("grads"))), \
            dict(T.flatten(stash.pop("agg")))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for path in lowbit_paths:
            g = grads[path].reshape(grads[path].shape[0], -1)
            got = agg[path].reshape(-1)
            if got.dtype != torch.float32 or not same(got, twin_hier(g)):
                fail(f"R step {k}: aggregate {path} ({got.dtype}) differs "
                     f"from sign(sum_outer(sign(mean_inner(g))))")
        torch.cuda.synchronize()
        twin_s.append(time.perf_counter() - t0)
        if k == 0:
            # the packed backbone on the same step-0 gradients
            sub = T.unflatten([(p, grads[p]) for p in lowbit_paths])
            for fn in wrappers.values():
                fn.launches = 0
            by_before = dict(wrappers["unpack_ternary"].launches_by_dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            S.aggregate_tree_bucketed = real        # nothing to keep here
            try:
                got, _ = fabric.aggregate(sub, AdmissionPlan.lowbit_all(
                    packed_name))
            finally:
                S.aggregate_tree_bucketed = keep
            torch.cuda.synchronize()
            packed["seconds"] = time.perf_counter() - t1
            counts = {kn: fn.launches for kn, fn in wrappers.items()}
            split = {dt: n - by_before[dt] for dt, n in
                     wrappers["unpack_ternary"].launches_by_dtype.items()}
            want = {kn: R_LOWBIT if kn in ("sign_pack", "vote_combine",
                                           "unpack_ternary") else 0
                    for kn in wrappers}
            if counts != want or split[torch.float32] != R_LOWBIT:
                fail(f"R packed: launches {counts}, decodes by dtype "
                     f"{split}; expected {want}, all float32")
            for p, u in T.flatten(got):
                if not same(u, agg[p]):
                    fail(f"R packed: aggregate {p} differs from the "
                         f"vote_psum backbone's")
            packed["launches"] = {"sign_pack": R_LOWBIT,
                                  "vote_combine": R_LOWBIT,
                                  "unpack_ternary": R_LOWBIT}
            del got, sub
        del grads, agg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    like = init_params(get_config("qwen3_0p6b"), device="meta")
    lowbit_paths = [s.name for b in fabric.layout_for(like, plan).buckets
                    if codec_name(b.key.mode) != "fp32" for s in b.slots]
    register_hop_plan(HopPlan(packed_name, (
        HopSpec("fp32", workers=R_SHAPE[1]),
        HopSpec("gbinary", schedule="packed_a2a"))))
    S.aggregate_tree_bucketed = keep
    torch.cuda.reset_peak_memory_stats()
    try:
        run = drive("R hier", fabric, plan, R_STEPS, {}, batch=16,
                    buckets=(9, R_LOWBIT), on_step=on_step)
    finally:
        S.aggregate_tree_bucketed = real
        unregister_hop_plan(packed_name)
    run["peak_gib"] = max(peaks)
    launches = {k: v for k, v in run["launches"].items() if v}
    if launches != packed["launches"]:
        fail(f"R: launches {launches}; only the packed variant's expected")
    if run["traffic_ratio"] != R_TRAFFIC_RATIO:
        fail(f"R: traffic ratio {run['traffic_ratio']!r}, the reference's "
             f"{R_TRAFFIC_RATIO!r}")
    w = fabric.num_workers
    layout = fabric.layout_for(run["params"], plan)
    legs_total = [0.0, 0.0]
    for key, n in layout.launches():
        legs = hop_wire_bytes_per_device(n, key.mode, key.schedule, w)
        if sum(legs) != wire_bytes_per_device(n, key.mode, key.schedule, w):
            fail(f"R: hop legs {legs} of a {n}-element launch do not sum "
                 f"to its wire bytes")
        if len(legs) == 2:
            legs_total = [a + b for a, b in zip(legs_total, legs)]
    card = card_line()
    print(f"[R hier] {card}: W = {w} as (outer, inner) = {R_SHAPE}, "
          f"plan hier_fp32_gbinary, 16 x 128 tokens, AdamW; launches a "
          f"step 0 (the vote_psum backbone runs no kernel)", flush=True)
    print(f"[R hier] {card}: step seconds {run['step_s']} (the twin check "
          f"after each step, not in them, took {twin_s} s); peak memory "
          f"by step {[round(p, 2) for p in peaks]} GiB (through the "
          f"aggregation; the optimizer after it allocates less)",
          flush=True)
    print(f"[R hier] {card}: packed backbone on step 0's gradients: "
          f"{packed['seconds']:.4f} s, launches "
          f"{packed['launches']} (decodes float32), byte-equal to R's",
          flush=True)
    print(f"[R hier] per-hop wire bytes a device of the hierarchical "
          f"launches (modeled ring bytes): hop0 {legs_total[0]:.0f}, hop1 "
          f"{legs_total[1]:.0f}", flush=True)
    like = T.map_leaves(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), run["params"])
    for topology in ("ici_ring", "multihop"):
        rep = fabric.simulate(like, plan, topology=topology)
        util = rep.link_utilization
        if topology == "multihop" and not {"hop0", "hop1"} <= set(util):
            fail(f"R sim: multihop reports links {sorted(util)}")
        print(f"[R sim] modeled, the reference's constants ({topology}, "
              f"W = {w}): step {rep.step_time_s!r} s, comm "
              f"{rep.comm_time_s!r} s, exposed {rep.exposed_pct!r} %, "
              f"link utilisation {util}", flush=True)
    points = sim.paper_operating_points()
    full, bw = points["full_miss"], points["bandwidth_pressure"]
    if not 0.0 < full.exposed_pct <= sim.PAPER_EXPOSED_BOUND_PCT:
        fail(f"sim: full_miss exposed {full.exposed_pct}%, bound "
             f"{sim.PAPER_EXPOSED_BOUND_PCT}%")
    if bw.exposed_pct != 0.0 or not bw.hidden:
        fail(f"sim: bandwidth_pressure exposed {bw.exposed_pct}%")
    print(f"[R sim] the paper's operating points, modeled with the "
          f"reference's constants: full_miss exposed "
          f"{full.exposed_pct!r} % (bound {sim.PAPER_EXPOSED_BOUND_PCT} "
          f"%), bandwidth_pressure exposed {bw.exposed_pct!r} % (hidden "
          f"{bw.hidden})", flush=True)
    report("R hier", run, f", step aggregates byte-equal to the twin "
           f"every step")
    return run


# ---------------------------------------------------------------------------
# phase 10: the autotuner and the tuned controller (run S)
# ---------------------------------------------------------------------------

S_STEPS = 7
#: the autotuner's winner on full qwen3-0.6B at W = 4 on ici_ring (the
#: reference's, tests/test_torch_tune.py), and the plan the reference's
#: controller moves to first when every step lies out of its band
S_WINNER = ("backbone:gbinary:packed_a2a:0|embed:gbinary:packed_a2a:0|"
            "*:fp32:psum:0")
S_RETUNED = "backbone:int4:psum:0|embed:gbinary:vote_psum:0|*:fp32:psum:0"
S_PACKED = 8                # the winner's packed buckets: 7 and the embedding
S_INT4 = 7                  # int4 buckets after the retune
EMBED_N = 155_582_464       # the tied embedding: the largest bucket


def tuned_rule(tuned, times, patience: int = 5, tolerance: float = 0.25,
               alpha: float = 0.3) -> list:
    """The tuned controller's rule (``repro/tune/online.py``), written
    out: the ``(step, plan signature)`` retunes that step times ``times``
    give, from the artifact's winner and its sim-certified runners-up at
    the same bucket budget."""
    entries = {tuned.name: (tuned.plan, tuned.score.step_time_s)}
    for r in tuned.runners_up:
        if r.score is not None and r.bucket_bytes == tuned.bucket_bytes:
            entries.setdefault(r.name, (r.plan, r.score.step_time_s))
    active, ewma, strikes, events = tuned.name, {}, 0, []
    for step, t in enumerate(times):
        prev = ewma.get(active)
        ewma[active] = t if prev is None else alpha * t + (1 - alpha) * prev
        out = ewma[active] > entries[active][1] * (1 + tolerance)
        strikes = strikes + 1 if out else 0
        if strikes >= patience:
            strikes = 0
            best = min(entries, key=lambda n: (ewma.get(n, entries[n][1]), n))
            if best != active:
                active = best
                events.append((step, entries[best][0].signature()))
    return events


def time_embed_bucket(gen) -> None:
    """sign_pack, vote_combine and bf16 unpack_ternary at run S's largest
    bucket, the tied embedding (W = 4 bf16 planes of 155,582,464), held
    to their twins and timed beside their bounds (printed; the kernels
    line keeps the main leaf's rows)."""
    from repro_torch.kernels import fused, ops, ref

    n, w, bf16 = EMBED_N, MAIN_W, 2
    plane = ref.to_plane(torch.randn((w, n), device="cuda",
                                     generator=gen).to(torch.bfloat16))
    words = ops.pack_signs(plane)
    r = words.shape[1]
    rw = r // w
    routed = words.reshape(w, w, rw, 128).transpose(0, 1)
    gate = fused.shard_gate_words(range(w), rw, ternary=False, device="cuda")
    sw, mw = ops.vote_combine(routed, gate, num_workers=w)
    want = ref.vote_combine(routed, w, gate)
    sw_all, mw_all = sw.reshape(r, 128), mw.reshape(r, 128)
    u16 = ops.unpack_ternary(sw_all, mw_all, dtype=torch.bfloat16)
    if not (same(words, ref.sign_pack(plane)) and same(sw, want[0])
            and same(mw, want[1]) and same(u16, ref.unpack_ternary(
                sw_all, mw_all, torch.bfloat16))):
        fail("a packed-vote kernel differs from its twin at the embedding "
             "bucket")
    del want
    rows = {
        "sign_pack": (lambda: ops.pack_signs(plane),
                      w * n * (bf16 + 1 / 8), w * n * 3, time_ms),
        "vote_combine": (lambda: ops.vote_combine(routed, gate,
                                                  num_workers=w),
                         w * n / 8 + n / 8 + 2 * n / 8, n * (2 * w + 4),
                         time_cold_ms),
        "unpack_ternary_bf16": (lambda: ops.unpack_ternary(
            sw_all, mw_all, dtype=torch.bfloat16), 2 * n / 8 + bf16 * n,
            n * 4, time_ms),
    }
    for name, (fn, nbytes, nops, timer) in rows.items():
        ms = timer(fn)
        row = {"bytes": nbytes, "ops": nops}
        bound(row)
        print(f"kernel {name} at the embedding bucket (n={n} W={w}): "
              f"{ms:.4f} ms{' cold' if timer is time_cold_ms else ''}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{row['bound_ms'] / ms:.3f} of it", flush=True)


def run_tuned() -> dict:
    """Run S: ``Fabric.autotune`` on the full model's ``meta`` parameters
    against ``ici_ring``, ``tuned.apply(fabric)``, the ``tuned``
    controller attached, then the Trainer, as ``launch/train.py
    --autotune`` does: full qwen3-0.6B, W = 4, AdamW, 16 x 128 tokens,
    S_STEPS steps.  Each step launches what its plan's layout holds (the
    winner: 8 each of sign_pack, vote_combine and bf16 unpack_ternary;
    the int4 plan: 2 int4_quant a bucket), its low-bit aggregates equal
    the twins' on the step's own gradients, and the controller's events
    equal the reference's rule on the measured step times."""
    from repro_torch.configs import get_config
    from repro_torch.core import codec_name
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.fabric import Fabric
    from repro_torch.fabric import session as S
    from repro_torch.kernels import kernel_wrappers, ref
    from repro_torch.models import init_params
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    cfg = get_config("qwen3_0p6b")
    fabric = Fabric(num_workers=MAIN_W)
    t0 = time.perf_counter()
    tuned = fabric.autotune(init_params(cfg, device="meta"),
                            topology="ici_ring")
    tune_s = time.perf_counter() - t0
    prov = tuned.provenance["candidates"]
    print(f"[S tuned] autotune {tune_s:.3f} s ({prov['enumerated']} "
          f"candidates, {prov['estimated']} estimated, {prov['sim_scored']} "
          f"sim-scored, {len(tuned.runners_up)} runners-up; modeled with the "
          f"reference's constants): {json.dumps(tuned.summary())}",
          flush=True)
    if tuned.plan.signature() != S_WINNER:
        fail(f"S: autotune picked {tuned.plan.signature()}, the reference "
             f"picks {S_WINNER}")
    tuned.apply(fabric)
    controller = fabric.attach_controller("tuned", tuned=tuned)
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=16,
                             seed=0, learnable=False)
    trainer = Trainer(cfg, AdamW(peak_lr=3e-4, warmup_steps=2,
                                 total_steps=S_STEPS),
                      data, fabric=fabric, seed=0, device="cuda")
    params = trainer.init_state().model.tree()
    stash: dict = {}
    real = S.aggregate_tree_bucketed

    def keep(ctx, grads, policies, ef_states=None, **kw):
        out = real(ctx, grads, policies, ef_states=ef_states, **kw)
        stash["grads"], stash["agg"] = grads, out[0]
        return out

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    launches: dict = {}
    twin_s = []
    S.aggregate_tree_bucketed = keep
    try:
        for k in range(S_STEPS):
            plan = controller.plan
            before = {kn: fn.launches for kn, fn in wrappers.items()}
            dt_before = dict(wrappers["unpack_ternary"].launches_by_dtype)
            trainer.run(k + 1)
            rec = trainer.history[-1]
            delta = _launch_deltas(wrappers, before, dt_before)
            layout = fabric.layout_for(params, plan)
            lowbit = [b for b in layout.buckets
                      if codec_name(b.key.mode) != "fp32"]
            packed = [b for b in lowbit if b.key.schedule == "packed_a2a"]
            int4 = [b for b in lowbit if codec_name(b.key.mode) == "int4"]
            if plan.signature() == S_WINNER:
                n_packed = len(packed)
                want = {"sign_pack": n_packed, "vote_combine": n_packed,
                        "unpack_ternary_bf16": n_packed}
                if n_packed != S_PACKED:
                    fail(f"S step {k}: {n_packed} packed buckets")
            elif plan.signature() == S_RETUNED:
                want = {"int4_quant": 2 * len(int4)}
                if len(int4) != S_INT4 or packed:
                    fail(f"S step {k}: {len(int4)} int4 and {len(packed)} "
                         f"packed buckets")
            else:
                fail(f"S step {k}: plan {plan.signature()}")
            want = {kn: want.get(kn, 0) for kn in delta}
            if delta != want or not np.isfinite(rec["loss"]):
                fail(f"S step {k}: launches {delta}, expected {want}; loss "
                     f"{rec['loss']}")
            for kn, v in delta.items():
                launches[kn] = launches.get(kn, 0) + v
            # the step's low-bit aggregates against the twins, on the
            # step's own gradients
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gl = dict(T.flatten(stash.pop("grads")))
            al = dict(T.flatten(stash.pop("agg")))
            for bucket in lowbit:
                flat = torch.cat([gl[s.name].reshape(MAIN_W, -1)
                                  for s in bucket.slots], dim=1)
                got = torch.cat([al[s.name].reshape(-1)
                                 for s in bucket.slots])
                names = [s.name for s in bucket.slots]
                if codec_name(bucket.key.mode) == "int4":
                    enc = ref.from_plane(ref.int4_quant_plane(ref.to_plane(
                        flat.to(torch.float32))), flat.shape[1])
                    mean = fabric.group.all_reduce_mean(
                        enc.to(flat.dtype).to(torch.float32))
                    ok = same(got, mean)
                    del enc, mean
                else:
                    # the packed vote byte for byte; vote_psum (no kernel)
                    # to its value, zeros of either sign as zeros
                    check = (same if bucket.key.schedule == "packed_a2a"
                             else same_numbers)
                    ok = all(check(got[c:c + TWIN_CHUNK],
                                   twin_vote(flat[:, c:c + TWIN_CHUNK]))
                             for c in range(0, bucket.size, TWIN_CHUNK))
                if not ok:
                    fail(f"S step {k}: aggregate {names} "
                         f"({bucket.key.mode}, {bucket.key.schedule}) "
                         f"differs from the twins")
                del flat, got
            del gl, al
            torch.cuda.synchronize()
            twin_s.append(time.perf_counter() - t1)
            print(f"[S tuned] step {k}: loss {rec['loss']:.6f} time "
                  f"{rec['step_time_s']:.4f} s plan {rec['plan']} "
                  f"(active {controller.active}) launches "
                  f"{ {kn: d for kn, d in delta.items() if d} }; aggregates "
                  f"equal to the twins", flush=True)
    finally:
        S.aggregate_tree_bucketed = real
    times = [h["step_time_s"] for h in trainer.history]
    events = [(e.step, e.plan_signature) for e in controller.events]
    rule = tuned_rule(tuned, times)
    logged = [(e.step, e.kind, e.plan_signature) for e in controller.events]
    print(f"[S tuned] events {logged}; the reference's rule on these step "
          f"times: {rule}", flush=True)
    if events != rule or not events or events[0][1] != S_RETUNED:
        fail(f"S: events {events}; the reference's rule gives {rule}, "
             f"first to {S_RETUNED}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    card = card_line()
    print(f"[S tuned] {card}: step seconds {times} (predicted by the "
          f"artifact {tuned.score.step_time_s!r} s, the modeled "
          f"communication alone), twin checks after the steps {twin_s} s, "
          f"peak memory {peak:.2f} GiB", flush=True)
    print(f"[S tuned] losses {[h['loss'] for h in trainer.history]}",
          flush=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 11: the serving engine (run T)
# ---------------------------------------------------------------------------

#: six requests: prompt tokens, new tokens, arrival step; with T_BLOCKS
#: blocks of 16 the pool holds 608 positions, fewer than the four widest
#: requests need together, so one is preempted and spilled (the schedule
#: depends on the lengths alone)
T_PROMPTS = (128, 112, 96, 120, 64, 16)
T_NEW = (48, 40, 48, 32, 24, 16)
T_ARRIVALS = (0, 1, 2, 3, 5, 6)
T_BLOCKS = 38
T_ENGINE = dict(max_batch=4, max_seq=256, block_size=16,
                num_blocks=T_BLOCKS)


def t_trace(vocab: int) -> list:
    rng = np.random.RandomState(0)
    return [{"prompt": rng.randint(0, vocab, p).tolist(),
             "max_new_tokens": n, "arrival_step": a}
            for p, n, a in zip(T_PROMPTS, T_NEW, T_ARRIVALS)]


def serve_stepwise(eng, trace, profile_after: int | None = None,
                   steps: int | None = None) -> dict:
    """Submit ``trace`` and step ``eng`` until it drains, or for its first
    ``steps`` steps: each step's seconds, whether it prefilled, the tier's
    spill and fetch bytes a step, each prefill's seconds and, from step
    ``profile_after`` on, one pure decode step's kernel launch calls
    under ``torch.profiler``.  ``wall`` and ``tokens`` leave out the
    profiled step, whose time carries the profiler's."""
    from torch.profiler import ProfilerActivity, profile

    prefills: list = []
    real = eng._run_prefill

    def timed(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(req)
        torch.cuda.synchronize()
        prefills.append((len(req.prompt), time.perf_counter() - t0))

    eng._run_prefill = timed
    for e in trace:
        eng.submit(e["prompt"], e["max_new_tokens"], e["arrival_step"])
    steps_done, tier, launch_calls = [], [], None
    probed_s, probed_tokens = 0.0, 0
    t_start = time.perf_counter()
    while any(r.state.value != "finished" for r in eng.requests.values()) \
            and (steps is None or len(steps_done) < steps):
        before = (eng.cache.tier.spilled_bytes, eng.cache.tier.fetched_bytes)
        n_pre = len(prefills)
        probe = (launch_calls is None and profile_after is not None
                 and eng.step_index >= profile_after)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if probe:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                rec = eng.step()
                torch.cuda.synchronize()
        else:
            rec = eng.step()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pure = len(prefills) == n_pre and bool(rec.active)
        if probe:
            probed_s += dt
            probed_tokens += rec.new_tokens
            if pure and not rec.preempted:
                launch_calls = sum(e.key.startswith(("cudaLaunchKernel",
                                                     "cuLaunchKernel"))
                                   for e in prof.events())
        steps_done.append((dt, pure and not probe))
        tier.append((eng.cache.tier.spilled_bytes - before[0],
                     eng.cache.tier.fetched_bytes - before[1]))
    wall = time.perf_counter() - t_start - probed_s
    eng._run_prefill = real
    return {"steps": steps_done, "tier": tier, "prefills": prefills,
            "wall": wall,
            "tokens": sum(r.new_tokens for r in eng.records) - probed_tokens,
            "probed_s": probed_s, "launch_calls": launch_calls}


#: engine steps of the int4 KV replay: the first two admissions'
#: prefills and decode steps at batch 1 and 2
T_INT4_STEPS = 2


def run_serve() -> dict:
    """Run T: full qwen3-0.6B (bf16 weights, the reference's default
    float32 cache) served by ``ServeEngine`` on the card: max_batch 4,
    max_seq 256, blocks of 16, a T_BLOCKS-block pool, six requests (FCFS)
    arriving over steps 0-6.  Checks: a preemption and a spill/fetch round
    trip happen; the pool drains; each request's logits bit-identical to
    its solo run at the same max_batch; the same trace's first
    T_INT4_STEPS steps under the int4 KV codec give finite logits and
    every record's wire bytes equal the codec's price of its elements
    plus the step's spill and fetch bytes;
    ``simulate(topology="cxl_switched")`` replays the timeline.  Tokens
    a second leave out the step profiled for its launch calls."""
    from repro_torch.configs import get_config
    from repro_torch.fabric import get_codec
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen3_0p6b")
    trace = t_trace(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, seed=0, collect_logits=True, device="cuda",
                      **T_ENGINE)
    got = serve_stepwise(eng, trace, profile_after=8)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tl = eng.timeline()
    outputs = {rid: list(r.outputs) for rid, r in eng.requests.items()}
    tier = eng.cache.tier
    if not (tl.total_preemptions and tier.spills and tier.fetches):
        fail(f"T: preemptions {tl.total_preemptions}, spills {tier.spills}, "
             f"fetches {tier.fetches}: the pool never ran short")
    if eng.cache.blocks_in_use or any(len(outputs[i]) != n
                                      for i, n in enumerate(T_NEW)):
        fail(f"T: {eng.cache.blocks_in_use} blocks still held, outputs "
             f"{[len(v) for v in outputs.values()]}")
    if got["launch_calls"] is None:
        fail("T: no pure decode step was profiled")
    # the determinism contract, on the card
    solo_s = time.perf_counter()
    for rid, entry in enumerate(trace):
        solo = ServeEngine(cfg, params=eng.params, collect_logits=True,
                           device="cuda", **T_ENGINE)
        alone = solo.serve([{"prompt": entry["prompt"],
                             "max_new_tokens": entry["max_new_tokens"]}])
        rows, solo_rows = eng.logits[rid], solo.logits[0]
        if alone[0] != outputs[rid] or len(rows) != len(solo_rows) or \
                not all(torch.equal(a, b) for a, b in zip(rows, solo_rows)):
            bad = [i for i, (a, b) in enumerate(zip(rows, solo_rows))
                   if not torch.equal(a, b)]
            fail(f"T: request {rid}'s logits differ from its solo run at "
                 f"rows {bad[:8]} (of {len(rows)})")
        del solo
    solo_s = time.perf_counter() - solo_s
    # the int4 KV codec on the same trace
    e4 = ServeEngine(cfg, params=eng.params, kv_codec="int4",
                     collect_logits=True, device="cuda", **T_ENGINE)
    got4 = serve_stepwise(e4, trace, steps=T_INT4_STEPS)
    codec = get_codec("int4")
    rows4 = [r for rows in e4.logits.values() for r in rows]
    if len(e4.records) != T_INT4_STEPS or not rows4 or \
            not all(bool(torch.isfinite(r).all()) for r in rows4):
        fail(f"T int4: {len(e4.records)} steps, {len(rows4)} logit rows, "
             f"not all finite")
    for rec, (spilled, fetched) in zip(e4.records, got4["tier"]):
        if rec.wire_bytes != codec.kv_bytes(rec.n_elements) + spilled + \
                fetched:
            fail(f"T int4 step {rec.step}: wire bytes {rec.wire_bytes!r}, "
                 f"the codec prices {rec.n_elements} elements at "
                 f"{codec.kv_bytes(rec.n_elements)!r} plus spill {spilled} "
                 f"and fetch {fetched}")
    agree = sum(a == b for rid in e4.requests
                for a, b in zip(outputs[rid], e4.requests[rid].outputs))
    agree_of = sum(len(r.outputs) for r in e4.requests.values())
    rep = eng.simulate(topology="cxl_switched")
    if rep.num_launches != tl.num_steps:
        fail(f"T sim: {rep.num_launches} launches for {tl.num_steps} steps")
    decode_ms = [dt * 1e3 for dt, pure in got["steps"] if pure]
    new_tokens = tl.total_new_tokens
    card = card_line()
    print(f"[T serve] {card}: 6 requests, {tl.num_steps} engine steps, "
          f"{new_tokens} new tokens, {tl.total_preemptions} preemptions, "
          f"{tier.spills} spills / {tier.fetches} fetches, pool drained; "
          f"every request's logits bit-identical to its solo run "
          f"({solo_s:.2f} s for the six)", flush=True)
    print(f"[T serve] {card}: decode step ms (batch 4, pure decode steps) "
          f"{[round(m, 3) for m in decode_ms]}; median "
          f"{float(np.median(decode_ms)):.3f} ms", flush=True)
    print(f"[T serve] {card}: prefill seconds a prompt (tokens, s) "
          f"{[(n, round(s, 4)) for n, s in got['prefills']]}", flush=True)
    print(f"[T serve] {card}: {got['tokens'] / got['wall']:.2f} tokens a "
          f"second ({got['tokens']} tokens in {got['wall']:.3f} s wall; the "
          f"profiled step, {got['probed_s']:.3f} s, left out), "
          f"{got['launch_calls']} kernel launch calls in one decode step, "
          f"peak memory {peak:.2f} GiB", flush=True)
    fp32_bytes = sum(r.wire_bytes for r in tl.steps[:T_INT4_STEPS])
    print(f"[T serve] int4 KV, the first {T_INT4_STEPS} steps: "
          f"{e4.timeline().total_wire_bytes!r} wire bytes against fp32's "
          f"{fp32_bytes!r}; {agree} of {agree_of} greedy tokens as under "
          f"fp32; records priced at kv_bytes; {got4['wall']:.3f} s for "
          f"the {T_INT4_STEPS} steps, each prefilling a prompt", flush=True)
    print(f"[T sim] modeled, the reference's constants (cxl_switched): "
          f"step {rep.step_time_s!r} s, exposed {rep.exposed_pct!r} %, "
          f"{rep.num_launches} launches, wire bytes "
          f"{rep.wire_bytes_total!r}", flush=True)
    return {"launches": {}}


# ---------------------------------------------------------------------------
# phase 12: the recurrent and cross-attention decode
# ---------------------------------------------------------------------------

U_MODELS = ("xlstm_125m", "hymba_1p5b", "whisper_tiny")
U_BATCH, U_PROMPT, U_NEW = 4, 64, 32
#: the bf16 teacher-forced decode against the bf16 forward, as a fraction
#: of the largest |logit|: each bf16 product rounds its float32 sum once,
#: and cuBLAS picks its algorithm (tiles, split-K) by the row count, so a
#: product of the decode's 4 rows and of the forward's 384 may part by a
#: bf16 ulp (2^-8 of the value); through 12 or 32 blocks and 96 recurrent
#: steps such ulps add up.  2^-4 is 16 ulps of the largest logit.
U_TOL = 2.0 ** -4
#: the same decode in float32 (a float32 copy of the weights, a float32
#: cache): float32 sums in other orders, through as many layers
U_TOL32 = 1e-4


def teacher_forced(cfg, params, step, tokens, max_seq: int,
                   dtype) -> tuple[float, float]:
    """The decode of ``tokens`` one position at a time against the
    forward over all of them: (largest |difference|, largest |logit|)."""
    from repro_torch.models import forward, init_cache
    cache = init_cache(cfg, tokens.shape[0], max_seq, dtype=dtype,
                       device="cuda")
    got = []
    for t in range(tokens.shape[1]):
        lg, cache = step(params, tokens[:, t:t + 1], cache, t)
        got.append(lg.to(torch.float32))
    with torch.no_grad():
        ref = forward(params, cfg, {"tokens": tokens}).to(torch.float32)
    return (float((torch.stack(got, dim=1) - ref).abs().max()),
            float(ref.abs().max()))


def launch_calls(fn) -> int:
    """Kernel launch calls of one ``fn()`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
               for e in prof.events())


def decode_model(arch: str) -> None:
    """One model of run U: the default bf16 cache, batch U_BATCH, a
    U_PROMPT-token prompt through ``build_cached_prefill``, U_NEW greedy
    tokens through ``build_serve_step``, each step timed (after one
    untimed step on a scratch cache: the first calls' set-up); then one
    more step profiled for its launch calls, and the checks."""
    import dataclasses

    import repro_torch.models.layers as L
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models import init_cache, init_params
    from repro_torch.runtime.serve import (build_cached_prefill,
                                           build_serve_step)

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, generator=torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    rng = np.random.RandomState(0)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                          (U_BATCH, U_PROMPT))).cuda()
    enc_out = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.randn(
            U_BATCH, cfg.encoder_seq, cfg.d_model).astype(np.float32)).cuda()
        enc_out = frames.to(torch.bfloat16) @ params["embed"]["frame_proj"][
            "w"]
    max_seq = U_PROMPT + U_NEW + 1
    prefill = build_cached_prefill(cfg)
    step, _ = build_serve_step(cfg, batch=U_BATCH, max_seq=max_seq)
    step(params, prompt[:, :1], init_cache(cfg, U_BATCH, max_seq, enc_out,
                                           device="cuda"), 0)
    cache = init_cache(cfg, U_BATCH, max_seq, enc_out, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, U_PROMPT, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    seq, step_ms, rows = [prompt], [], [logits]
    cross = []
    real_cross = L.cross_attn_forward

    def recorded(*args):
        out = real_cross(*args)
        cross.append(out)
        return out

    for i in range(U_NEW):
        tok = rows[-1].argmax(-1)[:, None]
        seq.append(tok)
        if i == 0 and cfg.family == "encdec":
            L.cross_attn_forward = recorded
        t0 = time.perf_counter()
        logits, cache = step(params, tok, cache, U_PROMPT + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        L.cross_attn_forward = real_cross
        rows.append(logits)
    tokens = torch.cat(seq, dim=1)                      # (B, 96)
    nxt = rows[-1].argmax(-1)[:, None]
    calls = launch_calls(lambda: step(params, nxt, cache, U_PROMPT + U_NEW))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(bool(torch.isfinite(r).all()) for r in rows):
        fail(f"U {arch}: non-finite logits")
    check = ""
    if cfg.family == "encdec":
        if len(cross) != cfg.num_layers or any(bool(c.any()) for c in cross):
            fail(f"U {arch}: the cross-attention of a decode step added "
                 f"{[float(c.abs().max()) for c in cross]}, not zeros")
        check = (f"each of the {len(cross)} layers' cross-attention term "
                 f"of step 0 exactly zero (the reference's zero cross "
                 f"cache)")
    else:
        # the teacher-forced decode of the 96 tokens against the forward,
        # in bf16 and on a float32 copy of the weights
        err, big = teacher_forced(cfg, params, step, tokens, max_seq,
                                  torch.bfloat16)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        step32, _ = build_serve_step(cfg32, batch=U_BATCH, max_seq=max_seq)
        err32, big32 = teacher_forced(
            cfg32, T.map_leaves(lambda t: t.to(torch.float32), params),
            step32, tokens, max_seq, torch.float32)
        if not (err <= U_TOL * big and err32 <= U_TOL32 * big32):
            fail(f"U {arch}: teacher-forced decode {err} (bf16) and {err32} "
                 f"(float32) from the forward, over {U_TOL} of the largest "
                 f"logit {big} or {U_TOL32} of {big32}")
        check = (f"teacher-forced decode of the {tokens.shape[1]} tokens "
                 f"against the forward: bf16 within {err!r} (largest logit "
                 f"{big!r}; {err / big:.3e} of it, bound {U_TOL}), float32 "
                 f"within {err32!r} ({err32 / big32:.3e} of {big32!r}, "
                 f"bound {U_TOL32})")
    card = card_line()
    total = prefill_s + sum(step_ms) / 1e3
    print(f"[U {arch}] {card}: batch {U_BATCH}, {U_PROMPT}-token prompts, "
          f"{U_NEW} greedy tokens; decode step ms median "
          f"{float(np.median(step_ms)):.3f} (range {min(step_ms):.3f}-"
          f"{max(step_ms):.3f}); prefill {prefill_s:.3f} s a prompt "
          f"({prefill_s / U_PROMPT * 1e3:.3f} ms a token); "
          f"{U_BATCH * U_NEW / (sum(step_ms) / 1e3):.2f} tokens a second "
          f"decoding, {U_BATCH * U_NEW / total:.2f} with the prefill; "
          f"{calls} kernel launch calls in one decode step; peak memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"[U {arch}] {check}", flush=True)


def run_decode() -> dict:
    """Run U: xlstm-125m, hymba-1.5b and whisper-tiny whole, decoded."""
    for arch in U_MODELS:
        decode_model(arch)
        free()
    return {"launches": {}}


# ---------------------------------------------------------------------------
# phase 13: elastic training
# ---------------------------------------------------------------------------

V_W, V_STEPS = 4, 10
#: the Trainer's steps beside run V, its yardstick
V_STEPS_BASE = 6
V_CRASH = dict(worker=3, step=6, rejoin_step=8)
#: the history's worker count a step: 4, then 3 over the replayed steps
#: 4-5 and steps 6-7, then 4 from step 8
V_WORKERS = [4] * 6 + [3] * 4 + [4] * 2
#: run V': worker 1 six times slow on steps 1-2 of 7
VP_STEPS = 7
VP_STRAGGLER = dict(worker=1, start=1, stop=3, factor=6.0)
VP_CONTROLLER = dict(lowbit_plan="gbin_packed", demote_after=2,
                     recover_after=2)
#: the events the detector and controller give for those times on the
#: CPU, where tests/test_torch_elastic.py holds them to the reference's
VP_EVENTS = [(2, "demoted"), (6, "recovered")]


def elastic_trainer(faults, ckpt_dir=None, **kw):
    """An ElasticTrainer of full qwen3-0.6B on the card: W = V_W workers,
    each on its own stream of 4 x 128 tokens, SgdMomentum, synthetic step
    times of 1 s."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.elastic import ElasticConfig, ElasticTrainer
    from repro_torch.optim import SgdMomentum

    cfg = get_config("qwen3_0p6b")
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128, batch=4,
                             seed=0, learnable=False)
    return ElasticTrainer(
        cfg, SgdMomentum(peak_lr=3e-3, warmup_steps=1, total_steps=V_STEPS),
        data, V_W, faults=faults, ckpt_dir=ckpt_dir, seed=0, device="cuda",
        ecfg=ElasticConfig(checkpoint_interval=4, checkpoint_keep=1,
                           synthetic_step_time_s=1.0, log_interval=1),
        **kw)


def instrument(tr, records: list, after=None) -> None:
    """Wrap ``tr``'s built steps: each call appends its step, W, epoch,
    plan, seconds (ending in a synchronize) and kernel launches (the
    unpack_ternary decodes by output dtype) to ``records``;
    ``after(record, out, batch)`` runs after the step, and launches it
    makes (the twin checks) are taken off the counts again."""
    from repro_torch.kernels import kernel_wrappers

    wrappers = kernel_wrappers()
    decode_by = wrappers["unpack_ternary"].launches_by_dtype
    real_get = tr._get_step

    def get_step(plan, diagnostics):
        fn = real_get(plan, diagnostics)

        def counted(state, batch):
            before = {k: w.launches for k, w in wrappers.items()}
            dt_before = dict(decode_by)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            rec = {"step": state.step, "W": tr.fabric.num_workers,
                   "epoch": tr.fabric.membership_epoch,
                   "plan": plan.signature(),
                   "s": time.perf_counter() - t0,
                   "launches": {k: w.launches - before[k]
                                for k, w in wrappers.items()},
                   "decodes": {d: n - dt_before[d]
                               for d, n in decode_by.items()}}
            records.append(rec)
            if after is not None:
                mark = {k: w.launches for k, w in wrappers.items()}
                dt_mark = dict(decode_by)
                after(rec, out, batch)
                for k, w in wrappers.items():
                    w.launches = mark[k]
                decode_by.update(dt_mark)
            return out
        return counted

    tr._get_step = get_step


def launches_of(records: list) -> dict:
    """The kernels line's counts from a run's step records."""
    out: dict = {}
    for r in records:
        for k, n in r["launches"].items():
            if k != "unpack_ternary":
                out[k] = out.get(k, 0) + n
        for dt, key in ((torch.float32, "unpack_ternary"),
                        (torch.bfloat16, "unpack_ternary_bf16")):
            out[key] = out.get(key, 0) + r["decodes"][dt]
    return out


def check_vote_launches(name: str, rec: dict, packed: int) -> None:
    """A packed vote step: ``packed`` launches each of sign_pack,
    vote_combine and bf16 unpack_ternary, nothing else."""
    want = {k: (packed if k in ("sign_pack", "vote_combine",
                                "unpack_ternary") else 0)
            for k in rec["launches"]}
    if rec["launches"] != want or rec["decodes"][torch.bfloat16] != packed:
        fail(f"{name} step {rec['step']} (W {rec['W']}): launches "
             f"{rec['launches']}, decodes {rec['decodes']}; expected {want}, "
             f"all bf16")


def run_elastic() -> dict:
    """Run V: full qwen3-0.6B through ElasticTrainer, W = 4 under the
    static gbin_packed plan (bucketed, fused kernels), a checkpoint every
    4 steps (keep 1) under build/, worker 3 crashing at step 6 and
    rejoining at 8: the rollback to step 4, the replay at W = 3, the
    rejoin.  Checks the report, the history's worker counts, the
    restored parameters bit-equal to those saved at step 4, 7 launches
    each of sign_pack, vote_combine and bf16 unpack_ternary a step at
    both W, and one step at each W byte-equal to the plain twins."""
    import shutil

    from repro_torch.core import codec_name
    from repro_torch.core import tree as T
    from repro_torch.data import SyntheticLMStream
    from repro_torch.elastic import Crash, replay_schedule
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.models import init_params
    from repro_torch.runtime import Trainer

    plan = plan_presets()["gbin_packed"]
    root = os.path.join(ROOT, "build", "ckpt_run_v")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    records, twins, saves, restores = [], [], {}, []
    tr = elastic_trainer([Crash(**V_CRASH)], ckpt_dir=root, plan=plan)

    def twin(rec, out, batch):
        # the first step of each view: the aggregates against the twins
        if (rec["W"], rec["epoch"]) in {(w, e) for w, e, _ in twins}:
            return
        params = out[0].model.tree()
        run = {"trainer": tr, "params": params, "batch": batch,
               "lowbit": [b for b in tr.fabric.layout_for(params,
                                                          plan).buckets
                          if codec_name(b.key.mode) != "fp32"]}
        twins.append((rec["W"], rec["epoch"],
                      check_twin_step(f"V W={rec['W']}", tr.fabric, plan,
                                      run)))

    instrument(tr, records, after=twin)
    real_save, real_restore = tr.ckpt.maybe_save, tr._restore

    def save(step, tree, **kw):
        t0 = time.perf_counter()
        saved = real_save(step, tree, **kw)
        if saved:
            t1 = time.perf_counter()
            tr.ckpt.wait()
            t2 = time.perf_counter()
            path = os.path.join(root, f"step_{step:010d}")
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            saves[step] = (t1 - t0, t2 - t1, size, [
                p.detach().clone() for p in T.leaves(tr.state.model.tree())]
                if step == 4 else None)
        return saved

    def restore():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = real_restore()
        torch.cuda.synchronize()
        if ok:
            restores.append((time.perf_counter() - t0, tr.state.step, [
                p.detach().clone()
                for p in T.leaves(tr.state.model.tree())]))
        return ok

    tr.ckpt.maybe_save, tr._restore = save, restore
    try:
        t0 = time.perf_counter()
        hist = tr.run(V_STEPS)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rep = tr.report()
    if (rep["restarts"], rep["replayed_steps"], rep["compiled_steps"],
            rep["final_view"]) != (1, 2, 3, {"epoch": 2,
                                              "workers": [0, 1, 2, 3]}) \
            or rep["recoveries"][0]["steps_to_recover"] != 2:
        fail(f"V: report {rep}")
    if [h["num_workers"] for h in hist] != V_WORKERS:
        fail(f"V: worker counts {[h['num_workers'] for h in hist]}, "
             f"expected {V_WORKERS}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"V: losses {[h['loss'] for h in hist]}")
    if len(restores) != 1 or restores[0][1] != 4 or 4 not in saves:
        fail(f"V: restores at {[r[1] for r in restores]}, saves at "
             f"{sorted(saves)}")
    for a, b in zip(saves[4][3], restores[0][2]):
        if not same(a, b):
            fail("V: the parameters restored differ from those saved at "
                 "step 4")
    for rec in records:
        check_vote_launches("V", rec, LOWBIT_BUCKETS)
    if sorted((w, e) for w, e, _ in twins) != [(3, 1), (4, 0), (4, 2)]:
        fail(f"V: twin checks at {[(w, e) for w, e, _ in twins]}")
    card = card_line()
    by_view: dict = {}
    for r in records:
        by_view.setdefault((r["epoch"], r["W"]), []).append(round(r["s"], 4))
    print(f"[V elastic] {card}: {len(records)} steps in {wall:.2f} s "
          f"(with the checkpoints and the twin checks); report {rep}",
          flush=True)
    print(f"[V elastic] step seconds by (epoch, W): {by_view}", flush=True)
    print(f"[V elastic] losses {[round(h['loss'], 6) for h in hist]}",
          flush=True)
    for step, (snap, write, size, _) in sorted(saves.items()):
        print(f"[V elastic] checkpoint at step {step}: {size} bytes, "
              f"snapshot to host {snap:.3f} s, write {write:.3f} s",
              flush=True)
    print(f"[V elastic] restore to step {restores[0][1]}: "
          f"{restores[0][0]:.3f} s, the parameters bit-equal to those saved "
          f"at step 4; peak memory {peak:.2f} GiB", flush=True)
    for w, e, extra in twins:
        print(f"[V elastic] W={w} epoch {e}: aggregates byte-equal to the "
              f"plain twins{extra}", flush=True)
    sim = replay_schedule(init_params(tr.cfg, device="meta"), plan, V_W,
                          V_STEPS, faults=[Crash(**V_CRASH)],
                          topology="cxl_direct")
    print(f"[V sim] modeled, the reference's constants (cxl_direct, "
          f"compute 1e-3 s a step): {json.dumps(sim.to_jsonable())}",
          flush=True)
    launches = launches_of(records)
    # the elastic loop's yardstick: the Trainer on the same model, plan,
    # optimizer and 16 x 128 tokens, in this call
    cfg, opt = tr.cfg, tr.optimizer
    del tr, twins, saves, restores
    free()
    data = SyntheticLMStream(vocab=cfg.vocab_size, seq_len=128,
                             batch=V_W * 4, seed=0, learnable=False)
    base = Trainer(cfg, opt, data, plan=plan, fabric=Fabric(num_workers=V_W),
                   seed=0, device="cuda")
    base.run(V_STEPS_BASE)
    step_s = [h["step_time_s"] for h in base.history]
    v4 = [r["s"] for r in records if r["W"] == V_W]
    print(f"[V elastic] the Trainer on the same plan and batch: step "
          f"seconds {[round(t, 4) for t in step_s]}; medians "
          f"{float(np.median(step_s)):.4f} s against V's W = {V_W} "
          f"{float(np.median(v4)):.4f} s", flush=True)
    return {"launches": launches}


def run_straggler() -> dict:
    """Run V': full qwen3-0.6B, W = 4, synthetic step times with worker 1
    six times slow on steps 1-2, under ``straggler_aware`` (demote to
    gbin_packed with EF after 2 flagged steps, recover after 2 stable):
    the events at the CPU's steps, each low-bit step launching what its
    layout's ``layout_kernel_stats`` models, and finite EF rows."""
    from repro_torch.core import tree as T
    from repro_torch.elastic import Straggler, StragglerAwareController
    from repro_torch.fabric import layout_kernel_stats

    ctrl = StragglerAwareController(**VP_CONTROLLER)
    records = []
    torch.cuda.reset_peak_memory_stats()
    tr = elastic_trainer([Straggler(**VP_STRAGGLER)], controller=ctrl)
    instrument(tr, records)
    hist = tr.run(VP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = [(e.step, e.kind) for e in ctrl.events]
    if events != VP_EVENTS:
        fail(f"V': events {events}, expected {VP_EVENTS}")
    lowbit = ctrl.lowbit_plan.signature()
    params = tr.state.model.tree()
    for rec in records:
        if rec["plan"] != lowbit:
            if any(rec["launches"].values()):
                fail(f"V' step {rec['step']}: FP32 launched "
                     f"{rec['launches']}")
            continue
        stats = layout_kernel_stats(tr.fabric.layout_for(params,
                                                         ctrl.lowbit_plan),
                                    tr.fabric.num_workers)
        if sum(rec["launches"].values()) != stats["launches_fused"]:
            fail(f"V' step {rec['step']}: {rec['launches']} against the "
                 f"modeled {stats}")
        check_vote_launches("V'", rec, LOWBIT_BUCKETS)
    low = [r["step"] for r in records if r["plan"] == lowbit]
    if low != list(range(VP_EVENTS[0][0] + 1, VP_STEPS)):
        fail(f"V': low-bit steps {low}")
    ef = [e for e in T.leaves(tr.state.ef)]
    if not all(bool(torch.isfinite(e).all()) for e in ef) or \
            not any(bool(e.any()) for e in ef):
        fail("V': EF rows not finite, or all zero after the low-bit steps")
    card = card_line()
    print(f"[V' straggler] {card}: events {events}; stragglers a step "
          f"{[h['stragglers'] for h in hist]}; low-bit steps {low}, each "
          f"{LOWBIT_BUCKETS} x (sign_pack, vote_combine, bf16 "
          f"unpack_ternary) as layout_kernel_stats models; EF rows finite",
          flush=True)
    print(f"[V' straggler] step seconds {[round(r['s'], 4) for r in records]}"
          f" (plans {['lowbit' if r['plan'] == lowbit else 'fp32' for r in records]}); "
          f"peak memory {peak:.2f} GiB", flush=True)
    return {"launches": launches_of(records)}


# ---------------------------------------------------------------------------
# phase 15: serving on a (data, model) process mesh
# ---------------------------------------------------------------------------

W_MESH = (2, 2)             # (data, model)
W_BATCH, W_MAX_SEQ, W_PROMPT, W_NEW = 4, 256, 64, 32
W_F32_TOKENS = 8
#: the bf16 mesh decode against the one-device decode, as a fraction of
#: the largest |logit| (run U's bound: the row-parallel sums add two bf16
#: halves where one product sums in float32, the combine sums the
#: partial softmaxes in float32 where the one-device softmax rounds its
#: probabilities to bf16, through 28 layers)
W_TOL = 2.0 ** -4
#: the same in float32 (a float32 copy of the weights, a float32 cache)
W_TOL32 = 1e-4


def w_prompt(cfg) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (W_BATCH, W_PROMPT)))


def w_layout(mesh, cfg, params, batch: int, prompt, new: int = W_NEW,
             max_seq: int = W_MAX_SEQ, routing: list | None = None) -> dict:
    """One layout of run W (or Z.2) on this rank: ``prompt`` (batch,
    prompt length) through the mesh's cached prefill, ``new`` greedy
    tokens through its step, each timed; one step's collectives and
    launch calls.  ``routing`` collects the prefill's and the decode's
    expert choices."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.serve import build_cached_prefill, \
        build_serve_step

    step, sh = build_serve_step(cfg, mesh, batch=batch, max_seq=max_seq)
    prefill = build_cached_prefill(cfg, mesh, batch=batch, max_seq=max_seq)
    # one untimed step on a scratch cache: the first calls' set-up
    step(params, prompt[:, :1], init_cache(cfg, batch, max_seq,
                                           device="cuda", mesh=mesh), 0)
    cache = init_cache(cfg, batch, max_seq, device="cuda", mesh=mesh)
    local_k = tuple(cache["k"].shape)
    n = prompt.shape[1]
    with record_routing() as picks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompt, n, cache)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        rows, toks, step_ms, calls = [logits], [], [], None
        for i in range(new):
            tok = rows[-1].argmax(-1)[:, None]
            toks.append(tok)
            if i == 1:
                mesh.reset_counts()
            t0 = time.perf_counter()
            logits, cache = step(params, tok, cache, n + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 1:
                calls = {name: (dict(g.calls_by_op), dict(g.bytes_by_op))
                         for name, g in (("data", mesh.data_group),
                                         ("model", mesh.model_group),
                                         ("world", mesh.world))}
            rows.append(logits)
    if routing is not None:
        routing.extend(picks)
    nxt = rows[-1].argmax(-1)[:, None]
    launch = launch_calls(lambda: step(params, nxt, cache, n + new))
    return {"shard_seq": sh["shard_seq"], "local_k": local_k,
            "prefill_s": prefill_s, "step_ms": step_ms, "calls": calls,
            "launch_calls": launch,
            "tokens": torch.cat(toks, dim=1).cpu(),
            "logits": torch.stack(rows).to(torch.float32).cpu(),
            "finite": all(bool(torch.isfinite(r).all()) for r in rows)}


def w_f32(mesh, cfg, params, batch: int, prompt,
          max_seq: int = W_MAX_SEQ) -> dict:
    """The float32 pass: W_F32_TOKENS prompt tokens teacher-forced, then
    W_F32_TOKENS greedy ones, through the mesh's step on a float32 copy
    of the weights and a float32 cache."""
    import dataclasses

    from repro_torch.core import tree as T
    from repro_torch.models import init_cache
    from repro_torch.runtime.serve import build_serve_step

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = T.map_leaves(lambda t: t.to(torch.float32), params)
    step, _ = build_serve_step(cfg32, mesh, batch=batch, max_seq=max_seq)
    cache = init_cache(cfg32, batch, max_seq, dtype=torch.float32,
                       device="cuda", mesh=mesh)
    rows, toks = [], []
    with record_routing() as picks:
        for t in range(2 * W_F32_TOKENS):
            if t < W_F32_TOKENS:
                tok = prompt[:, t:t + 1]
            else:
                tok = rows[-1].argmax(-1)[:, None].to(prompt.device)
                toks.append(tok.cpu())
            logits, cache = step(p32, tok, cache, t)
            rows.append(logits.cpu())
    return {"logits": torch.stack(rows), "tokens": torch.cat(toks, dim=1),
            "topi": picks}


def one_device_logits(cfg, params, prompt, tokens, max_seq: int,
                      dtype=torch.bfloat16):
    """The one-device step teacher-forced on ``prompt`` and a mesh's
    greedy ``tokens`` (on the host), on a cache of ``dtype``: the float32
    logits from the prompt's last position on, (len(tokens) + 1, batch,
    V) on the host."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.serve import build_serve_step

    batch, n = prompt.shape
    seq = torch.cat([prompt, tokens.to(prompt.device)], dim=1)
    step, _ = build_serve_step(cfg, batch=batch, max_seq=max_seq)
    cache = init_cache(cfg, batch, max_seq, dtype=dtype, device="cuda")
    rows = []
    for t in range(seq.shape[1]):
        lg, cache = step(params, seq[:, t:t + 1], cache, t)
        if t >= n - 1:
            rows.append(lg.to(torch.float32))
    return torch.stack(rows).cpu()


def run_w_rank(rank: int, out: str) -> None:
    """One rank of run W: full qwen3-0.6B on a (data 2) x (model 2) mesh,
    four gloo ranks on cuda:0, the batched and the shard_seq layout."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import ProcessMesh
    from repro_torch.core import tree as T
    from repro_torch.models import init_params
    from repro_torch.models.transformer import shard_params

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=W_MESH[0] * W_MESH[1],
                            timeout=timedelta(seconds=120))
    mesh = ProcessMesh(W_MESH, device="cuda:0")
    cfg = get_config("qwen3_0p6b")
    whole = init_params(cfg, generator=torch.Generator(device="cuda")
                        .manual_seed(0), device="cuda")
    params = T.map_leaves(torch.Tensor.clone, shard_params(
        whole, cfg, mesh.extents, mesh.coords))
    del whole
    free()
    prompt = w_prompt(cfg).cuda()
    res = {"coords": mesh.coords,
           "params_local": sum(p.numel() for p in T.leaves(params))}
    for name, batch in (("batched", W_BATCH), ("seq", 1)):
        res[name] = w_layout(mesh, cfg, params, batch, prompt[:batch])
        res[name + "/f32"] = w_f32(mesh, cfg, params, batch,
                                   prompt[:batch])
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if rank:                    # the logits are replicated: keep rank 0's
        for name in ("batched", "seq"):
            res[name]["logits_sum"] = float(res[name].pop("logits").sum())
            res.pop(name + "/f32")
    else:
        for name in ("batched", "seq"):
            res[name]["logits_sum"] = float(res[name]["logits"].sum())
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_serve_mesh() -> dict:
    """Run W: full qwen3-0.6B served on a (data 2) x (model 2) process
    mesh, four gloo ranks on cuda:0: the batched layout (batch 4, the
    cache's 256 positions 128 a model rank) and the shard_seq layout
    (batch 1, 64 positions a rank), each a 64-token prompt through the
    mesh's cached prefill and 32 greedy tokens, and a float32 pass (8
    prompt tokens, 8 greedy ones); then, in this process, the one-device
    step teacher-forced on the same tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models import init_cache, init_params
    from repro_torch.runtime.serve import build_serve_step

    world = W_MESH[0] * W_MESH[1]
    ranks, _, spawn_s = spawn_ranks("--run-w-rank", world)
    cfg = get_config("qwen3_0p6b")
    params = init_params(cfg, generator=torch.Generator(device="cuda")
                         .manual_seed(0), device="cuda")
    prompt = w_prompt(cfg).cuda()
    r0 = ranks[0]
    card = card_line()
    bad = []
    for name, batch in (("batched", W_BATCH), ("seq", 1)):
        got = r0[name]
        if not all(r[name]["finite"] for r in ranks):
            fail(f"W {name}: non-finite logits")
        sums = {r[name]["logits_sum"] for r in ranks}
        if len(sums) != 1 or any(not torch.equal(r[name]["tokens"],
                                                 got["tokens"])
                                 for r in ranks):
            fail(f"W {name}: the ranks' logits or tokens differ ({sums})")
        want_shard = name == "seq"
        if got["shard_seq"] != want_shard:
            fail(f"W {name}: shard_seq {got['shard_seq']}")
        # the one-device step, teacher-forced on the mesh's tokens
        one = one_device_logits(cfg, params, prompt[:batch], got["tokens"],
                                W_MAX_SEQ)
        mesh_lg = got["logits"]
        err = float((mesh_lg - one).abs().max())
        big = float(one.abs().max())
        greedy = one[:-1].argmax(-1).T                 # (batch, W_NEW)
        same_tok = torch.equal(greedy, got["tokens"])
        top2 = one[:-1].topk(2, dim=-1).values
        margin = float((top2[..., 0] - top2[..., 1]).min())
        # the greedy tokens: equal wherever the one-device top-2 margin
        # exceeds twice the bf16 distance (bf16 logits tie, or nearly:
        # where they do, another order of sums may pick the other)
        decided = (top2[..., 0] - top2[..., 1]).T > 2 * err
        same_tok = torch.equal(greedy[decided], got["tokens"][decided])
        # float32: the teacher-forced prompt and the mesh's greedy tokens
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = T.map_leaves(lambda t: t.to(torch.float32), params)
        step32, _ = build_serve_step(cfg32, batch=batch, max_seq=W_MAX_SEQ)
        c32 = init_cache(cfg32, batch, W_MAX_SEQ, dtype=torch.float32,
                         device="cuda")
        f32 = r0[name + "/f32"]
        toks32 = torch.cat([prompt[:batch, :W_F32_TOKENS].cpu(),
                            f32["tokens"]], dim=1).cuda()
        rows32 = []
        for t in range(2 * W_F32_TOKENS):
            lg, c32 = step32(p32, toks32[:, t:t + 1], c32, t)
            rows32.append(lg.cpu())
        del p32, c32
        one32 = torch.stack(rows32)
        err32 = float((f32["logits"] - one32).abs().max())
        big32 = float(one32.abs().max())
        greedy32 = one32[W_F32_TOKENS - 1:-1].argmax(-1).T
        same32 = torch.equal(greedy32, f32["tokens"])
        ok = (err <= W_TOL * big and err32 <= W_TOL32 * big32 and same_tok
              and same32)
        if not ok:
            where = ((greedy != got["tokens"]) & decided).nonzero().tolist()
            bad.append(f"{name}: bf16 {err} of {big}, float32 {err32} of "
                       f"{big32}, bf16 greedy mismatches where decided at "
                       f"{where[:8]}, float32 greedy equal {same32}")
        ms = got["step_ms"]
        print(f"[W serve-mesh {name}] {card}: {world} gloo ranks on cuda:0 "
              f"as (data, model) = {W_MESH}, {cfg.name} ({cfg.num_layers} "
              f"layers, {r0['params_local']} parameters a rank), batch "
              f"{batch}, a local cache block {got['local_k']}; "
              f"{W_PROMPT}-token prompts, {W_NEW} greedy tokens; decode "
              f"step ms median {float(np.median(ms)):.3f} (range "
              f"{min(ms):.3f}-{max(ms):.3f}); prefill {got['prefill_s']:.3f}"
              f" s a prompt; {got['launch_calls']} kernel launch calls in "
              f"one decode step on rank 0; peak memory a rank (GiB) "
              f"{[round(r['peak_gib'], 2) for r in ranks]}", flush=True)
        print(f"[W serve-mesh {name}] {card}: one decode step's collectives "
              f"on rank 0, (calls, bytes) by op and group: {got['calls']}",
              flush=True)
        print(f"[W serve-mesh {name}] against the one-device step "
              f"teacher-forced on the same {W_PROMPT + W_NEW} tokens: bf16 "
              f"within {err!r} (largest logit {big!r}; {err / big:.3e} of "
              f"it, bound {W_TOL}), float32 ({2 * W_F32_TOKENS} tokens) within "
              f"{err32!r} ({err32 / big32:.3e} of {big32!r}, bound "
              f"{W_TOL32}); the {W_F32_TOKENS} float32 greedy tokens equal: "
              f"{same32}; the bf16 greedy tokens equal at the "
              f"{int(decided.sum())} of {decided.numel()} positions whose "
              f"one-device top-2 margin exceeds twice that distance: "
              f"{same_tok}, at all: {torch.equal(greedy, got['tokens'])} "
              f"(smallest top-2 margin {margin!r})", flush=True)
    print(f"[W serve-mesh] spawn {spawn_s:.2f} s", flush=True)
    if bad:
        fail(f"W: {bad}")
    return {"launches": {}}


# ---------------------------------------------------------------------------
# phase 16: the reference's examples
# ---------------------------------------------------------------------------

#: the mesh examples under torchrun (8 ranks on cuda:0 over gloo), their
#: arguments, and the kernels each must launch a step
X_MESH = {"quickstart": ["--steps", "2"],
          "train_lm": ["--preset", "100m", "--steps", "2"],
          "serve_lm": ["--tokens", "8"]}
#: the others, in this process, their arguments and keyword sizes
X_LOCAL = {"serving": ([], {}), "autotune_plan": ([], {}),
           "elastic_training": ([], {}),
           "layer_aware_admission": (["--fast"], {"fast_steps": (60, 110)}),
           "guarded_recovery": ([], {})}


def run_x_rank(name: str, out: str, argv: list) -> None:
    """One torchrun rank of a mesh example: run it, then write this
    rank's kernel launches by wrapper (unpack_ternary by dtype)."""
    import importlib

    from repro_torch.kernels import kernel_wrappers

    importlib.import_module(f"repro_torch.examples.{name}").main(argv)
    wrappers = kernel_wrappers()
    split = wrappers["unpack_ternary"].launches_by_dtype
    counts = {n: fn.launches for n, fn in wrappers.items()}
    counts["unpack_ternary"] = split[torch.float32]
    counts["unpack_ternary_bf16"] = split[torch.bfloat16]
    with open(os.path.join(out, f"{name}.rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(counts, f)


def run_examples() -> dict:
    """Run X: the eight examples on the card: quickstart and train_lm
    (the bf16 100m preset) at 2 steps and serve_lm at 8 tokens under
    ``torchrun --nproc-per-node 8``, every rank on cuda:0 over gloo, the
    three at once; serving, autotune_plan, elastic_training,
    layer_aware_admission (``--fast`` at 60 and 110 steps, past its
    50-step FP32 warm-up) and guarded_recovery in this process, the
    others whole.  Each runs its own assertions; the training
    examples' rank 0 must launch sign_pack, vote_combine and
    unpack_ternary (bf16 decodes for the bf16 preset)."""
    import contextlib
    import importlib
    import io
    import shutil
    import tempfile
    import threading

    from repro_torch.kernels import kernel_wrappers

    card = card_line()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    launches = {}
    try:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   PYTHONWARNINGS="ignore")
        procs, logs, ended = {}, {}, {}
        t0 = time.perf_counter()

        def wait(name):
            procs[name].wait()
            ended[name] = time.perf_counter() - t0

        for name, args in X_MESH.items():
            logs[name] = open(os.path.join(out, f"{name}.log"), "w")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "8",
                 os.path.abspath(__file__), "--run-x-rank", name, out,
                 "--device", "cuda:0", *args],
                env=env, stdout=logs[name], stderr=subprocess.STDOUT)
            threading.Thread(target=wait, args=(name,), daemon=True).start()
        # the one-process examples meanwhile
        wrappers = kernel_wrappers()
        for name, (args, kw) in X_LOCAL.items():
            before = {n: fn.launches for n, fn in wrappers.items()}
            by_dtype = dict(wrappers["unpack_ternary"].launches_by_dtype)
            if name == "autotune_plan":
                args = args + ["--out", os.path.join(out, "tuned.json")]
            buf = io.StringIO()
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                importlib.import_module(
                    f"repro_torch.examples.{name}").main(
                        ["--device", "cuda", *args], **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - s0
            delta = _launch_deltas(wrappers, before, by_dtype)
            for k, v in delta.items():
                launches[k] = launches.get(k, 0) + v
            tail = buf.getvalue().strip().splitlines()[-2:]
            print(f"[X examples] {name} {card}: {dt:.2f} s in this process, "
                  f"launches {({k: v for k, v in delta.items() if v})}; "
                  f"its last lines {tail}", flush=True)
            free()
        for name, p in procs.items():
            try:
                p.wait(timeout=600)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                logs[name].close()
        wall = time.perf_counter() - t0
        for name in X_MESH:
            with open(os.path.join(out, f"{name}.log")) as f:
                text = f.read()
            if procs[name].returncode:
                print(text[-6000:], flush=True)
                fail(f"X {name}: torchrun exit {procs[name].returncode}")
            ranks = []
            for r in range(8):
                with open(os.path.join(out, f"{name}.rank{r}.json")) as f:
                    ranks.append(json.load(f))
            lines = [ln for ln in text.splitlines()
                     if ln.strip() and not ln.startswith(("[W", "W1", "/"))
                     and "Warning" not in ln and "warn" not in ln]
            r0 = {k: v for k, v in ranks[0].items() if v}
            if name != "serve_lm":
                want = {"sign_pack", "vote_combine",
                        "unpack_ternary_bf16" if name == "train_lm"
                        else "unpack_ternary"}
                if not want <= set(r0):
                    fail(f"X {name}: rank 0 launched {r0}, not {want}")
            for k, v in ranks[0].items():
                launches[k] = launches.get(k, 0) + v
            print(f"[X examples] {name} {card}: torchrun, 8 ranks on cuda:0 "
                  f"over gloo, {X_MESH[name]}, {ended[name]:.2f} s from the "
                  f"start of X; rank 0's launches {r0}; "
                  f"launches a rank {[sum(r.values()) for r in ranks]}; its "
                  f"last lines {lines[-3:]}", flush=True)
        print(f"[X examples] {card}: the three torchrun examples and the "
              f"five in this process, together {wall:.2f} s", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 17: expert parallelism on a (data, model) process mesh (run Z)
# ---------------------------------------------------------------------------

Z_MESH = (2, 2)             # (data, model)
Z_STEPS = 2
#: a data rank's sequences of Z_SEQ tokens: one 1024-token dispatch group
Z_SHARD, Z_SEQ = 2, 512
#: the unsharded Fabric's on the same model and plan (run M's)
Z_TRAFFIC_RATIO = 0.27310381290117447
Z_PROMPT, Z_NEW, Z_MAX_SEQ = 64, 16, 128
#: Z.2's gate on its bf16 near-ties: at most Z_FLIPS_MAX of the 640
#: (token, MoE layer) expert sets flipped, and at least Z_HELD_MIN of the
#: (position, row)s held by W_TOL; an H100 measured 40 flips and 57 of 68
#: held, so these are twice the flips and half the positions
Z_FLIPS_MAX, Z_HELD_MIN = 80, 0.5


def z_config():
    """Run Z's model: deepseek-moe-16b at full width cut to run M's 3
    layers (the dense first layer and 2 MoE layers of 64 routed experts,
    top-6, and 2 shared; 1,681,143,808 parameters)."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek_moe_16b"), num_layers=3)


def z_data(cfg):
    from repro_torch.data import SyntheticLMStream
    return SyntheticLMStream(vocab=cfg.vocab_size, seq_len=Z_SEQ,
                             batch=Z_MESH[0] * Z_SHARD, seed=0,
                             learnable=False)


def run_z_rank(rank: int, out: str) -> None:
    """One rank of run Z: Z.1, Z_STEPS gbin_packed steps with AdamW and
    ZeRO-1 of run Z's model on a (data 2) x (model 2) mesh, its experts
    over the model ranks; then Z.2, a batched decode of W_BATCH rows on
    the same ranks from the seed's parameters."""
    from datetime import timedelta

    import torch.distributed as dist
    from repro_torch.core import ProcessMesh, codec_name
    from repro_torch.core import tree as T
    from repro_torch.fabric import Fabric, plan_presets
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.models import init_params
    from repro_torch.models.transformer import shard_params
    from repro_torch.optim import AdamW
    from repro_torch.runtime import Trainer

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=Z_MESH[0] * Z_MESH[1],
                            timeout=timedelta(seconds=300))
    mesh = ProcessMesh(Z_MESH, device="cuda:0")
    cfg = z_config()
    data = z_data(cfg)
    plan = plan_presets()["gbin_packed"]
    fabric = Fabric(mesh=mesh)
    trainer = Trainer(cfg, AdamW(peak_lr=3e-4, warmup_steps=2,
                                 total_steps=Z_STEPS), data, plan=plan,
                      fabric=fabric, seed=0, device="cuda:0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.init_state()
    torch.cuda.synchronize()
    res = {"init_s": time.perf_counter() - t0, "coords": mesh.coords}
    model = trainer.state.model
    params = model.tree()
    layout = fabric.layout_for(params, plan, trainer.pspecs)
    packed = [(key, n) for key, n in layout.launches()
              if codec_name(key.mode) != "fp32"]
    if any(key.schedule != "packed_a2a" for key, _ in packed):
        fail(f"Z: low-bit launches off the packed schedule: {packed}")
    specs = dict(T.flatten(trainer.pspecs))
    res["experts"] = sorted(p for p, s in specs.items()
                            if len(s) == 4 and s[1] == "model")
    res["unfused"] = [u.name for u in layout.unfused]
    res["buckets"] = [[s.name for s in b.slots] for b in layout.buckets]
    st = trainer.state.opt
    res["moment_bytes"] = sum(m.numel() * 4 for m in
                              T.leaves(st.mu) + T.leaves(st.nu))
    res["whole_moment_bytes"] = sum(2 * 4 * p.numel()
                                    for p in T.leaves(params))
    res["params_local"] = sum(p.numel() for p in T.leaves(params))

    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    decode_by = wrappers["unpack_ternary"].launches_by_dtype
    res.update(loss=[], step_s=[], launches=[], calls=[])
    for k in range(Z_STEPS):
        batch = {n: torch.as_tensor(v).cuda()
                 for n, v in data.batch_at(k).items()}
        if k == 0:
            # this step's gradients and routing, recomputed, for the
            # parent's unsharded model
            with record_routing() as picks:
                grads, _ = fabric.worker_grads(params, batch, model.loss)
            res["topi"] = picks[:cfg.num_layers - cfg.moe.first_dense]
            if mesh.data_index == 0:
                torch.save({p: g[0].cpu() for p, g in T.flatten(grads)},
                           os.path.join(out, f"grads{rank}.pt"))
            del grads
        before = {n: fn.launches for n, fn in wrappers.items()}
        dtype_before = dict(decode_by)
        mesh.reset_counts()
        trainer.run(k + 1)
        rec = trainer.history[-1]
        delta = {n: fn.launches - before[n] for n, fn in wrappers.items()}
        split = {str(dt): n - dtype_before[dt] for dt, n in decode_by.items()}
        want = {n: len(packed) if n in ("sign_pack", "vote_combine",
                                        "unpack_ternary") else 0
                for n in wrappers}
        if delta != want or split["torch.bfloat16"] != len(packed):
            fail(f"Z rank {rank} step {k}: launches {delta} ({split} by "
                 f"decode dtype), the layout models {want}, all bf16")
        if not np.isfinite(rec["loss"]):
            fail(f"Z rank {rank} step {k}: loss {rec['loss']}")
        res["loss"].append(rec["loss"])
        res["step_s"].append(rec["step_time_s"])
        res["traffic_ratio"] = rec["traffic_ratio"]
        res["launches"].append({n: d for n, d in delta.items() if d})
        res["calls"].append({
            name: (dict(g.calls_by_op), dict(g.bytes_by_op))
            for name, g in (("data", mesh.data_group),
                            ("model", mesh.model_group),
                            ("world", mesh.world))})
    # replicas: a replicated leaf on all four ranks, a block on both data
    # ranks that hold it
    bad = [p for p, x in T.flatten(model.tree()) if not _q_same_across(
        mesh.data_group if any(e is not None for e in specs[p])
        else mesh.world, x)]
    if bad:
        fail(f"Z rank {rank}: replicas differ on {bad}")
    res["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["kernel_launches"] = {n: fn.launches for n, fn in wrappers.items()}
    res["kernel_launches_bf16"] = decode_by[torch.bfloat16]
    del trainer, model, params, layout, st
    free()

    # Z.2: the seed's parameters, this rank's blocks
    whole = init_params(cfg, generator=torch.Generator(device="cuda")
                        .manual_seed(0), device="cuda")
    blocks = T.map_leaves(torch.Tensor.clone, shard_params(
        whole, cfg, mesh.extents, mesh.coords))
    del whole
    free()
    prompt = w_prompt(cfg)[:, :Z_PROMPT].cuda()
    routing = []
    res["decode"] = w_layout(mesh, cfg, blocks, W_BATCH, prompt, new=Z_NEW,
                             max_seq=Z_MAX_SEQ, routing=routing)
    res["decode"]["topi"] = routing
    res["decode"]["logits_sum"] = float(res["decode"]["logits"].sum())
    res["decode/f32"] = w_f32(mesh, cfg, blocks, W_BATCH, prompt,
                              max_seq=Z_MAX_SEQ)
    if rank:                    # the logits are replicated: keep rank 0's
        res["decode"].pop("logits")
        res.pop("decode/f32")
    res["decode_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def run_moe_mesh() -> dict:
    """Run Z: run Z's model (deepseek-moe-16b, 3 layers) on a (data 2) x
    (model 2) process mesh, four gloo ranks spawned on cuda:0 (the machine
    has one card), its 64 experts 32 a model rank.  Z.1: 2 gbin_packed
    steps with AdamW and ZeRO-1, one 1024-token dispatch group a data
    rank; the step-0 gradients, loss and routing of data rank 0's ranks
    against the unsharded model on the same parameters and batch, in this
    process.  Z.2: a batched decode (W_BATCH rows, Z_PROMPT-token prompts,
    Z_NEW greedy tokens, bf16 cache) against the one-device step
    teacher-forced on the same tokens, and a float32 pass."""
    import dataclasses

    from repro_torch.core import tree as T

    t_run = time.perf_counter()
    card = card_line()
    world = Z_MESH[0] * Z_MESH[1]
    ranks, grads, spawn_s = spawn_ranks(
        "--run-z-rank", world,
        extra=lambda out: {r: torch.load(os.path.join(out, f"grads{r}.pt"))
                           for r in range(Z_MESH[1])})
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        if res["loss"] != r0["loss"]:
            fail(f"Z: rank {r}'s losses {res['loss']}, rank 0's "
                 f"{r0['loss']}")
        if res["traffic_ratio"] != Z_TRAFFIC_RATIO:
            fail(f"Z: rank {r}'s traffic ratio {res['traffic_ratio']!r}, "
                 f"the unsharded Fabric's {Z_TRAFFIC_RATIO!r}")
        if 2 * res["moment_bytes"] != res["whole_moment_bytes"]:
            fail(f"Z: rank {r}'s ZeRO-1 moments {res['moment_bytes']} B, "
                 f"not half of {res['whole_moment_bytes']} B")
        # the routing is computed whole on every model rank of a data rank
        peer = ranks[r - r % Z_MESH[1]]
        if any(not torch.equal(a, b) for a, b in zip(res["topi"],
                                                     peer["topi"])):
            fail(f"Z: rank {r}'s expert choices differ from its model "
                 f"group's rank 0")
    if r0["experts"] != ["layers/moe/w_down", "layers/moe/w_gate",
                         "layers/moe/w_up"]:
        fail(f"Z: expert-parallel leaves {r0['experts']}")
    cfg = z_config()
    routing = []
    mean, errs, worst, model = unsharded_yardstick(
        "Z", cfg, z_data(cfg).batch_at(0), grads, Z_MESH, Z_SHARD,
        routing=routing)
    del grads
    moe_layers = cfg.num_layers - cfg.moe.first_dense
    one_topi = routing[:moe_layers]
    flips = sum(int((a != b).sum()) for a, b in zip(r0["topi"], one_topi))
    moved = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                for a, b in zip(r0["topi"], one_topi))
    choices = sum(a.numel() for a in one_topi)
    loss_err = abs(r0["loss"][0] - mean) / abs(mean)
    if loss_err > Q_LOSS_RTOL:
        fail(f"Z: step-0 loss {r0['loss'][0]} against the unsharded "
             f"{mean} (relative {loss_err})")

    # Z.2 against the one-device step on the same (seed) parameters
    got = r0["decode"]
    if not all(r["decode"]["finite"] for r in ranks):
        fail("Z.2: non-finite logits")
    if len({r["decode"]["logits_sum"] for r in ranks}) != 1 or any(
            not torch.equal(r["decode"]["tokens"], got["tokens"])
            for r in ranks):
        fail("Z.2: the ranks' logits or tokens differ")
    prompt = w_prompt(cfg)[:W_BATCH, :Z_PROMPT].cuda()
    params = model.tree()
    with record_routing() as picks:
        one = one_device_logits(cfg, params, prompt, got["tokens"],
                                Z_MAX_SEQ)
    # a near-tie that bf16 flips: each step's expert sets of each row at
    # each MoE layer, mesh against one device.  Where a step flips one,
    # the two decodes part by a discrete choice at that position: its
    # logits are counted and printed, and every other position's held
    # (a flip reaches a later position only through one cached position
    # of the last MoE layer's attention, of at least Z_PROMPT)
    sets = [torch.stack(t).reshape(-1, moe_layers, W_BATCH, cfg.moe.top_k)
            .sort(-1)[0] for t in (got["topi"], picks)]
    flip = (sets[0] != sets[1]).any(-1).any(1)              # (steps, B)
    flip_tokens = int((sets[0] != sets[1]).any(-1).sum())
    held = ~flip[Z_PROMPT - 1:, :, None].expand_as(one)
    held_share = float(held[..., 0].float().mean())
    if flip_tokens > Z_FLIPS_MAX or held_share < Z_HELD_MIN:
        fail(f"Z.2: {flip_tokens} expert sets flipped (at most "
             f"{Z_FLIPS_MAX}), {held_share:.3f} of the (position, row)s "
             f"held (at least {Z_HELD_MIN})")
    err = float((got["logits"] - one)[held].abs().max())
    big = float(one.abs().max())
    flipped_err = float((got["logits"] - one).abs().max())
    greedy = one[:-1].argmax(-1).T
    if not err <= W_TOL * big:
        fail(f"Z.2: the mesh's logits {err} from the one-device step's "
             f"where no expert choice flipped, over {W_TOL} of the "
             f"largest {big}")
    # float32: every position held, every expert choice equal
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = T.map_leaves(lambda t: t.detach().to(torch.float32), params)
    f32 = r0["decode/f32"]
    with record_routing() as picks32:
        one32 = one_device_logits(cfg32, p32, prompt[:, :W_F32_TOKENS],
                                  f32["tokens"], Z_MAX_SEQ,
                                  dtype=torch.float32)
    del p32, params, model
    free()
    mesh32 = f32["logits"][W_F32_TOKENS - 1:]
    err32 = float((mesh32 - one32).abs().max())
    big32 = float(one32.abs().max())
    same32 = torch.equal(one32[:-1].argmax(-1).T, f32["tokens"])
    flips32 = sum(int((a != b).sum()) for a, b in zip(f32["topi"], picks32))
    if len(f32["topi"]) != len(picks32) or flips32:
        fail(f"Z.2 float32: {flips32} expert choices differ from the "
             f"one-device step's ({len(f32['topi'])} and {len(picks32)} "
             f"MoE calls)")
    if not (err32 <= W_TOL32 * big32 and same32):
        fail(f"Z.2 float32: the mesh's logits {err32} from the one-device "
             f"step's (bound {W_TOL32} of {big32}), greedy tokens equal "
             f"{same32}")
    run_s = time.perf_counter() - t_run
    print(f"[Z moe-mesh] {card}: {world} gloo ranks on cuda:0 (one card) as "
          f"(data, model) = {Z_MESH}, {cfg.name} cut to {cfg.num_layers} "
          f"layers ({r0['params_local']} parameters a rank; experts "
          f"{cfg.moe.num_experts // Z_MESH[1]} a model rank on "
          f"{r0['experts']}), gbin_packed, AdamW with ZeRO-1, "
          f"{Z_MESH[0]} x {Z_SHARD} x {Z_SEQ} tokens", flush=True)
    print(f"[Z moe-mesh] per-leaf (tensor-parallel) low-bit leaves "
          f"{r0['unfused']}; buckets {r0['buckets']}", flush=True)
    print(f"[Z moe-mesh] losses {r0['loss']} (the unsharded model's step-0 "
          f"loss {mean:.6f}, relative {loss_err:.3e}); traffic ratio "
          f"{r0['traffic_ratio']} (the unsharded Fabric's)", flush=True)
    print(f"[Z moe-mesh] step seconds by rank "
          f"{[res['step_s'] for res in ranks]}; init seconds "
          f"{[round(res['init_s'], 2) for res in ranks]}; peak memory by "
          f"rank (GiB) train {[round(r['train_peak_gib'], 2) for r in ranks]}"
          f", decode {[round(r['decode_peak_gib'], 2) for r in ranks]}; "
          f"ZeRO-1 moments {r0['moment_bytes']} B of "
          f"{r0['whole_moment_bytes']} B", flush=True)
    print(f"[Z moe-mesh] launches a step by kernel (rank 0) "
          f"{r0['launches']}, every decode bf16", flush=True)
    for k, calls in enumerate(r0["calls"]):
        print(f"[Z moe-mesh] step {k} collectives of rank 0 (calls, bytes) "
              f"by group: {calls}", flush=True)
    print(f"[Z moe-mesh] step-0 gradient blocks within {Q_GRAD_NOISE}x the "
          f"bf16 noise (relative L2 distance from the float32 gradient, "
          f"expert-parallel against unsharded bf16: "
          f"{ {p: (round(a, 5), round(b, 5)) for p, (a, b) in errs.items()} }"
          f"; the largest ratio {worst}); replicated leaves bit-equal on "
          f"all ranks and blocks on both data ranks after the last step; "
          f"routing of the step-0 forward (data rank 0, {moe_layers} MoE "
          f"layers): {flips} of {choices} top-k choices differ from the "
          f"unsharded model's, {moved} tokens' expert sets", flush=True)
    ms = got["step_ms"]
    print(f"[Z.2 moe-mesh decode] {card}: batch {W_BATCH}, a local cache "
          f"block {got['local_k']}; {Z_PROMPT}-token prompts, {Z_NEW} "
          f"greedy tokens; decode step ms median {float(np.median(ms)):.3f} "
          f"(range {min(ms):.3f}-{max(ms):.3f}); prefill "
          f"{got['prefill_s']:.3f} s a prompt; {got['launch_calls']} kernel "
          f"launch calls in one decode step on rank 0; one step's "
          f"collectives on rank 0, (calls, bytes) by group: {got['calls']}",
          flush=True)
    print(f"[Z.2 moe-mesh decode] against the one-device step teacher-forced "
          f"on the same {Z_PROMPT + Z_NEW} tokens: bf16 within {err!r} "
          f"(largest logit {big!r}; {err / big:.3e} of it, bound {W_TOL}) "
          f"at the {int(held[..., 0].sum())} of {held[..., 0].numel()} "
          f"(position, row)s whose step flipped no expert choice; "
          f"{flip_tokens} of {flip.numel() * moe_layers} (token, MoE layer) "
          f"expert sets flipped by bf16 near-ties, {flipped_err!r} at "
          f"most where one had; float32 ({2 * W_F32_TOKENS} tokens, a "
          f"float32 cache) within {err32!r} ({err32 / big32:.3e} of "
          f"{big32!r}, bound {W_TOL32}), its greedy tokens and all "
          f"{sum(a.numel() for a in picks32)} expert choices equal; bf16 "
          f"greedy tokens equal: "
          f"{torch.equal(greedy, got['tokens'])}", flush=True)
    print(f"[Z moe-mesh] spawn {spawn_s:.2f} s, run Z {run_s:.2f} s",
          flush=True)
    launches = dict(r0["kernel_launches"])
    launches["unpack_ternary_bf16"] = r0["kernel_launches_bf16"]
    launches["unpack_ternary"] -= r0["kernel_launches_bf16"]
    return {"launches": launches}


# ---------------------------------------------------------------------------
# phase 18: the launch tooling
# ---------------------------------------------------------------------------

#: the dry-run's peak bytes over a real rank's max_memory_allocated in the
#: same step (run Q's train step, run W's batched decode step): the band
#: PERF.md states for it
Y_PEAK_BAND = (0.8, 1.25)
#: Y.1's two dry-run commands and the processes each traces cells in:
#: they start with the script (CPU work on ``meta`` tensors beside the
#: card's runs) and phase Y reads them
Y_CLI = {"qwen3": (["--arch", "qwen3_0p6b", "--shape", "all", "--mesh",
                    "both", "--plans", "gbin_packed"], 4),
         "every": (["--arch", "all", "--shape", "decode_32k", "--mesh",
                    "single"], 2)}


def y_cells():
    """Run Q's train cell (4 x 128 tokens a data rank) and run W's
    batched decode cell (batch 4, 256 positions) as dry-run cells."""
    from repro_torch.models import ShapeCell
    return (ShapeCell("run_q", 128, Q_MESH[0] * Q_SHARD, "train"),
            ShapeCell("run_w", W_MAX_SEQ, W_BATCH, "decode"))


def y_optimizer():
    from repro_torch.optim import AdamW
    return AdamW(peak_lr=3e-4, warmup_steps=2, total_steps=Q_STEPS)


def run_y_rank(rank: int, out: str) -> None:
    """One rank of run Y.2: run Q's Trainer (full qwen3-0.6B, (data 2) x
    (model 2), gbin_packed, AdamW with ZeRO-1) and run W's batched decode
    step (bf16 cache, ``donate=False`` as the dry-run's), each built by
    the dry-run's own builders: an untimed step, a step under
    ``FlopCounterMode`` (collectives, launches and peak memory read
    around it), then a timed step."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core import ProcessMesh
    from repro_torch.core import tree as T
    from repro_torch.kernels import kernel_wrappers
    from repro_torch.launch import dryrun
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.transformer import shard_params
    from repro_torch.runtime.serve import build_serve_step

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=Q_MESH[0] * Q_MESH[1],
                            timeout=timedelta(seconds=120))
    mesh = ProcessMesh(Q_MESH, device="cuda:0")
    cfg = q_config()
    groups = dryrun.mesh_groups(mesh)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    decode_by = wrappers["unpack_ternary"].launches_by_dtype
    res = {}

    def measure(name, fn, *args):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {n: f.launches for n, f in wrappers.items()}
        mesh.reset_counts()
        with FlopCounterMode(display=False) as fc:
            got = fn(*args)
        torch.cuda.synchronize()
        res[name] = {
            "flops": fc.get_total_flops(),
            "peak": torch.cuda.max_memory_allocated(),
            "launches": {n: f.launches - before[n]
                         for n, f in wrappers.items()
                         if f.launches != before[n]},
            "calls": {n: {"calls": dict(g.calls_by_op),
                          "bytes": dict(g.bytes_by_op)}
                      for n, g in groups.items()}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        res[name]["step_s"] = time.perf_counter() - t0
        return got

    trainer, step = dryrun.train_step(cfg, mesh, "gbin_packed",
                                      y_optimizer(), device="cuda:0")
    batch = {n: torch.as_tensor(v).cuda()
             for n, v in q_data(cfg).batch_at(0).items()}
    trainer.state = step(trainer.state, batch)[0]     # untimed
    state, metrics, agg = measure("train", step, trainer.state, batch)
    res["train"]["loss"] = float(metrics["loss"])
    del state, metrics, agg, trainer, step, batch
    free()

    whole = init_params(cfg, generator=torch.Generator(device="cuda")
                        .manual_seed(0), device="cuda")
    params = T.map_leaves(torch.Tensor.clone, shard_params(
        whole, cfg, mesh.extents, mesh.coords))
    del whole
    free()
    dstep, _ = build_serve_step(cfg, mesh, batch=W_BATCH, max_seq=W_MAX_SEQ,
                                dp_axes=mesh.data_axes, donate=False)
    cache = init_cache(cfg, W_BATCH, W_MAX_SEQ, device="cuda", mesh=mesh,
                       dp_axes=mesh.data_axes)
    token = w_prompt(cfg)[:, :1].to(torch.int32).cuda()
    dstep(params, token, cache, W_MAX_SEQ - 1)          # untimed
    logits, _ = measure("decode", dstep, params, token, cache,
                        W_MAX_SEQ - 1)
    res["decode"]["finite"] = bool(torch.isfinite(logits).all())
    res["kernel_launches"] = {n: fn.launches for n, fn in wrappers.items()}
    res["kernel_launches_bf16"] = decode_by[torch.bfloat16]
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def y_trace() -> dict:
    """Y.2's dry-run side, in this process: run Q's train cell and run
    W's decode cell traced as rank 0 of a fake (2, 2) mesh."""
    from repro_torch.core import ProcessMesh
    from repro_torch.launch import dryrun

    cfg = q_config()
    train_cell, decode_cell = y_cells()
    with dryrun.fake_world(Q_MESH[0] * Q_MESH[1]):
        mesh = ProcessMesh(Q_MESH, device="meta")
        return {"train": dryrun.run_train_cell(cfg, train_cell, mesh,
                                               "gbin_packed",
                                               optimizer=y_optimizer()),
                "decode": dryrun.run_decode_cell(cfg, decode_cell, mesh)}


def y_check_cli(out: str) -> None:
    """Y.1's checks on the dry-run's JSONs, and its report."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import report
    from repro_torch.models import SHAPES
    from repro_torch.models.transformer import TP_FAMILIES

    def load(run, mesh, arch, name):
        with open(os.path.join(out, run, mesh, arch, name)) as f:
            return json.load(f)

    for mesh, n in (("pod_16x16", 256), ("multipod_2x16x16", 512)):
        for cell in SHAPES:
            tag = "gbin_packed" if cell.is_train else cell.kind
            d = load("qwen3", mesh, "qwen3_0p6b", f"{cell.name}.{tag}.json")
            if cell.name == "long_500k":
                if "skipped" not in d:
                    fail(f"Y.1 {mesh} qwen3 long_500k not skipped: {d}")
                continue
            if ("error" in d or d["num_devices"] != n
                    or not d["flops_per_device"] > 0
                    or d["roofline"]["dominant"] not in
                    ("compute", "memory", "collective")):
                fail(f"Y.1 {mesh} qwen3 {cell.name}: "
                     f"{d.get('error') or {k: d[k] for k in ('num_devices', 'flops_per_device', 'roofline')}}")
            if cell.is_train and (n == 512) != (
                    d["collectives"]["pod_crossing_wire_bytes"] > 0):
                fail(f"Y.1 {mesh} qwen3 train: pod-crossing wire bytes "
                     f"{d['collectives']['pod_crossing_wire_bytes']}")
    failed, want = {}, set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        d = load("every", "pod_16x16", arch, "decode_32k.decode.json")
        if "error" in d:
            failed[arch] = d["error"]
        elif d["num_devices"] != 256 or not d["flops_per_device"] > 0:
            fail(f"Y.1 {arch} decode_32k: {d}")
        # the families whose tensor parallelism is still to port (the
        # MoE experts, the VLM and query columns that cut a head trace)
        if cfg.family not in TP_FAMILIES:
            want.add(arch)
    if set(failed) != want or not all(
            e.startswith("NotImplementedError: ") for e in failed.values()):
        fail(f"Y.1 decode_32k failures {failed}, expected on {sorted(want)}")
    cells = report.load_cells(os.path.join(out, "qwen3")) + [
        c for c in report.load_cells(os.path.join(out, "every"))
        if c["arch"] != "qwen3_0p6b"]
    for mesh in ("pod_16x16", "multipod_2x16x16"):
        print(f"[Y dryrun] report {mesh}:\n"
              f"{report.fmt_table(cells, mesh)}", flush=True)
    for arch, e in failed.items():
        print(f"[Y dryrun] {arch} decode_32k on 16 x 16: {e}", flush=True)


def start_y_cli() -> dict:
    """Start Y.1's dry-run commands in the background, each leading a
    process group of its own (its cell processes in it), which is killed
    when this script ends."""
    import shutil
    import signal
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PYTHONWARNINGS="ignore")
    procs = {}
    for name, (args, jobs) in Y_CLI.items():
        with open(os.path.join(out, f"{name}.log"), "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
                 os.path.join(out, name), "--force", "--jobs", str(jobs),
                 *args], env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True)

    def stop():
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(out, ignore_errors=True)

    atexit.register(stop)
    return {"out": out, "procs": procs, "t0": time.perf_counter(),
            "stop": stop}


def run_launch_tooling(cli: dict | None = None) -> dict:
    """Run Y: the launch dry-run.  Y.1 (started with the script by
    :func:`start_y_cli`, or here) runs its CLI on full qwen3-0.6B's cells
    on both production meshes (256 and 512 ranks) and ``decode_32k`` of
    every architecture on 16 x 16.  Y.2: four gloo ranks on cuda:0
    (``chip_smoke.py --run-y-rank r dir``) run run Q's train step and run
    W's decode step, which the dry-run's trace of the same cells on a
    fake (2, 2) mesh must equal: collective calls and bytes by group and
    op, FLOPs and kernel calls; its peak within Y_PEAK_BAND of the
    rank's and its roofline bound no longer than the measured step."""
    card = card_line()
    cli = cli or start_y_cli()
    out = cli["out"]
    try:
        ranks, _, spawn_s = spawn_ranks("--run-y-rank",
                                        Q_MESH[0] * Q_MESH[1])
        t1 = time.perf_counter()
        got = y_trace()
        trace_s = time.perf_counter() - t1
        for name, p in cli["procs"].items():
            p.wait(timeout=900)
            with open(os.path.join(out, f"{name}.log")) as f:
                text = f.read()
            if p.returncode != (0 if name == "qwen3" else 1):
                print(text[-6000:], flush=True)
                fail(f"Y.1 {name} dry-run: exit {p.returncode} (the "
                     f"families without tensor parallelism fail 'every')")
            for line in text.splitlines():
                if line.startswith(("[pod", "[multi")):
                    print(f"[Y dryrun] {line}", flush=True)
        cli_s = time.perf_counter() - cli["t0"]
        waited_s = time.perf_counter() - t1 - trace_s
        y_check_cli(out)
    finally:
        cli["stop"]()

    r0 = ranks[0]
    for name in ("train", "decode"):
        g, real = got[name], r0[name]
        if "error" in g:
            fail(f"Y.2 {name} trace: {g['error']}\n{g['traceback']}")
        launches = {n: k["launches"] for n, k in g["kernels"].items()}
        ratio = g["memory"]["peak_estimate_bytes"] / real["peak"]
        bound = g["roofline"]["step_time_lower_bound_s"]
        print(f"[Y {name}] {card}: dry-run on a fake (2, 2) mesh against "
              f"rank 0 of four gloo ranks on cuda:0: flops "
              f"{g['flops_per_device']:.0f} / {real['flops']}; kernel "
              f"calls {launches} / launches {real['launches']}; "
              f"collectives by group {g['collectives']['by_group']}; peak "
              f"{g['memory']['peak_estimate_bytes']} B (arguments "
              f"{g['memory']['argument_bytes']} B) / max_memory_allocated "
              f"{real['peak']} B, ratio {ratio:.4f}; roofline bound "
              f"{bound * 1e3:.4f} ms ({g['roofline']['dominant']}; compute "
              f"{g['roofline']['compute_s'] * 1e3:.4f}, memory "
              f"{g['roofline']['memory_s'] * 1e3:.4f}, collective "
              f"{g['roofline']['collective_s'] * 1e3:.4f} ms) against the "
              f"measured step {real['step_s'] * 1e3:.2f} ms (rank 0; by "
              f"rank {[round(r[name]['step_s'] * 1e3, 2) for r in ranks]}); "
              f"HBM bytes {g['hbm_bytes_per_device']:.0f}, wire bytes "
              f"{g['collectives']['total_wire_bytes']:.0f}; traced in "
              f"{g['compile_s']:.2f} s", flush=True)
        if g["collectives"]["by_group"] != real["calls"]:
            fail(f"Y.2 {name}: collectives by group {real['calls']} on the "
                 f"card, {g['collectives']['by_group']} in the dry-run")
        if g["flops_per_device"] != real["flops"]:
            fail(f"Y.2 {name}: flops {real['flops']} on the card, "
                 f"{g['flops_per_device']} in the dry-run")
        if launches != real["launches"]:
            fail(f"Y.2 {name}: launches {real['launches']} on the card, "
                 f"kernel calls {launches} in the dry-run")
        if not Y_PEAK_BAND[0] <= ratio <= Y_PEAK_BAND[1]:
            fail(f"Y.2 {name}: peak ratio {ratio} outside {Y_PEAK_BAND}")
        if real["step_s"] < bound:
            fail(f"Y.2 {name}: measured step {real['step_s']} s under the "
                 f"roofline bound {bound} s")
    want = {"sign_pack", "vote_combine", "unpack_ternary"}
    if set(r0["train"]["launches"]) != want:
        fail(f"Y.2 train launches {r0['train']['launches']}, not {want}")
    if not (np.isfinite(r0["train"]["loss"]) and r0["decode"]["finite"]):
        fail(f"Y.2: loss {r0['train']['loss']}, decode logits finite "
             f"{r0['decode']['finite']}")
    if any(r["train"]["loss"] != r0["train"]["loss"] for r in ranks):
        fail(f"Y.2: losses by rank {[r['train']['loss'] for r in ranks]}")
    print(f"[Y dryrun] {card}: Y.2's spawn {spawn_s:.2f} s and the (2, 2) "
          f"traces {trace_s:.2f} s; Y.1's commands, started "
          f"{cli_s:.2f} s before, had ended {waited_s:.2f} s after "
          f"(the time phase Y waited for them); peak by "
          f"rank (GiB) train "
          f"{[round(r['train']['peak'] / 2 ** 30, 3) for r in ranks]}, "
          f"decode {[round(r['decode']['peak'] / 2 ** 30, 3) for r in ranks]}",
          flush=True)
    launches = dict(r0["kernel_launches"])
    launches["unpack_ternary_bf16"] = r0["kernel_launches_bf16"]
    launches["unpack_ternary"] -= r0["kernel_launches_bf16"]
    return {"launches": launches}


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
    y_cli = start_y_cli()       # CPU work: phase Y reads it

    rows = check_kernels()
    # timed with the checks' memory still cached, as the training path
    # runs: for tens of ms after empty_cache() returns their ~29 GiB,
    # every memory-bound kernel on the H100 runs 6-16% slower, PyTorch's
    # copy and fill too
    rows.update(time_slice3_kernels(torch.Generator(device="cuda")
                                    .manual_seed(1)))
    time_embed_bucket(torch.Generator(device="cuda").manual_seed(2))
    print("kernel checks: byte-equal to the plain twins", flush=True)
    free()
    launches = dict.fromkeys(rows, 0)
    runs = (run_gbin_packed, run_per_leaf_ef, run_staged,
            lambda: run_mean_codec("C int4", "int4_backbone", "int4_quant"),
            lambda: run_mean_codec("D top-k", "topk_backbone",
                                   "threshold_mask"),
            run_host_local, run_paper_controller, run_grad_accum,
            run_harness)
    for fn in runs:
        run = fn()
        for k, v in run.pop("launches").items():
            launches[k] += v
        del run
        free()

    import torch.distributed as dist
    group = nccl_group()
    try:
        for fn in (run_nccl, run_restore_replay):
            run = fn(group)
            for k, v in run.pop("launches").items():
                launches[k] += v
            del run
            free()
    finally:
        dist.destroy_process_group()
    run_gloo_on_card()
    free()
    for fn in (check_blocked_attention, run_gemma_4k, run_deepseek_moe,
               run_xlstm, run_hymba, run_whisper, run_tp_on_card,
               run_hier, run_tuned, run_serve, run_decode, run_elastic,
               run_straggler, run_serve_mesh, run_examples, run_moe_mesh,
               lambda: run_launch_tooling(y_cli)):
        run = fn()
        for k, v in run.pop("launches").items():
            launches[k] += v
        del run
        free()

    kernels = [{"name": name, "route": "cuda", "source": row["source"],
                "replaces": row["replaces"], "launches": launches[name],
                "max_abs_err": row["err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"]}
               for name, row in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run-k-rank"]:
        run_k_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--run-q-rank"]:
        run_q_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--run-w-rank"]:
        run_w_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--run-z-rank"]:
        run_z_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--run-y-rank"]:
        run_y_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--run-x-rank"]:
        run_x_rank(sys.argv[2], sys.argv[3], sys.argv[4:])
    else:
        main()
