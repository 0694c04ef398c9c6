"""Batched serving example: decode with the production sharding.

Decodes a batch of sequences with the KV cache sharded (the batch over
the data ranks, the cache's sequence over the model ranks, the heads,
MLP and vocabulary over the model ranks) — the layout of the
decode_32k cell — on a (data 4) x (model 2) process mesh.

Port of ``examples/serve_lm.py``.  Run:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \\
      -m repro_torch.examples.serve_lm --device cpu
"""
import argparse
import time

from repro_torch.examples import init_mesh, lead

BATCH, MAX_SEQ, DECODE_TOKENS = 8, 64, 24


def main(argv=None, *, batch: int = BATCH, max_seq: int = MAX_SEQ,
         decode_tokens: int = DECODE_TOKENS):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tokens", type=int, default=decode_tokens)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.transformer import shard_params
    from repro_torch.runtime import build_serve_step

    mesh, device = init_mesh((4, 2), args.device)
    cfg = get_config("qwen3_0p6b", smoke=True)
    try:
        whole = init_params(cfg, generator=torch.Generator(
            device=device).manual_seed(0), device=device)
        step, sh = build_serve_step(cfg, mesh, batch=batch, max_seq=max_seq,
                                    dp_axes=("data",))
        # this rank's blocks of sh["params"]
        params = T.map_leaves(torch.Tensor.clone, shard_params(
            whole, cfg, mesh.extents, mesh.coords))
        del whole
        cache = init_cache(cfg, batch, max_seq, device=device, mesh=mesh)
        # every rank draws the same first tokens
        tok = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (batch, 1))).to(device)

        outs = []
        t0 = time.perf_counter()
        for t in range(args.tokens):
            logits, cache = step(params, tok, cache, t)
            tok = torch.argmax(logits, -1)[:, None]
            outs.append(tok[:, 0].cpu().numpy())
        dt = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()

    gen = np.stack(outs, 1)
    if lead():
        print(f"decoded {args.tokens} tokens x {batch} seqs in {dt:.2f}s "
              f"({batch * args.tokens / dt:.1f} tok/s on {device.type})")
        print("first sequence:", gen[0][:16], "...")
    assert gen.shape == (batch, args.tokens)
    if lead():
        print("OK")
    return gen


if __name__ == "__main__":
    main()
