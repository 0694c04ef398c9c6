"""A benchmark root at CPU-test size: the real BENCHMARK.json, traffic
mixes and metric readers, with each configuration cut to the port's
SMOKE widths and the mixes to short rows."""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

HARNESS = Path(__file__).resolve().parent.parent
REPO = HARNESS.parent

#: the comparison's limits at this size in float32, from CPU runs of the
#: sound port (loss <= 5.4e-8, grad <= 9.7e-6, update <= 6.9e-5 over
#: four seeds and both families; no vote apart over seven seeds and
#: both voting mixes), of its faults (grad >= 0.11 and update >= 0.14
#: with half the batch or no exchange) and of the bfloat16 control
#: (0.0099 and 0.079 of the votes apart)
TINY_LIMITS = {"loss_gap": 1e-6, "grad_gap": 3e-4, "update_gap": 3e-4,
               "vote_gap": 1e-3}


def smoke_model(arch: str, dtype: str) -> dict:
    import sys
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    sm = get_config(arch, smoke=True)
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
            "vocab_size", "mlp_variant", "qkv_bias", "rope_theta",
            "tie_embeddings", "norm_eps", "remat")
    m = {k: getattr(sm, k) for k in keys}
    if sm.moe is not None:
        m["moe"] = dataclasses.asdict(sm.moe)
    m["dtype"] = dtype
    return m


def make_root(tmp: Path, seq_len: int = 32, dtype: str = "float32",
              limits: dict | None = TINY_LIMITS) -> Path:
    """A copy of the benchmark's data files under ``tmp`` at test size."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    h = tmp / HARNESS.name
    for d in ("configs", "traffic", "limits"):
        (h / d).mkdir(parents=True)
    shutil.copytree(HARNESS / "metrics", h / "metrics")
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["model"] = smoke_model(cfg["arch"], dtype)
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = json.loads((HARNESS / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        t["seq_len"] = seq_len
        (h / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        if limits is not None:
            (h / "limits" / f"{w['name']}.json").write_text(
                json.dumps(limits))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
