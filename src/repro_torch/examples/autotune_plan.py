"""Autotune: compile the best codec/schedule/bucket plan for a model
and topology offline, inspect the decision record, and install the
winner as a named preset — no devices needed (``meta`` shapes + the
discrete-event simulator).

Port of ``examples/autotune_plan.py``.  Run:

  PYTHONPATH=src python -m repro_torch.examples.autotune_plan --device cpu

``--out`` names the artifact's file (the temporary directory's
``tuned_plan.json`` by default).
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.fabric import Fabric
from repro_torch.fabric.control import plan_presets, unregister_plan_preset
from repro_torch.models import init_params
from repro_torch.tune import MaxLowbitFraction, PinGroup, default_space


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="accepted for symmetry: the tuner reads shapes "
                         "only and runs no device work")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "tuned_plan.json"))
    args = ap.parse_args(argv)

    # A mesh-free session prices plans for any fleet size: the tuner
    # only reads shapes/dtypes and the analytic + DES models.
    fabric = Fabric(num_workers=32)

    cfg = get_config("qwen3_0p6b", smoke=True)
    params = init_params(cfg, device="meta")

    # The default space: every plan_presets() entry as an always-
    # sim-scored seed, plus generated low-bit backbone/embed axes over
    # two bucket budgets — with the paper's guardrail (classifier head
    # pinned to FP32) as an admission constraint.  Tighten it further:
    # cap the low-bit fraction so norms/head/embeddings stay FP32-heavy.
    space = default_space(
        constraints=(PinGroup("head"), MaxLowbitFraction(0.95)))

    for topology in ("ici_ring", "multihop"):
        tuned = fabric.autotune(params, space, topology=topology,
                                strategy="successive_halving")
        s = tuned.summary()
        print(f"[{topology}] winner: {s['plan_signature']}")
        print(f"  step={s['step_time_s'] * 1e6:.1f}us "
              f"wire={s['wire_bytes'] / 1e6:.2f}MB/device "
              f"exposed={s['exposed_pct']:.2f}% "
              f"bucket={s['bucket_bytes'] // 2**20}MiB")
        print(f"  searched {tuned.provenance['candidates']['enumerated']} "
              f"candidates, sim-certified "
              f"{tuned.provenance['candidates']['sim_scored']}")
        for r in tuned.runners_up[:3]:
            if r.score is not None:
                print(f"  runner-up {r.name}: "
                      f"{r.score.step_time_s * 1e6:.1f}us")

    # The artifact is a reproducible JSON record ...
    path = tuned.save(args.out)
    print(f"artifact: {path}")

    # ... that installs back into the preset table by name, where the
    # launcher (--plan tuned_demo) and StaticController resolve it like
    # any built-in.
    name = tuned.install("tuned_demo")
    assert plan_presets()[name].signature() == tuned.plan.signature()
    print(f"installed as plan preset {name!r}")
    unregister_plan_preset(name)

    # At train time, close the sim-to-reality loop through the standard
    # controller seam: fabric.attach_controller("tuned", tuned=tuned)
    # latches the winner and re-ranks the sim-certified shortlist if
    # live step times drift off the prediction.
    return tuned


if __name__ == "__main__":
    main()
