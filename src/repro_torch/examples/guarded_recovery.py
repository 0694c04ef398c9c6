"""Paper Section 8 (Fig 6): guarded-recovery pilot with live mode selection.

Drives the registered ``"paper"`` admission controller
(:mod:`repro_torch.fabric.control`) through its phase program:

    warmup --(warmup_steps)--> calibrate --(cosines)--> admitted
       admitted/readmitted --(CUSUM trigger)--> recovery
       recovery --(cooldown over)--> readmitted

Training starts on FP32; once warm-up ends and calibration cosines are
available the Commander admits G-Binary; a degradation window is
injected mid-run; the Supervisor's CUSUM guard recovers to FP32; and
after cooldown the mode is re-admitted.  Each step the pilot feeds the
controller one typed :class:`~repro_torch.fabric.control.Telemetry`
record and reads back the latched plan.  The trace prints every mode
transition.

Port of ``examples/guarded_recovery.py``.  Run:

  PYTHONPATH=src python -m repro_torch.examples.guarded_recovery --device cpu
"""
import argparse

from repro_torch.core.admission import Commander, CusumGuard, Supervisor
from repro_torch.core.experiments import hard_task, run_training
from repro_torch.fabric.control import Telemetry, make_controller


def main(argv=None, *, steps: int = 600):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    controller = make_controller(
        "paper",
        commander=Commander(tau_binary=0.2),
        supervisor=Supervisor(guard=CusumGuard(kappa=0.02, h=0.6),
                              cooldown_steps=60),
        warmup_steps=50)
    state = {"mode": ("fp32", "fp32"), "lowbit": 0, "total": 0}

    def callback(step, loss):
        plan = controller.observe(Telemetry(step=step, loss=loss, cosines={
            "backbone": {"gbinary": 0.8, "gternary": 0.7},
            "head": {"gbinary": 0.8, "gternary": 0.7}}))
        lowbit = "gbinary" in plan.signature()
        mode = ("gbinary", "gbinary") if lowbit else ("fp32", "fp32")
        state["total"] += 1
        state["lowbit"] += int(lowbit)
        if mode != state["mode"]:
            print(f"  step {step:4d}: mode -> {mode[0]}  (loss={loss:.3f})")
            state["mode"] = mode
        return mode

    print("guarded recovery pilot (degradation injected at steps 250-280):")
    r = run_training(hard_task(), policy="fp32", steps=steps, batch=64,
                     lr=2e-4, warmup_fp32=0, degrade=(250, 280),
                     plan_callback=callback, seed=0, device=args.device)

    frac = state["lowbit"] / state["total"]
    kinds = [e.kind for e in controller.events]
    print(f"\nfinal acc      : {r.final_acc:.3f}")
    print(f"low-bit steps  : {100*frac:.1f}%")
    print(f"control events : {kinds}")
    assert "recovery" in kinds, "guard never fired"
    assert "readmitted" in kinds, "never re-admitted"
    print("OK")
    return kinds


if __name__ == "__main__":
    main()
