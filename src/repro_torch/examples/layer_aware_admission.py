"""Paper Section 7 end-to-end: the convergence boundary and its recovery.

Reproduces (on synthetic tasks) the paper's central result chain:
  1. easy workload: full-path low-bit aggregation stays near FP32;
  2. hard fine-grained workload: full-path low-bit collapses;
  3. cosine diagnostics localize the sensitive group;
  4. layer-aware admission (low-bit backbone + FP32 head) recovers the
     accuracy at a fraction of the gradient traffic;
  5. the same operating point expressed as a user-defined
     :class:`repro_torch.fabric.control.PolicyProgram` phase schedule
     ("everything low-bit, head back on FP32 after step N").

Port of ``examples/layer_aware_admission.py``.  Run:

  PYTHONPATH=src python -m repro_torch.examples.layer_aware_admission \\
      --device cpu [--fast]
"""
import argparse

from repro_torch.core.experiments import easy_task, hard_task, run_training
from repro_torch.fabric.control import PolicyProgram


def main(argv=None, *, steps=(300, 700), fast_steps=(150, 300)):
    """``steps`` / ``fast_steps``: the (easy, hard) runs' lengths."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps_e, steps_h = fast_steps if args.fast else steps
    dev = args.device
    # the diagnostics are read at the end of the FP32 warm-up (step 49),
    # or at the last step of a shorter run
    diagnose_at = min(49, steps_h - 1)

    et, ht = easy_task(), hard_task()
    print("== 1. easy workload (validated regime) ==")
    for pol, lr in (("fp32", None), ("gbinary", 5e-4)):
        r = run_training(et, policy=pol, steps=steps_e, batch=256, lr=lr,
                         device=dev)
        print(f"  {pol:8s} acc={r.final_acc:.3f} "
              f"traffic={r.traffic_ratio:.3f}")

    print("== 2. hard workload: the boundary ==")
    r_fp = run_training(ht, policy="fp32", steps=steps_h, batch=64,
                        device=dev)
    r_lb = run_training(ht, policy="gbinary", steps=steps_h, batch=64,
                        lr=2e-4, diagnose_at=diagnose_at, device=dev)
    print(f"  fp32     acc={r_fp.final_acc:.3f}")
    print(f"  gbinary  acc={r_lb.final_acc:.3f}  "
          f"(gap: {100*(r_fp.final_acc - r_lb.final_acc):.1f} pts)")

    print("== 3. diagnostics (end of FP32 warm-up) ==")
    c = r_lb.cosines
    print(f"  backbone cos(gbinary, fp32) = {c['backbone']['gbinary']:.3f}")
    print(f"  head     cos(gbinary, fp32) = {c['head']['gbinary']:.3f}")

    print("== 4. layer-aware admission: low-bit backbone + FP32 head ==")
    r_mix = run_training(ht, policy="gbinary", head_policy="fp32",
                         steps=steps_h, batch=64, lr=2e-4, device=dev)
    print(f"  mixed    acc={r_mix.final_acc:.3f} "
          f"traffic={r_mix.traffic_ratio:.3f} "
          f"(recovers {100*(r_mix.final_acc - r_lb.final_acc):.1f} pts)")

    print("== 5. the same policy as a declarative phase program ==")
    # warm-up on FP32, admit everything to G-Binary, then pull the head
    # back to FP32 mid-run — a user-defined phase schedule, no custom
    # control-loop code
    program = PolicyProgram.staged([
        ("warmup", ("fp32", "fp32"), 50),
        ("all_lowbit", ("gbinary", "gbinary"), steps_h // 2),
        ("head_fp32", ("gbinary", "fp32"), None)])
    r_prog = run_training(ht, policy="gbinary", head_policy="fp32",
                          steps=steps_h, batch=64, lr=2e-4, program=program,
                          device=dev)
    print(f"  staged   acc={r_prog.final_acc:.3f} "
          f"phases={[e.kind for e in program.events]}")
    return r_prog


if __name__ == "__main__":
    main()
