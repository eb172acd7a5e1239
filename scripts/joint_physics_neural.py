"""Joint physics+neural training demo (round-2 VERDICT item 9).

Recovers perturbed component values (source R, capacitor C) AND fine-tunes
the neural diode root *in the same differentiable circuit* — a capability the
reference never combines (it trains either the neural root with frozen
components, ``clipper_pot.py:245-269``, or component values with an analytic
root, ``lpf.py:79-99``).

Protocol (synthetic ground truth, analytic 1N4148 root at R*=45 kOhm,
C*=4.7 nF):
  phase 1  components-only: R/C train (clip-constrained) against the
           measurement with the pretrained 2x16 root frozen -> R/C land
           within ~1 % of truth (physics is identifiable because the
           R-aware root keeps the diode law fixed while R moves).
  phase 2  joint fine-tune: R/C keep training while the root trains at a
           scale-separated lr (1e-6) -> loss drops below the frozen-root
           floor without un-identifying the components.

Writes runs/joint_fit/result.json and prints one JSON summary line.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--fs", type=float, default=16000.0)
    ap.add_argument("--duration", type=float, default=1.5)
    ap.add_argument("--epochs1", type=int, default=800)
    ap.add_argument("--epochs2", type=int, default=800)
    ap.add_argument("--out", default="runs/joint_fit/result.json")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import numpy as np

    import diffwdf as dwdf
    from diffwdf.data.synthetic import synth_clipper_measurement
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.nn.serialization import load_model_json
    from diffwdf.roots.neural import NeuralDiodeRoot
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig,
        joint_fit_clipper,
        make_clipper_batches,
    )

    R_TRUE, C_TRUE = 45e3, 4.7e-9
    R_INIT, C_INIT = 65e3, 3.2e-9  # +44 % / -32 % perturbation

    vin, vout = synth_clipper_measurement(
        dwdf.diode_1n4148_1u1d, R_TRUE, cap=C_TRUE,
        fs=args.fs, duration_s=args.duration,
    )
    mlp, acts, _ = load_model_json(
        "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"
    )
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    ckt = make_training_clipper(root, args.fs, r_source=R_INIT, cap=C_INIT)
    params = {**ckt.init_params(), **frag}

    cfg1 = CircuitTrainConfig(epochs=args.epochs1, batch_size=512,
                              skip_samples=50)
    batches = make_clipper_batches({"x": vin, "y": vout}, cfg1.batch_size)
    lrs = {"Vs.R": 1500.0, "C.C": 8e-11}

    # phase 1: components only (root frozen)
    params, h1 = joint_fit_clipper(ckt, params, batches, lrs, cfg1, mlp_lr=0.0)
    rec1 = {
        "R": float(params["Vs"]["R"]), "C": float(params["C"]["C"]),
        "R_err_pct": 100 * abs(float(params["Vs"]["R"]) - R_TRUE) / R_TRUE,
        "C_err_pct": 100 * abs(float(params["C"]["C"]) - C_TRUE) / C_TRUE,
        "loss": h1["loss"][-1],
    }

    # phase 2: joint fine-tune (root co-trains, scale-separated lr)
    cfg2 = CircuitTrainConfig(epochs=args.epochs2, batch_size=512,
                              skip_samples=50)
    params, h2 = joint_fit_clipper(ckt, params, batches, lrs, cfg2,
                                   mlp_lr=1e-6)
    d_w0 = float(np.max(np.abs(
        np.asarray(params["dp"]["layers"][0]["kernel"])
        - np.asarray(frag["dp"]["layers"][0]["kernel"])
    )))
    rec2 = {
        "R": float(params["Vs"]["R"]), "C": float(params["C"]["C"]),
        "R_err_pct": 100 * abs(float(params["Vs"]["R"]) - R_TRUE) / R_TRUE,
        "C_err_pct": 100 * abs(float(params["C"]["C"]) - C_TRUE) / C_TRUE,
        "loss": h2["loss"][-1],
        "mlp_max_weight_delta": d_w0,
    }

    result = {
        "truth": {"R": R_TRUE, "C": C_TRUE},
        "init": {"R": R_INIT, "C": C_INIT},
        "phase1_components_only": rec1,
        "phase2_joint": rec2,
        "config": {"fs": args.fs, "duration_s": args.duration,
                   "epochs": [args.epochs1, args.epochs2],
                   "component_lrs": lrs, "mlp_lr_phase2": 1e-6,
                   "backend": jax.default_backend()},
        "trajectories": {"phase2_R": h2["Vs.R"][::10],
                         "phase2_C": h2["C.C"][::10]},
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps({
        "R_err_pct": round(rec2["R_err_pct"], 2),
        "C_err_pct": round(rec2["C_err_pct"], 2),
        "loss_frozen": rec1["loss"],
        "loss_joint": rec2["loss"],
        "out": args.out,
    }))


if __name__ == "__main__":
    main()
