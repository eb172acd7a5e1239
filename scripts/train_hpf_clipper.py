"""Train the HPF-topology "2x16 Trained" zoo model.

The reference ships ``1N4148 (1U-1D)_2x16_training_1_hpf.json`` — a 2x16
neural root circuit-trained *inside* the HPF clipper topology, shown in the
plugin next to the LPF-trained "Extrapolated" model
(``HPFDiodeClipper.cpp:29-30``).  Its HPF training CSVs are absent from the
mount, so we synthesize HPF measurements with the analytic root as oracle
(the same stand-in scheme as the LPF synthetic dataset) and fine-tune the
LPF-pretrained 2x16 root in the HPF circuit.

Writes runs/hpf_1u1d/1N4148_1U1D_2x16_hpf_trained.json + metrics/plots.
"""
import argparse, json, os, sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--epochs", type=int, default=501)
ap.add_argument("--duration", type=float, default=16.0, help="train seconds")
ap.add_argument("--val-duration", type=float, default=4.0)
ap.add_argument("--platform", choices=("gpu", "cpu"))
ap.add_argument("--engine", default="scan", choices=("scan", "fused_generic"),
                help="fused_generic = ops.parallel_bptt (fused-kernel "
                     "forward + parallel backward)")
cli = ap.parse_args()

import jax

if cli.platform:  # "gpu" fails at start-up when no GPU is found
    jax.config.update("jax_platforms",
                      "cuda" if cli.platform == "gpu" else "cpu")
import jax.numpy as jnp

from diffwdf.analysis import plot_history
from diffwdf.data.synthetic import synth_hpf_measurement
from diffwdf.models.diode_clipper import make_hpf_diode_clipper
from diffwdf.nn.serialization import load_model_json, save_model_json
from diffwdf.roots.diode import diode_1n4148_1u1d
from diffwdf.roots.neural import NeuralDiodeRoot
from diffwdf.training.circuit_train import (
    CircuitTrainConfig,
    make_clipper_batches,
    train_clipper,
)

FS = 48000.0
R_LOAD, CAP = 47.0e3, 2.2e-9
OUT_DIR = "runs/hpf_1u1d"
os.makedirs(OUT_DIR, exist_ok=True)

diode = diode_1n4148_1u1d
vin_tr, vout_tr = synth_hpf_measurement(diode, R_LOAD, CAP, FS, duration_s=cli.duration, seed=0)
vin_va, vout_va = synth_hpf_measurement(diode, R_LOAD, CAP, FS, duration_s=cli.val_duration, seed=7)

mlp, acts, _ = load_model_json("models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json")
root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
circuit = make_hpf_diode_clipper(root, FS, r_load=R_LOAD, cap=CAP)
params = {**circuit.init_params(), **frag}

cfg = CircuitTrainConfig(epochs=cli.epochs, batch_size=2048,
                         learning_rate=1e-4, engine=cli.engine)
tb = make_clipper_batches({"x": vin_tr, "y": vout_tr}, cfg.batch_size)
vb = make_clipper_batches({"x": vin_va, "y": vout_va}, cfg.batch_size)
print(f"train {tb['x'].size} samples in {tb['x'].shape[0]} chunks", flush=True)


def only_root(grads):
    z = jax.tree_util.tree_map(jnp.zeros_like, grads)
    z["dp"] = grads["dp"]
    return z


hist_path = os.path.join(OUT_DIR, "metrics.jsonl")
open(hist_path, "w").close()


def on_epoch(epoch, p, hist):
    rec = {"epoch": epoch, **{k: v[-1] for k, v in hist.items() if v}}
    with open(hist_path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"[step {epoch}] " + " ".join(f"{k}={v:.6g}" for k, v in rec.items() if k != "epoch"),
          flush=True)


params, hist = train_clipper(circuit, params, tb, vb, cfg,
                             trainable_filter=only_root, on_epoch=on_epoch)
out_json = os.path.join(OUT_DIR, "1N4148_1U1D_2x16_hpf_trained.json")
save_model_json(params["dp"], root.activations, out_json)
print(f"saved {out_json}; final loss {hist['loss'][-1]:.6g} "
      f"val_esr {hist['val_esr'][-1]:.6g}", flush=True)
plot_history(hist, os.path.join(OUT_DIR, "hpf_history.png"))
