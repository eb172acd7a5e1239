"""Tube Screamer DRIVE-POT SWEEP training on the generic fused engine.

The reference's flagship training drives the pot per data row — every
measurement CSV carries its own source resistance and the circuit re-adapts
to it during training (``clipper_pot.py:113-124``, one R per file after
``dataimport.py:109``).  The generic fused engine's per-row coefficient
streams run that workload on ANY circuit.

This script exercises exactly that on the Tube Screamer: measurements are
synthesized at a LADDER of drive-pot positions (analytic-root oracle, the
same stand-in scheme as the LPF/HPF synthetic datasets), every 2048-sample
chunk carries its own R6 = 51k + drive * 500k (``TubeScreamer.cpp:66``),
and the 2x16 neural root is fine-tuned IN-topology across the whole sweep
with ``engine="fused_generic"`` + ``pot_node="R6"``.  Validation uses
HELD-OUT drive positions interleaved between the training ones — the same
interpolation-regime split idea as the reference's 36-73 kOhm val split
(``dataimport.py:98,116``).

Writes runs/ts_potsweep/ (trained JSON, metrics.jsonl, result.json).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--epochs", type=int, default=501)
ap.add_argument("--duration", type=float, default=4.0,
                help="train seconds PER drive position")
ap.add_argument("--val-duration", type=float, default=2.0)
ap.add_argument("--platform", choices=("gpu", "cpu"))
ap.add_argument("--engine", default="fused_generic",
                choices=("scan", "fused_generic"))
ap.add_argument("--batch-size", type=int, default=2048)
ap.add_argument("--out", default="runs/ts_potsweep")
cli = ap.parse_args()

import jax

if cli.platform:  # "gpu" fails at start-up when no GPU is found
    jax.config.update("jax_platforms",
                      "cuda" if cli.platform == "gpu" else "cpu")
import jax.numpy as jnp

from diffwdf.analysis import plot_history
from diffwdf.data.synthetic import synth_ts_measurement
from diffwdf.models.tube_screamer import drive_to_r6, make_tube_screamer
from diffwdf.nn.serialization import load_model_json, save_model_json
from diffwdf.roots.diode import diode_1n4148_1u1d
from diffwdf.roots.neural import NeuralDiodeRoot
from diffwdf.training.circuit_train import (
    CircuitTrainConfig,
    train_clipper,
)
from diffwdf.training.metrics import MetricsLogger

FS = 48000.0
TRAIN_DRIVES = [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
VAL_DRIVES = [0.3, 0.7]  # held-out, interpolation regime

os.makedirs(cli.out, exist_ok=True)
diode = diode_1n4148_1u1d
T = cli.batch_size


def sweep_batches(drives, duration, seed0):
    xs, ys, r0s = [], [], []
    for i, d in enumerate(drives):
        vin, vout = synth_ts_measurement(
            diode, d, FS, duration_s=duration, seed=seed0 + i)
        n = len(vin) // T
        xs.append(vin[: n * T].reshape(n, T))
        ys.append(vout[: n * T].reshape(n, T))
        r0s.append(np.full((n,), drive_to_r6(d), np.float32))
    return {
        "x": jnp.asarray(np.concatenate(xs).astype(np.float32)),
        "y": jnp.asarray(np.concatenate(ys).astype(np.float32)),
        "r0": jnp.asarray(np.concatenate(r0s)),
    }


train_b = sweep_batches(TRAIN_DRIVES, cli.duration, seed0=0)
val_b = sweep_batches(VAL_DRIVES, cli.val_duration, seed0=100)
print(f"train {train_b['x'].shape[0]} chunks x {T} over drives "
      f"{TRAIN_DRIVES}; val {val_b['x'].shape[0]} chunks over {VAL_DRIVES}",
      flush=True)

mlp, acts, _ = load_model_json(
    "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json")
root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
ts = make_tube_screamer(root, FS)
params = {**ts.init_params(), "dp": mlp}

cfg = CircuitTrainConfig(
    epochs=cli.epochs, batch_size=T, learning_rate=1e-4,
    engine=cli.engine, pot_node="R6",
)


def only_root(grads):
    zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
    zeros["dp"] = grads["dp"]
    return zeros


log = MetricsLogger(os.path.join(cli.out, "metrics.jsonl"))


def on_epoch(epoch, p, hist):
    rec = {k: v[-1] for k, v in hist.items() if v}
    log.log(step=epoch, **rec)
    print(f"[epoch {epoch}] " + " ".join(
        f"{k}={v:.6g}" for k, v in rec.items()), flush=True)


t0 = time.time()
params, hist = train_clipper(
    ts, params, train_b, val_batches=val_b, cfg=cfg,
    trainable_filter=only_root, on_epoch=on_epoch,
)
dt = time.time() - t0

out_json = os.path.join(cli.out, "1N4148_1U1D_2x16_ts_potsweep.json")
save_model_json(params["dp"], acts, out_json)
plot_history(hist, os.path.join(cli.out, "history.png"))
result = {
    "engine": cli.engine,
    "epochs": cli.epochs,
    "train_drives": TRAIN_DRIVES,
    "val_drives_held_out": VAL_DRIVES,
    "n_train_chunks": int(train_b["x"].shape[0]),
    "chunk": T,
    "train_seconds": round(dt, 1),
    "final_loss": hist["loss"][-1],
    "final_esr": hist["esr"][-1],
    "final_val_loss": hist["val_loss"][-1],
    "final_val_esr": hist["val_esr"][-1],
    "platform": jax.default_backend(),
}
with open(os.path.join(cli.out, "result.json"), "w") as f:
    json.dump(result, f, indent=2)
print(json.dumps(result), flush=True)
