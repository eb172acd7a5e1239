"""Joint physics+neural training (``training.circuit_train.joint_fit_clipper``).

The capability demo the reference never combines: component values (R/C,
clip-constrained) and the neural root training in the same differentiable
circuit (reference has neural-only ``clipper_pot.py:245-269`` and
components-only ``lpf.py:79-99`` as separate workloads).
"""

import jax
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

FS = 8000.0
R_TRUE, C_TRUE = 45e3, 4.7e-9


def test_joint_fit_recovers_perturbed_components():
    """Phase 1 (frozen pretrained root) recovers R/C from a +44 %/-32 %
    perturbation to within a few percent; phase 2 co-trains the root at a
    scale-separated lr, improving the loss below the frozen-root floor
    without losing the recovered physics."""
    vin, vout = synth_clipper_measurement(
        dwdf.diode_1n4148_1u1d, R_TRUE, cap=C_TRUE, fs=FS, duration_s=1.0
    )
    mlp, acts, _ = load_model_json(
        "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"
    )
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    ckt = make_training_clipper(root, FS, r_source=65e3, cap=3.2e-9)
    params = {**ckt.init_params(), **frag}
    cfg = CircuitTrainConfig(epochs=500, batch_size=256, max_chunks=12,
                             skip_samples=50)
    batches = make_clipper_batches({"x": vin, "y": vout}, cfg.batch_size,
                                   cfg.max_chunks)
    lrs = {"Vs.R": 1500.0, "C.C": 8e-11}

    # phase 1: components only
    params, h1 = joint_fit_clipper(ckt, params, batches, lrs, cfg, mlp_lr=0.0)
    r1, c1 = float(params["Vs"]["R"]), float(params["C"]["C"])
    assert abs(r1 - R_TRUE) / R_TRUE < 0.03, r1
    assert abs(c1 - C_TRUE) / C_TRUE < 0.03, c1
    # the frozen MLP really was frozen
    np.testing.assert_array_equal(
        np.asarray(params["dp"]["layers"][0]["kernel"]),
        np.asarray(frag["dp"]["layers"][0]["kernel"]),
    )

    # phase 2: joint fine-tune
    cfg2 = CircuitTrainConfig(epochs=200, batch_size=256, max_chunks=12,
                              skip_samples=50)
    params, h2 = joint_fit_clipper(ckt, params, batches, lrs, cfg2,
                                   mlp_lr=1e-6)
    assert h2["loss"][-1] < h1["loss"][-1]  # co-training beats frozen floor
    # root genuinely trained
    d = np.max(np.abs(
        np.asarray(params["dp"]["layers"][0]["kernel"])
        - np.asarray(frag["dp"]["layers"][0]["kernel"])
    ))
    assert d > 1e-6
    # physics stays identified
    assert abs(float(params["Vs"]["R"]) - R_TRUE) / R_TRUE < 0.08
    assert abs(float(params["C"]["C"]) - C_TRUE) / C_TRUE < 0.08
    # trajectories recorded for both components
    assert len(h2["Vs.R"]) == 200 and len(h2["C.C"]) == 200


def test_joint_fit_respects_constraints():
    """Component updates are clipped to element bounds every step
    (Resistor [180, 1e6] Ohm — ``tf_wdf.py:69-75`` parity)."""
    vin, vout = synth_clipper_measurement(
        dwdf.diode_1n4148_1u1d, R_TRUE, cap=C_TRUE, fs=FS, duration_s=0.25
    )
    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    frag = root.init_params(jax.random.PRNGKey(0))
    ckt = make_training_clipper(root, FS, r_source=300.0, cap=C_TRUE)
    params = {**ckt.init_params(), **frag}
    cfg = CircuitTrainConfig(epochs=10, batch_size=256, max_chunks=2,
                             skip_samples=50)
    batches = make_clipper_batches({"x": vin, "y": vout}, cfg.batch_size,
                                   cfg.max_chunks)
    # huge lr drives R toward/below the bound; constrain must clamp it
    params, h = joint_fit_clipper(ckt, params, batches, {"Vs.R": 5e4}, cfg,
                                  mlp_lr=0.0)
    assert all(r >= 180.0 for r in h["Vs.R"]), min(h["Vs.R"])
