"""Training workloads: component fitting, pretraining, circuit training.

Shortened versions of the reference's three training scripts, asserting
learning direction and target recovery rather than full convergence (full
configs are exercised by the workload CLIs / benchmarks).
"""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_training_clipper
from diffwdf.roots.diode import diode_1n4148_1u1d
from diffwdf.roots.neural import NeuralDiodeRoot
from diffwdf.training.circuit_train import (
    CircuitTrainConfig,
    fit_components,
    make_clipper_batches,
    train_clipper,
)
from diffwdf.training.pretrain import (
    PretrainConfig,
    evaluate_pretrained,
    pretrain_diode,
)

FS = 48000.0


def test_fit_voltage_divider():
    """Learn R1, R2 so V(R1) = 0.5 * Vin (reference ``voltage_divider.py``)."""
    R1 = dwdf.Resistor("R1", 2.0e3, trainable=True)
    R2 = dwdf.Resistor("R2", 100.0, trainable=True)
    S1 = dwdf.Series("S1", R1, R2)
    I1 = dwdf.Inverter("I1", S1)
    ckt = dwdf.Circuit(
        tree=I1, root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("R1",)
    )
    params = ckt.init_params()
    n = np.arange(256)
    vin = jnp.asarray(np.sin(2 * np.pi * 100 * n / FS).astype(np.float32))
    target = 0.5 * vin

    params, hist = fit_components(
        ckt,
        params,
        {"Vs": {"v": vin}},
        target,
        lr_by_param={"R1.R": 25.0, "R2.R": 25.0},
        epochs=150,
    )
    assert hist["loss"][-1] < hist["loss"][0] * 0.05
    ratio = float(params["R1"]["R"] / (params["R1"]["R"] + params["R2"]["R"]))
    assert abs(ratio - 0.5) < 0.02, ratio


def test_fit_rc_lowpass_recovers_cutoff():
    """Learn R and C toward a 720 Hz one-pole target (reference ``lpf.py``):
    per-parameter optimizers, learned 1/(2 pi R C) near 720 Hz."""
    import scipy.signal as sig

    R1 = dwdf.Resistor("R1", 1000.0, trainable=True)
    C1 = dwdf.Capacitor("C1", 1.0e-6, trainable=True)
    S1 = dwdf.Series("S1", R1, C1)
    I1 = dwdf.Inverter("I1", S1)
    ckt = dwdf.Circuit(
        tree=I1, root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("C1",)
    )
    params = ckt.init_params()

    # log sweep through the pole region, filtered by the analytic target
    T = 1280
    t = np.arange(T) / FS
    f0, f1 = 100.0, 10000.0
    k = T / FS / np.log(f1 / f0)
    phase = 2 * np.pi * f0 * k * (np.exp(t / k) - 1.0)
    sweep = np.sin(phase).astype(np.float32)
    fc = 720.0
    rc = 1.0 / (2 * np.pi * fc)
    b, a = sig.bilinear([1.0], [rc, 1.0], fs=FS)
    target = jnp.asarray(sig.lfilter(b, a, sweep).astype(np.float32))

    params, hist = fit_components(
        ckt,
        params,
        {"Vs": {"v": jnp.asarray(sweep)}},
        target,
        lr_by_param={"R1.R": 25.0, "C1.C": 10.0e-9},
        epochs=100,
    )
    f_learned = 1.0 / (
        2 * np.pi * float(params["R1"]["R"]) * float(params["C1"]["C"])
    )
    assert hist["loss"][-1] < hist["loss"][0]
    assert abs(f_learned - fc) / fc < 0.25, f_learned


def test_pretrain_smoke():
    """Short pretraining run reduces loss and beats the trivial predictor."""
    cfg = PretrainConfig(
        n_layers=2, layer_size=8, epochs=30, n_r=8, n_a=128, learning_rate=1e-3
    )
    params, acts, metrics = pretrain_diode(diode_1n4148_1u1d, cfg)
    losses = np.asarray(metrics["loss"])
    assert losses[-1] < losses[0] * 0.5
    final = evaluate_pretrained(params, acts, diode_1n4148_1u1d, cfg)
    assert np.isfinite(final["mse"]) and final["mse"] < 0.5


def test_circuit_training_reduces_loss():
    """Gradient-through-scan fine-tuning on synthetic clipper data."""
    diode = diode_1n4148_1u1d
    fs = 8000.0
    # synthesize a tiny 'measurement' with the analytic root
    from diffwdf.data.synthetic import synth_clipper_measurement

    vin, vout = synth_clipper_measurement(
        diode, 45.0e3, fs=fs, duration_s=0.6, seed=0
    )
    data = {
        "x": vin,
        "r": np.full_like(vin, 45.0e3),
        "y": vout,
    }

    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, fs)
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(3))}

    cfg = CircuitTrainConfig(epochs=12, batch_size=256, learning_rate=3e-3,
                             skip_samples=20, max_chunks=4)
    batches = make_clipper_batches(data, cfg.batch_size, cfg.max_chunks)

    def only_root_grads(grads):
        # train the MLP only; freeze circuit components (reference behavior)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
        zeros["dp"] = grads["dp"]
        return zeros

    params, hist = train_clipper(
        ckt, params, batches, cfg=cfg, trainable_filter=only_root_grads
    )
    assert hist["loss"][-1] < hist["loss"][0], hist["loss"]


def test_dataimport_roundtrip(tmp_path):
    """Synthetic CSVs in the reference's on-disk format load and split by R
    exactly as the reference importer does."""
    from diffwdf.data.dataimport import load_diode_data
    from diffwdf.data.synthetic import make_synthetic_dataset_dir

    diode = diode_1n4148_1u1d
    fs = 2000.0
    make_synthetic_dataset_dir(
        tmp_path, diode, r_kohms=(10.0, 45.2, 99.0), fs=fs, duration_s=18.0
    )
    train, val, fs_read = load_diode_data(diode, tmp_path)
    assert fs_read == fs
    # 10k and 99k are training R values; 45.2k falls in the validation band
    assert set(np.unique(train["r"])) == {10000.0, 99000.0}
    assert set(np.unique(val["r"])) == {45200.0}
    # trim: 14.3 s kept from each 18 s file
    assert len(val["x"]) == int(np.ceil((2.5 + 14.3) * fs)) - int(2.5 * fs)
    assert np.all(np.isfinite(train["y"]))


def test_hoisted_r_matches_per_sample_adaptation():
    """R-hoisting (adapt once per constant-R chunk, SURVEY.md §7) is exactly
    the per-sample re-adaptation math: outputs and gradients match."""
    from diffwdf.training.circuit_train import clipper_forward
    from diffwdf.training.losses import esr, mse

    fs = 8000.0
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    ckt = make_training_clipper(root, fs)
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(0))}

    rng = np.random.default_rng(1)
    n_seq, T = 3, 128
    x = rng.normal(size=(n_seq * T,)).astype(np.float32)
    y = rng.normal(size=(n_seq * T,)).astype(np.float32)
    # per-chunk-constant R stream (different value per chunk)
    r = np.repeat(np.float32([10e3, 45e3, 99e3]), T)

    batches_ps = {k: jnp.asarray(v.reshape(n_seq, T)) for k, v in
                  {"x": x, "r": r, "y": y}.items()}
    batches_h = make_clipper_batches({"x": x, "r": r, "y": y}, T)
    assert "r0" in batches_h and "r" not in batches_h
    np.testing.assert_allclose(np.asarray(batches_h["r0"]), [10e3, 45e3, 99e3])

    def loss(p, b):
        out = clipper_forward(ckt, p, b)
        return mse(b["y"], out) + esr(b["y"], out)

    l_ps, g_ps = jax.value_and_grad(loss)(params, batches_ps)
    l_h, g_h = jax.value_and_grad(loss)(params, batches_h)
    np.testing.assert_allclose(float(l_h), float(l_ps), rtol=1e-6)
    for (pa, ga), (pb, gb) in zip(
        jax.tree_util.tree_leaves_with_path(g_ps),
        jax.tree_util.tree_leaves_with_path(g_h),
    ):
        assert pa == pb
        np.testing.assert_allclose(np.asarray(gb), np.asarray(ga),
                                   rtol=2e-5, atol=1e-7, err_msg=str(pa))


def test_mixed_r_chunks_keep_per_sample_path():
    """A chunk whose R changes mid-stream (file-boundary chunk) keeps the
    per-sample 'r' stream — no silent hoisting of non-constant R."""
    T = 64
    x = np.zeros(2 * T, np.float32)
    r = np.concatenate([np.full(T + 8, 10e3, np.float32),
                        np.full(T - 8, 99e3, np.float32)])
    batches = make_clipper_batches({"x": x, "r": r, "y": x}, T)
    assert "r" in batches and "r0" not in batches
