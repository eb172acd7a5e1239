"""Synthetic dataset generation.

Two roles:

1. The pretraining grid: (incident wave a, port impedance R) -> reflected wave
   targets from the closed-form diode-pair equation — the reference's
   synthetic-pretraining path (``diode_pretraining.py:63-105``), vectorized
   with the JAX omega instead of a 20 000-point scipy Python loop.

2. Synthetic "measured" clipper data: the reference's diode_dataset CSVs are
   large blobs absent from this mount (``.MISSING_LARGE_BLOBS``), so we
   synthesize equivalent measurements by simulating the training circuit with
   the analytic (TOMS-equivalent) root, and can write them in the exact CSV
   format the importer expects — keeping the whole measured-data pipeline
   executable end-to-end.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..roots.diode import DiodeConfig, DiodePairRoot, diode_pair_reflected


def pretraining_grid(
    diode: DiodeConfig,
    n_r: int = 20,
    r_log10_lo: float = 1.0,
    r_log10_hi: float = 9.0,
    n_a: int = 1000,
    a_span: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the synthetic pretraining set.

    Returns (x, y): x[:, 0] = a, x[:, 1] = log(R) (the log-impedance input
    convention, ``diode_pretraining.py:104-105``), y = **negated** reflected
    wave (the -1 target convention, ``diode_pretraining.py:98-102``).
    Grid: n_r log-spaced R decades x n_a points in [-a_span, a_span].
    """
    Vt = diode.Vt * diode.nabla
    r_vals = 10.0 ** np.linspace(r_log10_lo, r_log10_hi, n_r)
    a_vals = np.linspace(-a_span, a_span, n_a)
    A, R = np.meshgrid(a_vals, r_vals, indexing="xy")  # [n_r, n_a]
    a_flat = jnp.asarray(A.reshape(-1), jnp.float32)
    r_flat = jnp.asarray(R.reshape(-1), jnp.float32)
    b = diode_pair_reflected(
        a_flat, r_flat, diode.Is, Vt, float(diode.N_up), float(diode.N_down)
    )
    x = np.stack(
        [np.asarray(a_flat), np.log(np.asarray(r_flat))], axis=-1
    ).astype(np.float32)
    y = -np.asarray(b, dtype=np.float32)
    return x, y


def synth_clipper_measurement(
    diode: DiodeConfig,
    r_source: float,
    cap: float = 4.7e-9,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    seed: int = 0,
    amp: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the training clipper (Vs(R) || C + analytic diode root) on a
    multi-tone + noise excitation; returns (vin, vout) float32 arrays.

    Stands in for a lab measurement at source resistance ``r_source``.
    """
    from ..models.diode_clipper import make_training_clipper

    root = DiodePairRoot(name="dp", diode=diode, quality="best")
    ckt = make_training_clipper(root, fs, r_source=r_source, cap=cap)
    params = {**ckt.init_params(), **root.init_params()}

    n = int(duration_s * fs)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    # sweepy multi-tone covering the audio band + a little noise, like a
    # measurement stimulus
    f0, f1 = 40.0, 4000.0
    phase = 2 * np.pi * f0 * (f1 / f0) ** (t / duration_s) * t / np.log(f1 / f0)
    vin = amp * np.sin(phase).astype(np.float32)
    vin += 0.05 * rng.standard_normal(n).astype(np.float32)
    env = np.minimum(1.0, t * 20.0).astype(np.float32)  # fade-in
    vin = (vin * env).astype(np.float32)

    out, _ = jax.jit(lambda p, s, i: ckt.process(p, s, i))(
        params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}}
    )
    return vin, np.asarray(out, dtype=np.float32)


def synth_hpf_measurement(
    diode: DiodeConfig,
    r_load: float = 47.0e3,
    cap: float = 2.2e-9,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    seed: int = 0,
    amp: float = 2.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the HPF-topology clipper (``HPFDiodeClipper.h:26-32``) with
    the analytic diode root on a multi-tone excitation; returns (vin, vout).

    Stands in for the reference's ``placeholder_data/HPF`` measurement CSVs
    (large blobs absent from the mount) — used to train the HPF "2x16
    Trained" zoo model (``HPFDiodeClipper.cpp:29-30``).
    """
    from ..models.diode_clipper import make_hpf_diode_clipper

    root = DiodePairRoot(name="dp", diode=diode, quality="best")
    ckt = make_hpf_diode_clipper(root, fs, r_load=r_load, cap=cap)
    params = {**ckt.init_params(), **root.init_params()}

    n = int(duration_s * fs)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0, f1 = 40.0, 4000.0
    phase = 2 * np.pi * f0 * (f1 / f0) ** (t / duration_s) * t / np.log(f1 / f0)
    vin = amp * np.sin(phase).astype(np.float32)
    vin += 0.05 * rng.standard_normal(n).astype(np.float32)
    env = np.minimum(1.0, t * 20.0).astype(np.float32)
    vin = (vin * env).astype(np.float32)

    out, _ = jax.jit(lambda p, s, i: ckt.process(p, s, i))(
        params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}}
    )
    return vin, np.asarray(out, dtype=np.float32)


def synth_ts_measurement(
    diode: DiodeConfig,
    drive: float = 0.5,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    seed: int = 0,
    amp: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the Tube Screamer clipping stage (``TubeScreamer.h:24-74``)
    with the fast-approx analytic diode root (the reference's own analytic
    TS choice, ``TubeScreamer.h:73``) on a guitar-level multi-tone; returns
    (vin, vout).  Stands in for a measurement used to circuit-train the TS
    "1N4148 2x16" neural model in its OWN topology."""
    from ..models.tube_screamer import make_tube_screamer

    root = DiodePairRoot(name="dp", diode=diode, quality="low")
    ckt = make_tube_screamer(root, fs, drive=drive)
    params = {**ckt.init_params(), **root.init_params()}

    n = int(duration_s * fs)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    f0, f1 = 60.0, 3000.0
    phase = 2 * np.pi * f0 * (f1 / f0) ** (t / duration_s) * t / np.log(f1 / f0)
    vin = amp * np.sin(phase).astype(np.float32)
    vin += 0.005 * rng.standard_normal(n).astype(np.float32)
    env = np.minimum(1.0, t * 20.0).astype(np.float32)
    vin = (vin * env).astype(np.float32)

    out, _ = jax.jit(lambda p, s, i: ckt.process(p, s, i))(
        params, ckt.init_state(), {"Vin": {"v": jnp.asarray(vin)}}
    )
    return vin, np.asarray(out, dtype=np.float32)


def write_reference_csv(path, vin, vout, fs: float):
    """Write a measurement CSV in the reference dataset's on-disk format
    (header rows incl. '#Sample rate: ...Hz' at row 4, '#Samples: N' at row
    5, data from row 10 — parsed by ``dataimport.py:10-22,30``)."""
    n = len(vin)
    with open(path, "w") as f:
        f.write("#Synthetic diode clipper measurement\n")
        f.write("#Generated by diffwdf\n")
        f.write("#\n")
        f.write("#\n")
        f.write(f"#Sample rate: {fs}Hz\n")
        f.write(f"#Samples: {n}\n")
        f.write("#\n")
        f.write("#\n")
        f.write("#\n")
        f.write("in_voltage,out_voltage\n")
        for a, b in zip(vin, vout):
            f.write(f"{a:.7g},{b:.7g}\n")


def make_synthetic_dataset_dir(
    base_dir,
    diode: DiodeConfig,
    r_kohms: Sequence[float] = (10.0, 25.0, 45.2, 75.0, 99.0),
    cap: float = 4.7e-9,
    fs: float = 48000.0,
    duration_s: float = 1.0,
):
    """Create a diode_dataset-style directory tree:
    ``{base}/{family}/{N_up}up{N_down}down/{R}k_4.7nF.csv`` (layout per
    ``dataimport.py:62-79`` and the R-from-filename rule ``:95``)."""
    family = "1N4148" if "1N4148" in diode.name else diode.name.split()[0]
    sub = os.path.join(base_dir, family, f"{diode.N_up}up{diode.N_down}down")
    os.makedirs(sub, exist_ok=True)
    paths = []
    for i, rk in enumerate(r_kohms):
        vin, vout = synth_clipper_measurement(
            diode, rk * 1000.0, cap=cap, fs=fs, duration_s=duration_s, seed=i
        )
        p = os.path.join(sub, f"{rk}k_{cap*1e9:g}nF.csv")
        write_reference_csv(p, vin, vout, fs)
        paths.append(p)
    return paths
