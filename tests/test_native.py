"""Native C++ runtime: omega oracle, CPU clipper engines, CSV loader."""

import numpy as np
import pytest

from diffwdf.native import lib as native

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build failed: {native.build_error()}"
)


def test_native_omega_vs_scipy():
    from scipy.special import wrightomega

    x = np.linspace(-200, 200, 40001)
    got = native.wrightomega(x)
    want = np.real(wrightomega(x))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert np.max(rel) < 1e-12, float(np.max(rel))


def test_native_clipper_vs_jax_engine():
    import jax
    import jax.numpy as jnp

    import diffwdf as dwdf
    from diffwdf.models.diode_clipper import make_diode_clipper

    fs, r, c = 48000.0, 47e3, 2.2e-9
    diode = dwdf.diode_1n4148_1u2d
    vt = diode.Vt * diode.nabla
    rng = np.random.default_rng(0)
    vin = (2.0 * rng.standard_normal(2048)).astype(np.float32)

    out_c, zf = native.clipper_process(
        vin, 0.0, r, c, fs, diode.Is, vt, diode.N_up, diode.N_down
    )

    root = dwdf.DiodePairRoot(name="dp", diode=diode, quality="best")
    ckt = make_diode_clipper(root, fs, r, c)
    params = {**ckt.init_params(), **root.init_params()}
    out_j, st = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    np.testing.assert_allclose(out_c, np.asarray(out_j), atol=3e-5)
    np.testing.assert_allclose(zf, float(st["C"]["z"]), atol=3e-5)


def test_native_neural_clipper_vs_jax():
    import jax
    import jax.numpy as jnp

    from diffwdf.models.diode_clipper import make_diode_clipper
    from diffwdf.roots.neural import NeuralDiodeRoot

    fs, r, c = 48000.0, 47e3, 2.2e-9
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    frag = root.init_params(jax.random.PRNGKey(1))
    ckt = make_diode_clipper(root, fs, r, c)
    params = {**ckt.init_params(), **frag}

    rng = np.random.default_rng(1)
    vin = (1.5 * rng.standard_normal(1024)).astype(np.float32)
    out_c, _ = native.clipper_process_neural(vin, 0.0, frag["dp"], r, c, fs)
    out_j, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    np.testing.assert_allclose(out_c, np.asarray(out_j), atol=1e-5)


def test_native_csv_loader(tmp_path):
    from diffwdf.data.dataimport import read_csv
    from diffwdf.data.synthetic import write_reference_csv

    fs = 2000.0
    vin = np.random.default_rng(2).normal(size=500).astype(np.float32)
    vout = 0.5 * vin
    p = str(tmp_path / "10k_4.7nF.csv")
    write_reference_csv(p, vin, vout, fs)

    a, b, fs_read = native.load_csv(p)
    assert fs_read == fs
    np.testing.assert_allclose(a, vin, rtol=1e-5)
    np.testing.assert_allclose(b, vout, rtol=1e-5)
    # agrees with the python importer (untrimmed)
    rows, fs2 = read_csv(p, trim_pre_s=None, keep_s=None)
    np.testing.assert_allclose(a, rows[:, 0], rtol=1e-5)
