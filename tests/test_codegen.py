"""Circuit -> native C codegen (``native/codegen.py``) vs the scan engine."""

import shutil

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.models.tube_screamer import make_tube_screamer
from diffwdf.roots.neural import NeuralDiodeRoot

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ compiler"
)

FS = 48000.0


def _x(n=4096, amp=0.5, f=440.0):
    t = np.arange(n)
    return (amp * np.sin(2 * np.pi * f * t / FS)).astype(np.float32)


def test_codegen_clipper_matches_scan():
    from diffwdf.native.codegen import compile_circuit

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    eng = compile_circuit(ckt, params, input_node="Vs")
    x = _x(amp=1.5)
    y, _ = eng.process(x)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(y - np.asarray(ref))) < 1e-5


def test_codegen_tube_screamer_matches_scan():
    from diffwdf.native.codegen import compile_circuit

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_tube_screamer(root, FS, drive=0.8)
    params = {**ckt.init_params(), **root.init_params()}
    eng = compile_circuit(ckt, params)
    assert eng.n_states == 3  # C2, C3, C4
    x = _x(amp=0.2)
    y, _ = eng.process(x)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vin": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(y - np.asarray(ref))) < 1e-5


def test_codegen_neural_root():
    """MLP root traces through dot_general/tanh into the generated C."""
    from diffwdf.native.codegen import compile_circuit

    nroot = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    frag = nroot.init_params(jax.random.PRNGKey(1))
    ckt = make_diode_clipper(nroot, FS)
    params = {**ckt.init_params(), **frag}
    eng = compile_circuit(ckt, params, input_node="Vs")
    x = _x(amp=1.0)
    y, _ = eng.process(x)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(y - np.asarray(ref))) < 1e-4


def test_codegen_state_carries():
    from diffwdf.native.codegen import compile_circuit

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_tube_screamer(root, FS, drive=0.5)
    params = {**ckt.init_params(), **root.init_params()}
    eng = compile_circuit(ckt, params)
    x = _x(amp=0.2)
    full, _ = eng.process(x)
    h1, st = eng.process(x[:2048])
    h2, _ = eng.process(x[2048:], st)
    np.testing.assert_allclose(np.concatenate([h1, h2]), full, atol=1e-6)
