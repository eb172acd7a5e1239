"""Generic fused-circuit kernel vs the scan engine (interpret mode on CPU)."""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import (
    make_diode_clipper,
    make_hpf_diode_clipper,
)
from diffwdf.models.tube_screamer import make_tube_screamer
from diffwdf.ops.fused_circuit import fused_circuit_process

FS = 96000.0
B, T = 1024, 256


def _vin(seed=0, amp=1.5):
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    x = amp * np.sin(2 * np.pi * 1000.0 * n / FS)[None, :] * np.ones((B, 1))
    x = x + 0.1 * rng.standard_normal((B, T))
    return jnp.asarray(x, jnp.float32)


def _batched_state(circuit):
    return jax.tree_util.tree_map(
        lambda z: jnp.zeros((B,), jnp.float32), circuit.init_state()
    )


def _scan_ref(circuit, params, vin, input_node="Vin", static_controls=None):
    def one(v):
        out, _ = circuit.process(
            params,
            circuit.init_state(),
            {input_node: {"v": v}},
            static_controls=static_controls,
        )
        return out

    return jax.vmap(one)(vin)


def test_fused_circuit_matches_scan_clipper():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    vin = _vin()
    ref = _scan_ref(ckt, params, vin, "Vs")
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), input_node="Vs", interpret=True
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_fused_circuit_matches_scan_hpf():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_hpf_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    vin = _vin(1)
    ref = _scan_ref(ckt, params, vin, "Vs")
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), input_node="Vs", interpret=True
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_fused_circuit_matches_scan_tube_screamer():
    """The R-type showcase: 3 capacitor states + 4x4 S-matrix in one kernel."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_tube_screamer(root, FS, drive=0.5)
    params = {**ckt.init_params(), **root.init_params()}
    vin = _vin(2, amp=0.2)
    ref = _scan_ref(ckt, params, vin)
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), interpret=True
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_fused_circuit_state_carries():
    """Two chunked calls == one long call (the state round-trips)."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_tube_screamer(root, FS, drive=0.5)
    params = {**ckt.init_params(), **root.init_params()}
    vin = _vin(3, amp=0.2)
    full, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), interpret=True
    )
    h1, st = fused_circuit_process(
        ckt, params, vin[:, : T // 2], _batched_state(ckt), interpret=True
    )
    h2, _ = fused_circuit_process(ckt, params, vin[:, T // 2 :], st, interpret=True)
    np.testing.assert_allclose(
        np.asarray(jnp.concatenate([h1, h2], axis=1)),
        np.asarray(full),
        atol=1e-6,
    )


def test_fused_circuit_neural_tube_screamer():
    """Neural 2x16 root as float32 FMAs inside the kernel — the reference's
    Tube Screamer neural model choice (``TubeScreamer.h:73-74``)."""
    from diffwdf.roots.neural import NeuralDiodeRoot

    nroot = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    frag = nroot.init_params(jax.random.PRNGKey(3))
    ckt = make_tube_screamer(nroot, FS, drive=0.5)
    params = {**ckt.init_params(), **frag}
    vin = _vin(4, amp=0.2)
    ref = _scan_ref(ckt, params, vin)
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), interpret=True
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)
