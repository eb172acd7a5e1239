"""The fused kernel on the diode clipper vs the reference-parity scan engine.

On CPU these run in Pallas interpret mode; the same kernel compiles for the
GPU through Triton (``chip_smoke.py`` times and checks it there).
"""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.ops.fused_circuit import fused_circuit_process
from diffwdf.roots.neural import NeuralDiodeRoot

FS = 96000.0
R_SRC = 47.0e3
CAP = 2.2e-9


def _engine_reference(root, params, vin):
    ckt = make_diode_clipper(root, FS, r_source=R_SRC, cap=CAP)
    state = ckt.init_state()

    def one(v):
        out, st = ckt.process(params, state, {"Vs": {"v": v}})
        return out, st["C"]["z"]

    outs, zf = jax.vmap(one)(vin)
    return np.asarray(outs), np.asarray(zf)


def _fused(root, params, vin, z0=None):
    ckt = make_diode_clipper(root, FS, r_source=R_SRC, cap=CAP)
    B = vin.shape[0]
    z0 = jnp.zeros((B,), jnp.float32) if z0 is None else z0
    out, st = fused_circuit_process(
        ckt, params, vin, {"C": {"z": z0}}, input_node="Vs", interpret=True
    )
    return out, st["C"]["z"]


def test_fused_analytic_matches_engine():
    diode = dwdf.diode_1n4148_1u2d  # asymmetric: exercises the sign-select
    root = dwdf.DiodePairRoot(name="dp", diode=diode, quality="best")
    params = root.init_params()
    tree_params = make_diode_clipper(root, FS, R_SRC, CAP).init_params()
    params = {**tree_params, **params}

    B, T = 256, 512
    rng = np.random.default_rng(0)
    vin = jnp.asarray(
        (2.0 * rng.standard_normal((B, T))).astype(np.float32)
    )
    want, want_z = _engine_reference(root, params, vin)
    got, got_z = _fused(root, params, vin)
    np.testing.assert_allclose(np.asarray(got), want, atol=5e-6)
    np.testing.assert_allclose(np.asarray(got_z), want_z, atol=5e-6)


def test_fused_analytic_state_carry():
    """Running two half-signals with carried state == one full signal."""
    diode = dwdf.diode_1n4148_1u1d
    root = dwdf.DiodePairRoot(name="dp", diode=diode, quality="best")
    params = {
        **make_diode_clipper(root, FS, R_SRC, CAP).init_params(),
        **root.init_params(),
    }
    B, T = 256, 256
    rng = np.random.default_rng(1)
    vin = jnp.asarray((1.5 * rng.standard_normal((B, T))).astype(np.float32))

    full, zf = _fused(root, params, vin)
    h1, z1 = _fused(root, params, vin[:, : T // 2])
    h2, z2 = _fused(root, params, vin[:, T // 2 :], z1)
    np.testing.assert_allclose(
        np.asarray(full), np.concatenate([h1, h2], axis=1), atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(zf), np.asarray(z2), atol=1e-6)


def test_fused_neural_matches_engine():
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    params = root.init_params(jax.random.PRNGKey(7))
    tree_params = make_diode_clipper(root, FS, R_SRC, CAP).init_params()
    all_params = {**tree_params, **params}

    B, T = 256, 256
    rng = np.random.default_rng(2)
    vin = jnp.asarray((2.0 * rng.standard_normal((B, T))).astype(np.float32))
    want, want_z = _engine_reference(root, all_params, vin)
    got, got_z = _fused(root, all_params, vin)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)
    np.testing.assert_allclose(np.asarray(got_z), want_z, atol=2e-5)


def test_fused_neural_4x_family_matches_engine():
    """The deeper zoo entries (4x4 / 4x8, ``DiodePairNeuralModel.h:23-40``)
    run through the same kernel: every layer is unrolled at trace time."""
    for width in (4, 8):
        root = NeuralDiodeRoot(name="dp", n_layers=4, layer_size=width)
        params = root.init_params(jax.random.PRNGKey(11 + width))
        tree_params = make_diode_clipper(root, FS, R_SRC, CAP).init_params()
        all_params = {**tree_params, **params}

        B, T = 256, 256
        rng = np.random.default_rng(3)
        vin = jnp.asarray((2.0 * rng.standard_normal((B, T))).astype(np.float32))
        want, want_z = _engine_reference(root, all_params, vin)
        got, got_z = _fused(root, all_params, vin)
        np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)
        np.testing.assert_allclose(np.asarray(got_z), want_z, atol=2e-5)
