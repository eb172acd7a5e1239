"""Piecewise-Chebyshev root distillation: fit error, engine parity, kernel."""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.ops.fused_circuit import fused_circuit_process
from diffwdf.roots.distilled import PiecewiseChebRoot, distill_root
from diffwdf.roots.neural import NeuralDiodeRoot

FS = 96000.0
R_SRC, CAP = 47.0e3, 2.2e-9


def _port_R():
    r_c = 1.0 / (2.0 * CAP * FS)
    g = 1.0 / R_SRC + 1.0 / r_c
    return 1.0 / g


def test_distill_analytic_root_error():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    droot, err = distill_root(root, root.init_params(), _port_R(), a_max=20.0)
    assert err < 1e-4, err  # over the whole +-20 V wave range


def test_distilled_clipper_matches_analytic():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    aparams = root.init_params()
    droot, err = distill_root(root, aparams, _port_R())

    ckt_a = make_diode_clipper(root, FS, R_SRC, CAP)
    pa = {**ckt_a.init_params(), **aparams}
    ckt_d = make_diode_clipper(droot, FS, R_SRC, CAP)
    pd = ckt_d.init_params()

    vin = jnp.asarray(
        (2.0 * np.random.default_rng(0).standard_normal(2048)).astype(np.float32)
    )
    ya, _ = ckt_a.process(pa, ckt_a.init_state(), {"Vs": {"v": vin}})
    yd, _ = ckt_d.process(pd, ckt_d.init_state(), {"Vs": {"v": vin}})
    ya, yd = np.asarray(ya), np.asarray(yd)
    esr = np.sum((ya - yd) ** 2) / np.sum(ya**2)
    assert esr < 1e-7, esr


def test_distill_neural_root():
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    params = root.init_params(jax.random.PRNGKey(0))
    droot, err = distill_root(root, params, _port_R())
    a = jnp.asarray(np.linspace(-15, 15, 301), jnp.float32)
    b_true = root.reflect(a, jnp.float32(_port_R()), params, {})
    b_true_odd = 0.5 * (b_true - root.reflect(-a, jnp.float32(_port_R()), params, {}))
    b_fit = droot.reflect(a, jnp.float32(_port_R()), {}, {})
    np.testing.assert_allclose(
        np.asarray(b_fit), np.asarray(b_true_odd), atol=max(5 * err, 1e-4)
    )


def test_fused_cheb_kernel_matches_engine():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    droot, err = distill_root(root, root.init_params(), _port_R())

    ckt_d = make_diode_clipper(droot, FS, R_SRC, CAP)
    pd = ckt_d.init_params()
    B, T = 1024, 256
    vin = jnp.asarray(
        (2.0 * np.random.default_rng(1).standard_normal((B, T))).astype(np.float32)
    )

    def one(v):
        out, st = ckt_d.process(pd, ckt_d.init_state(), {"Vs": {"v": v}})
        return out, st["C"]["z"]

    want, want_z = jax.vmap(one)(vin)
    got, got_st = fused_circuit_process(
        ckt_d, pd, vin,
        jax.tree_util.tree_map(
            lambda _: jnp.zeros((B,), jnp.float32), ckt_d.init_state()
        ),
        input_node="Vs", interpret=True,
    )
    got_z = got_st["C"]["z"]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_z), np.asarray(want_z), atol=1e-5)
