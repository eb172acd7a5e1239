"""Newton-over-trajectory (DEER) solver vs the sequential scan."""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.models.tube_screamer import make_tube_screamer
from diffwdf.ops.parallel_time import parallel_time_process

FS = 48000.0


def test_matches_scan_on_clipper():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    n = np.arange(1024)
    vin = jnp.asarray((2.0 * np.sin(2 * np.pi * 330 * n / FS)).astype(np.float32))
    inputs = {"Vs": {"v": vin}}

    want, _ = ckt.process(params, ckt.init_state(), inputs)
    got, resid = parallel_time_process(
        ckt, params, inputs, n_iters=16, return_residual=True
    )
    assert float(resid) < 1e-5, float(resid)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_matches_scan_on_linear_circuit_one_iter():
    """For a linear circuit one Newton sweep is exact."""
    R1 = dwdf.Resistor("R1", 1000.0)
    C1 = dwdf.Capacitor("C1", 1.0e-6)
    S1 = dwdf.Series("S1", R1, C1)
    I1 = dwdf.Inverter("I1", S1)
    ckt = dwdf.Circuit(
        tree=I1, root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("C1",)
    )
    params = ckt.init_params()
    vin = jnp.asarray(
        np.random.default_rng(0).normal(size=512).astype(np.float32)
    )
    inputs = {"Vs": {"v": vin}}
    want, _ = ckt.process(params, ckt.init_state(), inputs)
    got = parallel_time_process(ckt, params, inputs, n_iters=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


def test_matches_scan_on_tube_screamer_multistate():
    """Multi-capacitor state (S=3): full Jacobian composition path."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_tube_screamer(root, FS, drive=0.8)
    params = {**ckt.init_params(), **root.init_params()}
    n = np.arange(512)
    vin = jnp.asarray((0.2 * np.sin(2 * np.pi * 220 * n / FS)).astype(np.float32))
    inputs = {"Vin": {"v": vin}}
    want, _ = ckt.process(params, ckt.init_state(), inputs)
    got, resid = parallel_time_process(
        ckt, params, inputs, n_iters=20, return_residual=True
    )
    assert float(resid) < 1e-4, float(resid)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=5e-4)


def test_neural_root_supported():
    from diffwdf.roots.neural import NeuralDiodeRoot

    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(0))}
    vin = jnp.asarray(
        (1.5 * np.random.default_rng(1).standard_normal(256)).astype(np.float32)
    )
    inputs = {"Vs": {"v": vin}}
    want, _ = ckt.process(params, ckt.init_state(), inputs)
    got = parallel_time_process(ckt, params, inputs, n_iters=16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_implicit_gradients_match_bptt():
    """Implicit-adjoint gradients at the converged trajectory == BPTT through
    the sequential scan (both value and grads w.r.t. params and inputs)."""
    from diffwdf.ops.parallel_time import parallel_time_process_implicit

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    vin = jnp.asarray(
        (1.5 * np.random.default_rng(5).standard_normal(256)).astype(np.float32)
    )
    target = jnp.tanh(vin)

    def loss_scan(p, v):
        out, _ = ckt.process(p, ckt.init_state(), {"Vs": {"v": v}})
        return jnp.mean((out - target) ** 2)

    def loss_impl(p, v):
        out = parallel_time_process_implicit(
            ckt, p, {"Vs": {"v": v}}, n_iters=20
        )
        return jnp.mean((out - target) ** 2)

    l1, (gp1, gv1) = jax.value_and_grad(loss_scan, argnums=(0, 1))(params, vin)
    l2, (gp2, gv2) = jax.value_and_grad(loss_impl, argnums=(0, 1))(params, vin)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(gp1), jax.tree_util.tree_leaves(gp2)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-3, atol=1e-7
        )
    np.testing.assert_allclose(np.asarray(gv1), np.asarray(gv2), rtol=2e-3,
                               atol=1e-7)


def test_batched_forwards_solver_knobs():
    """parallel_time_batched must forward damping/return_residual/state0:
    the batched HPF solve needs the same damped Newton as single-stream,
    and the per-stream residual certificate must be reachable
    (regression — these knobs used to be silently dropped)."""
    from diffwdf.models.diode_clipper import make_hpf_diode_clipper
    from diffwdf.ops.parallel_time import parallel_time_batched

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    hpf = make_hpf_diode_clipper(root, FS)
    params = {**hpf.init_params(), **root.init_params()}
    rng = np.random.default_rng(3)
    vin = jnp.asarray((2.0 * rng.standard_normal((4, 512))).astype(np.float32))

    refs = []
    for b in range(4):
        out, _ = hpf.process(params, hpf.init_state(), {"Vs": {"v": vin[b]}})
        refs.append(out)
    ref = jnp.stack(refs)

    got, resid = parallel_time_batched(
        hpf, params, {"Vs": {"v": vin}}, n_iters=30, damping=0.5,
        return_residual=True,
    )
    assert resid.shape == (4,)
    assert float(jnp.max(resid)) < 1e-3
    assert float(jnp.max(jnp.abs(got - ref))) < 3e-4
