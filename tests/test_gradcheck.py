"""Finite-difference gradient checks through the full sample recursion.

SURVEY §4's test-strategy item: the reference never verifies its gradients;
here we check d(loss)/d(component values), d/d(diode physics), and
d/d(MLP weights) against central differences in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.models.simple_circuits import make_rc_lowpass
from diffwdf.roots.neural import NeuralDiodeRoot

FS = 48000.0


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float64)), tree
    )


def _fd_check(loss_fn, params, path, rel_tol, eps):
    """Central finite difference on params[path[0]][path[1]] vs autodiff."""
    with jax.enable_x64(True):
        p64 = _to64(params)
        g = jax.grad(loss_fn)(p64)
        g_val = float(g[path[0]][path[1]])

        def shift(d):
            p = jax.tree_util.tree_map(lambda x: x, p64)
            p[path[0]] = dict(p[path[0]])
            p[path[0]][path[1]] = p64[path[0]][path[1]] + d
            return p

        fd = (loss_fn(shift(eps)) - loss_fn(shift(-eps))) / (2 * eps)
        assert np.isfinite(g_val)
        np.testing.assert_allclose(g_val, float(fd), rtol=rel_tol)


def test_component_gradients_rc():
    ckt = make_rc_lowpass(FS)
    state = ckt.init_state()
    vin = jnp.asarray(np.random.default_rng(0).normal(size=64))

    def loss(p):
        st = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.result_type(p["R1"]["R"])), state
        )
        out, _ = ckt.process(p, st, {"Vs": {"v": vin}})
        return jnp.mean(out**2)

    params = ckt.init_params()
    _fd_check(loss, params, ("R1", "R"), 1e-4, 1e-2)
    _fd_check(loss, params, ("C1", "C"), 1e-4, 1e-12)


def test_diode_physics_gradients():
    """Gradients through the Wright-omega root solve w.r.t. Is and Vt —
    the implicit-differentiation path."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    state = ckt.init_state()
    vin = jnp.asarray(2.0 * np.random.default_rng(1).normal(size=64))

    def loss(p):
        st = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.result_type(p["dp"]["Is"])), state
        )
        out, _ = ckt.process(p, st, {"Vs": {"v": vin}})
        return jnp.mean(out**2)

    params = {**ckt.init_params(), **root.init_params()}
    _fd_check(loss, params, ("dp", "Is"), 2e-3, 1e-13)
    _fd_check(loss, params, ("dp", "Vt"), 2e-3, 1e-7)
    _fd_check(loss, params, ("Vs", "R"), 2e-3, 1e-1)


def test_neural_root_weight_gradients():
    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt = make_diode_clipper(root, FS)
    state = ckt.init_state()
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(0))}
    vin = jnp.asarray(np.random.default_rng(2).normal(size=48))

    def loss(p):
        st = jax.tree_util.tree_map(
            lambda x: x.astype(p["dp"]["layers"][0]["kernel"].dtype), state
        )
        out, _ = ckt.process(p, st, {"Vs": {"v": vin}})
        return jnp.mean(out**2)

    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)), params
        )
        g = jax.grad(loss)(p64)
        k = np.asarray(g["dp"]["layers"][0]["kernel"])
        assert np.all(np.isfinite(k)) and np.any(np.abs(k) > 0)
        # FD on one weight entry
        eps = 1e-6

        def shifted(d):
            p = jax.tree_util.tree_map(lambda x: x, p64)
            kern = p["dp"]["layers"][0]["kernel"]
            p["dp"]["layers"][0] = dict(p["dp"]["layers"][0])
            p["dp"]["layers"][0]["kernel"] = kern.at[0, 0].add(d)
            return p

        fd = (loss(shifted(eps)) - loss(shifted(-eps))) / (2 * eps)
        np.testing.assert_allclose(k[0, 0], float(fd), rtol=1e-4)


def test_checkpointed_scan_gradients_match():
    """jax.checkpoint (remat) through the scan changes memory, not math."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    state = ckt.init_state()
    params = {**ckt.init_params(), **root.init_params()}
    vin = jnp.asarray(np.random.default_rng(3).normal(size=128).astype(np.float32))

    def loss(p, ckpt):
        out, _ = ckt.process(p, state, {"Vs": {"v": vin}}, checkpoint=ckpt)
        return jnp.mean(out**2)

    g1 = jax.grad(lambda p: loss(p, False))(params)
    g2 = jax.grad(lambda p: loss(p, True))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5)
