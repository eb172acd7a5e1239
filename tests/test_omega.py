"""Wright-omega: accuracy vs the scipy oracle, gradients, quality knob."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.special import wrightomega

from diffwdf.roots.omega import wright_omega, wright_omega_u


def _oracle(x):
    return np.real(wrightomega(np.asarray(x, dtype=np.float64)))


def test_f32_accuracy_across_real_line():
    # the audio path needs x in roughly [-70, +40] (log(R*Is/Vt) +- a/Vt)
    x = np.linspace(-80.0, 40.0, 20001).astype(np.float32)
    got = np.asarray(wright_omega(jnp.asarray(x)))
    want = _oracle(x)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    assert np.nanmax(rel) < 5e-6, float(np.nanmax(rel))


def test_f64_accuracy():
    with jax.enable_x64(True):
        x = np.linspace(-200.0, 200.0, 40001)
        got = np.asarray(wright_omega(jnp.asarray(x, dtype=jnp.float64), iters=4))
        want = _oracle(x)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        assert np.max(rel) < 1e-13, float(np.max(rel))


def test_special_values():
    # omega(1) = 1 exactly; omega(-inf-ish) ~ e^x
    assert np.allclose(float(wright_omega(jnp.float32(1.0))), 1.0, atol=1e-6)
    assert np.allclose(
        float(wright_omega(jnp.float32(-30.0))), np.exp(-30.0), rtol=1e-5
    )


def test_gradient_is_implicit_and_correct():
    x = jnp.asarray(np.linspace(-10, 10, 101), dtype=jnp.float32)
    g = jax.vmap(jax.grad(lambda t: wright_omega(t)))(x)
    w = wright_omega(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(w / (1 + w)), rtol=1e-6)
    # finite-difference check in f64
    with jax.enable_x64(True):
        x0 = jnp.asarray(0.7, dtype=jnp.float64)
        eps = 1e-6
        fd = (wright_omega(x0 + eps, 4) - wright_omega(x0 - eps, 4)) / (2 * eps)
        an = jax.grad(lambda t: wright_omega(t, 4))(x0)
        np.testing.assert_allclose(float(fd), float(an), rtol=1e-7)


def test_quality_knob_monotone():
    x = jnp.asarray(np.linspace(-40, 30, 2001), dtype=jnp.float32)
    want = _oracle(np.asarray(x))
    errs = []
    for it in (1, 2, 3):
        got = np.asarray(wright_omega(x, it))
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        errs.append(np.max(rel))
    assert errs[2] <= errs[1] <= errs[0] * 1.001
    assert errs[0] < 2e-2  # "low" quality still audio-usable


def test_log_domain_variant():
    x = jnp.asarray(np.linspace(-60, 20, 501), dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(jnp.exp(wright_omega_u(x))),
        np.asarray(wright_omega(x)),
        rtol=1e-6,
    )


# ---------------------------------------------------------------------------
# Domain-edge contract (round-2 VERDICT item 8) and complex-plane capability
# ---------------------------------------------------------------------------


def test_f32_domain_edges():
    """The documented f32 real-line contract: graceful underflow to 0 for
    x <~ -87.3 (where e^x drops below FLT_MIN), finite and accurate up to the
    top of the f32 range, never NaN/Inf, gradients finite everywhere
    (including dw/dx -> 1 at the very top, where the naive w/(1+w) form
    would overflow to 0)."""
    x = jnp.asarray(
        [-3e38, -200.0, -104.0, -88.0, -87.0, 88.0, 1e4, 1e30, 3.4e38],
        dtype=jnp.float32,
    )
    w = np.asarray(wright_omega(x))
    assert np.all(np.isfinite(w))
    assert np.all(w >= 0.0)
    # underflow region: exactly zero (e^x < FLT_MIN), not garbage
    assert np.all(w[:3] == 0.0)
    # normal region: matches the f64 oracle
    want = _oracle(np.asarray(x[4:], dtype=np.float64))
    rel = np.abs(w[4:] - want) / np.maximum(np.abs(want), 1e-30)
    assert np.max(rel) < 5e-6, rel
    g = np.asarray(jax.vmap(jax.grad(lambda t: wright_omega(t)))(x))
    assert np.all(np.isfinite(g))
    assert g[-1] == pytest.approx(1.0, rel=1e-6)  # top-of-range slope
    assert np.all(g[:3] == 0.0)  # underflowed lanes: zero slope, not NaN


def test_f32_diode_regime():
    """The R*Is/Vt ~ 1e-7 regime the survey flags: x = log(R*Is/Vt) + a/Vt
    over the full element R range [180, 1e6] Ohm and wave range
    |a| <= 2.5 V (1N4148: Is = 4.352e-9, nabla = 1.906)."""
    Is, Vt = 4.352e-9, 25.85e-3 * 1.906
    a = np.linspace(-2.5, 2.5, 501)
    for R in (180.0, 4.7e3, 45e3, 1e6):
        x = (np.log(R * Is / Vt) + a / Vt).astype(np.float32)
        got = np.asarray(wright_omega(jnp.asarray(x)))
        want = _oracle(x.astype(np.float64))
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        assert np.max(rel) < 2e-6, (R, float(np.max(rel)))


def test_complex_plane_matches_scipy_strip():
    """Complex-plane capability parity with TOMS917 (``toms917.cpp:72-375``):
    the principal strip |Im z| <= pi including both branch cuts and the
    branch points matches scipy (which wraps TOMS917) to < 1e-13."""
    from diffwdf.roots.omega import wright_omega_complex

    with jax.enable_x64(True):
        xs = np.linspace(-12.0, 12.0, 121)
        ys = np.linspace(-np.pi, np.pi, 101)  # includes both cuts exactly
        X, Y = np.meshgrid(xs, ys)
        Z = (X + 1j * Y).astype(np.complex128)
        got = np.asarray(wright_omega_complex(jnp.asarray(Z), iters=3))
        want = wrightomega(Z)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        assert np.max(rel) < 1e-13, float(np.max(rel))


def test_complex_plane_cut_convention_and_special_points():
    """Points exactly ON the cuts reproduce TOMS917's observable branch
    selection (W_{-1} on the upper cut for -2 < x <= -1 and on the lower cut
    for x <= -2; W_0-side elsewhere), and the branch points are exact."""
    from diffwdf.roots.omega import wright_omega_complex

    with jax.enable_x64(True):
        pts = [
            -1.0 + 1j * np.pi, -1.0 - 1j * np.pi,  # branch points: w = -1
            -1.5 + 1j * np.pi, -1.5 - 1j * np.pi,  # W-1 / W0 halves
            -5.0 + 1j * np.pi, -5.0 - 1j * np.pi,  # W0 / W-1 halves
            -1.0001 + 1j * (np.pi - 1e-4),         # just inside the strip
            50.0 + 2.0j, 1e8 + 3.0j, 0.5 + 0.5j,
        ]
        for zc in pts:
            got = complex(np.asarray(
                wright_omega_complex(jnp.asarray(zc, dtype=jnp.complex128))
            ))
            want = complex(wrightomega(zc))
            rel = abs(got - want) / max(abs(want), 1e-300)
            assert rel < 1e-12, (zc, got, want)
        # the upper/lower cut convention really is asymmetric
        w_up = complex(np.asarray(wright_omega_complex(
            jnp.asarray(-1.5 + 1j * np.pi, dtype=jnp.complex128))))
        w_dn = complex(np.asarray(wright_omega_complex(
            jnp.asarray(-1.5 - 1j * np.pi, dtype=jnp.complex128))))
        assert w_up.real < -1.0 < w_dn.real  # W_{-1} above, W_0 side below


def test_condition_estimate():
    """kappa(z) = |z / (1 + omega)| — large near the branch points
    (TOMS917's condest analogue, ``toms917.cpp:372``)."""
    from diffwdf.roots.omega import wright_omega_condition

    with jax.enable_x64(True):
        k1 = float(np.asarray(wright_omega_condition(
            jnp.asarray(1.0 + 0.0j, dtype=jnp.complex128))))
        assert k1 == pytest.approx(0.5, rel=1e-12)  # omega(1) = 1
        kbp = float(np.asarray(wright_omega_condition(
            jnp.asarray(-1.0 + 1j * (np.pi - 1e-8), dtype=jnp.complex128))))
        assert kbp > 100.0  # ill-conditioned near the branch point
        # real-line path accepts floats too
        kr = float(np.asarray(wright_omega_condition(jnp.asarray(1.0))))
        assert kr == pytest.approx(0.5, rel=1e-5)
