"""Diode-pair root vs the scipy-based closed-form oracle.

The oracle re-evaluates Werner et al. eqn (45) with scipy.special.wrightomega
in float64 — numerically the same computation as the reference's target
generator (``diode_pretraining.py:39-60``) and TOMS917 root
(``Toms917DiodePair.h:51-58``).
"""

import jax.numpy as jnp
import numpy as np
from scipy.special import wrightomega

from diffwdf.roots.diode import (
    DiodeConfig,
    diode_1n4148_1u1d,
    diode_1n4148_2u3d,
    diode_pair_reflected,
    diode_pair_reflected_symmetric,
    shockley_current,
)


def oracle_eqn45(a, R, diode):
    """float64 scipy evaluation of the generalized diode-pair wave equation."""
    a = np.float64(a)
    Vt = diode.Vt * diode.nabla
    r_is_over_vt = diode.Is * R / Vt
    mu0 = diode.N_down if a >= 0 else diode.N_up
    mu1 = diode.N_up if a >= 0 else diode.N_down
    lam = np.sign(a)
    w0 = np.real(wrightomega(np.log(r_is_over_vt / mu0) + lam * a / (mu0 * Vt)))
    w1 = np.real(wrightomega(np.log(r_is_over_vt / mu1) - lam * a / (mu1 * Vt)))
    return a - 2 * Vt * lam * (mu0 * w0 - mu1 * w1)


def _grid():
    a = np.linspace(-2.5, 2.5, 201)
    Rs = 10.0 ** np.linspace(1, 9, 9)
    return a, Rs


def test_asymmetric_pair_matches_oracle():
    for diode in (diode_1n4148_1u1d, diode_1n4148_2u3d):
        a, Rs = _grid()
        Vt = diode.Vt * diode.nabla
        for R in Rs:
            got = np.asarray(
                diode_pair_reflected(
                    jnp.asarray(a, jnp.float32),
                    jnp.float32(R),
                    diode.Is,
                    Vt,
                    float(diode.N_up),
                    float(diode.N_down),
                )
            )
            want = np.array([oracle_eqn45(x, R, diode) for x in a])
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_symmetric_matches_asymmetric_when_equal():
    diode = diode_1n4148_1u1d
    a = jnp.asarray(np.linspace(-2.0, 2.0, 101), jnp.float32)
    Vt = diode.Vt * diode.nabla
    b1 = diode_pair_reflected(a, 1e4, diode.Is, Vt, 1.0, 1.0)
    b2 = diode_pair_reflected_symmetric(a, 1e4, diode.Is, Vt, 1.0)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2), atol=1e-6)


def test_odd_symmetry_1u1d():
    """Symmetric pair must be an odd function of the incident wave."""
    diode = diode_1n4148_1u1d
    a = jnp.asarray(np.linspace(0.01, 2.5, 64), jnp.float32)
    Vt = diode.Vt * diode.nabla
    b_pos = diode_pair_reflected(a, 4.7e4, diode.Is, Vt, 1.0, 1.0)
    b_neg = diode_pair_reflected(-a, 4.7e4, diode.Is, Vt, 1.0, 1.0)
    np.testing.assert_allclose(np.asarray(b_pos), -np.asarray(b_neg), atol=1e-6)


def test_transconductance_matches_shockley():
    """Recover i/v from waves (i = (a-b)/2R, v = (a+b)/2) and compare against
    the Shockley sinh curve — the reference's physics-consistency check
    (``plot_transconductance.py:39-52``)."""
    diode = diode_1n4148_1u1d
    R = 1000.0
    a = jnp.asarray(np.linspace(-10, 10, 201), jnp.float32)
    Vt = diode.Vt * diode.nabla
    b = diode_pair_reflected(a, R, diode.Is, Vt, 1.0, 1.0)
    v = 0.5 * (a + b)
    i = (a - b) / (2 * R)
    i_ideal = shockley_current(v, diode.Is, Vt)
    # compare where the curve is numerically meaningful
    mask = np.abs(np.asarray(v)) < 1.0
    np.testing.assert_allclose(
        np.asarray(i)[mask], np.asarray(i_ideal)[mask], rtol=2e-2, atol=1e-7
    )


def test_zero_input_fixed_point():
    diode = diode_1n4148_1u1d
    b = diode_pair_reflected(
        jnp.float32(0.0), 4.7e4, diode.Is, diode.Vt * diode.nabla, 1.0, 1.0
    )
    assert abs(float(b)) < 1e-7
