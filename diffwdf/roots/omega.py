"""Real-line Wright omega function in JAX.

The reference evaluates omega through the TOMS917 C++ library in complex
double precision (``/root/reference/modules/toms917/toms917.cpp:21-375``), but
its audio path only ever needs the real axis
(``plugin/src/dsp/diode_clipper/Toms917DiodePair.h:64-67`` takes
``real(wrightomega(real x))``), where omega is smooth and positive.  We
therefore solve  w + log(w) = x  directly on the real line:

- region-split initial guess (series at -inf, series about w=1, log-series at
  +inf) — same three asymptotic regimes TOMS917 uses for its first
  approximation, re-derived for the real axis;
- Newton iterations on u = log(w)  (solve e^u + u = x), which is globally
  convergent (e^u + u is convex increasing) and needs no branch-cut handling
  or directed rounding;
- gradients via the closed-form implicit derivative  dw/dx = w / (1 + w)
  (``custom_jvp``), NOT by differentiating through the iterations — the
  "implicit-function" treatment called out in the build plan.

Everything is shape-polymorphic jnp, vectorizes elementwise, and works in
float32 (accelerator) and float64 (CPU oracle tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "wright_omega",
    "wright_omega_u",
    "wright_omega_complex",
    "wright_omega_condition",
    "omega_quality_iters",
]

#: iteration counts for the quality knob (parity with chowdsp
#: ``wdft::DiodeQuality``: Best / Good / Low).
omega_quality_iters = {"best": 3, "good": 2, "low": 1}


def _initial_log_guess(x):
    """Initial guess for u = log(w), region-split.

    x <= -1 : w ~ e^x (1 - e^x)          => u ~ x + log1p(-e^x) ~ x - e^x
    |x| < 2 : w ~ 1 + (x-1)/2 + (x-1)^2/16   (series about the point w=1, x=1)
    x >= 2  : w ~ x - log(x) + log(x)/x      => u = log(w)
    The pieces overlap; selection by jnp.where keeps everything vectorized.
    """
    # large-negative branch (u-space, no underflow issues)
    u_neg = x - jnp.exp(x)
    # mid branch: series about x=1
    t = x - 1.0
    w_mid = 1.0 + 0.5 * t + 0.0625 * t * t
    u_mid = jnp.log(w_mid)
    # large-positive branch
    xs = jnp.maximum(x, 2.0)  # guard log for the unselected lanes
    lx = jnp.log(xs)
    w_pos = xs - lx + lx / xs
    u_pos = jnp.log(w_pos)
    u = jnp.where(x <= -1.0, u_neg, jnp.where(x >= 2.0, u_pos, u_mid))
    return u


def _newton_u(x, u, iters):
    """Newton on f(u) = e^u + u - x;  f'(u) = e^u + 1 >= 1 (never singular)."""
    for _ in range(iters):
        eu = jnp.exp(u)
        u = u - (eu + u - x) / (eu + 1.0)
    return u


@functools.partial(jax.custom_jvp, nondiff_argnums=(1,))
def wright_omega(x, iters: int = 3):
    """omega(x): the real solution w > 0 of w + log(w) = x.

    ``iters`` is the Newton iteration count (quality knob; 3 reaches f32
    machine precision everywhere on the real line, and ~1e-15 relative in f64
    for |x| <~ 700).
    """
    x = jnp.asarray(x)
    u = _initial_log_guess(x)
    u = _newton_u(x, u, iters)
    return jnp.exp(u)


@wright_omega.defjvp
def _wright_omega_jvp(iters, primals, tangents):
    (x,) = primals
    (dx,) = tangents
    w = wright_omega(x, iters)
    # implicit differentiation of w + log w = x:  dw/dx = w / (1 + w),
    # written as 1 / (1 + 1/w) so it cannot overflow at the top of the f32
    # range (w ~ 3e38 makes 1 + w infinite, zeroing the naive form; this
    # form limits correctly to 1 there and to 0 as w -> 0)
    return w, dx / (1.0 + 1.0 / w)


def wright_omega_u(x, iters: int = 3):
    """log(omega(x)) — useful when downstream math wants the log domain."""
    x = jnp.asarray(x)
    return _newton_u(x, _initial_log_guess(x), iters)


# ---------------------------------------------------------------------------
# Complex-plane evaluation (library-capability parity with TOMS917)
# ---------------------------------------------------------------------------


def wright_omega_complex(z, iters: int = 3):
    """Principal-strip complex Wright omega: solves w + Log(w) = z for
    Im(z) in [-pi, pi] (principal log).

    Capability parity with the reference's complex evaluator
    (``toms917.cpp:72-375``), independently derived: the same four asymptotic
    regimes (branch-point series about z = -1+i*pi, the e^z series between
    the cuts, the series about w=1, and the large-|z| log-series) feed Halley
    iterations on f(w) = w + Log w - z.  Conjugate symmetry
    omega(conj z) = conj omega(z) reduces everything to the upper half-strip.

    Differences from TOMS917, by design (see docs/architecture.md): no
    directed-rounding branch-cut regularization (XLA exposes no FP rounding
    modes; instead, points exactly ON the cuts Im(z) = +/-pi, Re(z) <= -1
    take an explicit W_{-1}/W_0 branch selection that reproduces TOMS917's
    observable convention bit-for-bit — validated against scipy, which wraps
    TOMS917), and inputs with |Im(z)| > pi are out of contract (the audio
    path and every consumer in this framework is real-line; the strip covers
    the function's entire branch structure).  Accuracy: < 1e-14 relative vs
    scipy over the strip in complex128 at iters=3, including both cuts and
    the branch points.
    """
    z = jnp.asarray(z)
    if not jnp.issubdtype(z.dtype, jnp.complexfloating):
        z = z.astype(jnp.complex128 if z.dtype == jnp.float64 else jnp.complex64)
    pi = jnp.pi
    flip = jnp.imag(z) < 0.0
    zz = jnp.where(flip, jnp.conj(z), z)  # upper half-strip
    x = jnp.real(zz)
    y = jnp.imag(zz)

    # The published region scheme of Lawrence/Corless/Jeffrey (Algorithm 917),
    # restricted to the folded strip 0 <= y <= pi:
    # region 1 — upper branch-point series about z0 = -1 + i*pi for
    # -2 < x <= 1, y > 1:  w = -1 + i p + p^2/3 - i p^3/36 + p^4/270 +
    # i p^5/4320,  p chosen with Im(p) >= 0 so i*p lands on the strip side.
    # conj(sqrt(conj(.))) selects the sqrt branch that is continuous from
    # BELOW the upper cut (arg p in [-pi/2, 0] inside the folded strip)
    p = jnp.conj(jnp.sqrt(jnp.conj(2.0 * (zz + 1.0 - 1j * pi))))
    ip = 1j * p
    w_bp = (-1.0 + ip + p * p / 3.0 - ip * p * p / 36.0
            + (p * p) * (p * p) / 270.0 + ip * (p * p) * (p * p) / 4320.0)
    # region 3 — between the cuts, series about -infinity:
    # w = e^z (1 - e^z + 3/2 e^2z - 8/3 e^3z + 125/24 e^4z)
    ez = jnp.exp(jnp.where(x < 0.0, zz, -1.0))  # overflow guard, unselected lanes
    w_neg = ez * (1.0 + ez * (-1.0 + ez * (1.5 + ez * (-8.0 / 3.0 + ez * 125.0 / 24.0))))
    # region 4 — "mushroom" series about z = 1:
    # w = 1/2 + z/2 + t^2 (1/16 - t/192 - t^2/3072 + 13 t^3/61440), t = z-1
    t = zz - 1.0
    w_mid = (0.5 + 0.5 * zz
             + t * t * (1.0 / 16.0 + t * (-1.0 / 192.0
                        + t * (-1.0 / 3072.0 + t * 13.0 / 61440.0))))
    # region 7 — series about infinity: w = z - L + L/z (1 + (L/2 - 1)/z
    # + (L^2/3 - 3L/2 + 1)/z^2),  L = Log z
    zs = jnp.where(jnp.abs(zz) >= 2.0, zz, 2.0 + 0.0j)
    L = jnp.log(zs)
    w_big = (zs - L + (L / zs) * (1.0 + (0.5 * L - 1.0) / zs
             + (L * L / 3.0 - 1.5 * L + 1.0) / (zs * zs)))

    in_bp = (x > -2.0) & (x <= 1.0) & (y > 1.0)
    in_neg = x <= -2.0
    in_mid = ((x > -2.0) & (x <= 1.0) & (y <= 1.0)) | (
        (x > -2.0) & ((x - 1.0) * (x - 1.0) + y * y <= pi * pi)
    )
    w = jnp.where(
        in_bp, w_bp,
        jnp.where(in_neg, w_neg, jnp.where(in_mid, w_mid, w_big)),
    )
    for _ in range(iters):  # Halley on f(w) = w + Log w - z
        f = w + jnp.log(w) - zz
        fp = 1.0 + 1.0 / w
        # f == 0 happens exactly at the branch point w = -1 (where fp = 0
        # too); the guess is already exact there, so skip the update
        step = f / (fp + 0.5 * f / (w * w * jnp.where(fp == 0, 1.0, fp)))
        w = jnp.where(f == 0, w, w - step)
    w = jnp.where(flip, jnp.conj(w), w)

    # Cut ownership: exactly ON a cut (Im z = +/-pi, Re z <= -1) TOMS917's
    # observable convention (inherited by scipy) follows its region
    # boundaries, asymmetrically: the W_{-1} branch (large negative real,
    # where conjugate symmetry does NOT apply) is returned on the UPPER cut
    # for -2 < x <= -1 (region 1's from-above continuation) and on the LOWER
    # cut for x <= -2 (region 6's wing series); the other halves get the
    # W_0-side value.  We match that observable behavior exactly.  For the
    # W_{-1} lanes, solve v - log v = -x for v = -w: branch-point series
    # guess near x = -1, asymptotic guess far out, then guarded Newton (the
    # derivative 1 - 1/v vanishes at the branch point itself, where v = 1).
    xr = jnp.real(z)
    on_w1_cut = ((jnp.imag(z) == -pi) & (xr <= -2.0)) | (
        (jnp.imag(z) == pi) & (xr > -2.0) & (xr <= -1.0)
    )
    s = jnp.maximum(-xr - 1.0, 0.0)
    q = jnp.sqrt(2.0 * s)
    v_bp = 1.0 + q + q * q / 3.0 + (11.0 / 72.0) * q * q * q
    nx = jnp.maximum(-xr, 2.0)
    v_far = nx + jnp.log(nx)
    v = jnp.where(s <= 1.0, v_bp, v_far)
    for _ in range(iters + 3):
        g = v - jnp.log(v) + xr
        gp = 1.0 - 1.0 / v
        v = jnp.where(jnp.abs(gp) > 1e-12, v - g / jnp.where(gp == 0, 1.0, gp), v)
    w_lower = (-v).astype(w.dtype)
    return jnp.where(on_w1_cut, w_lower, w)


def wright_omega_condition(z, iters: int = 3):
    """Relative condition number kappa(z) = |z * omega'(z) / omega(z)|
    = |z / (1 + omega(z))| — the library-level conditioning diagnostic
    (TOMS917 returns a residual-based condition estimate,
    ``toms917.cpp:372``; this is the closed-form equivalent).  Large near the
    branch points z = -1 +/- i*pi where 1 + omega -> 0."""
    z = jnp.asarray(z)
    if jnp.issubdtype(z.dtype, jnp.complexfloating):
        w = wright_omega_complex(z, iters)
    else:
        w = wright_omega(z, iters)
    return jnp.abs(z / (1.0 + w))
