"""Parallel-in-time WDF solving (Newton / DEER over the trajectory).

The per-sample recursion z_t = f(z_{t-1}, u_t) is a sequential chain of
tiny steps.  For large batches the chain is throughput-bound and the fused
kernel (ops.fused_circuit) is right; but for a SINGLE stream
(real-time/low-latency use, the reference plugin's regime, and
``engine="deer"`` serving in ``runtime.stream``) the chain is
latency-bound and the device idles.

This module instead solves the whole trajectory as one nonlinear system by
Newton iteration ("DEER": each sweep linearizes f around the current guess
trajectory and solves the resulting *linear* time-varying recurrence

    z_t = J_t z_{t-1} + c_t,   J_t = df/dz(ẑ_{t-1}, u_t),
                               c_t = f(ẑ_{t-1}, u_t) - J_t ẑ_{t-1}

exactly with an associative scan (log2 T depth).  Every sweep evaluates f and
its Jacobian at all T points in parallel, and quadratic convergence takes
~5-15 sweeps.  WDF state dimension S is tiny (one
entry per reactive element), so the scan composes (S x S) matrices.

Convergence: the WDF step map is contractive (|J| < 1 — bilinear-transform
reactances decay and diode clamping only shrinks the Jacobian), which makes
plain undamped Newton-over-trajectory robust here; a fixed iteration count
with a final residual check keeps everything jit-static.

Works for ANY `Circuit` (state pytree is raveled); gradients flow through the
iterations if needed, and the omega root's implicit-jvp keeps them cheap.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ..core.circuit import Circuit


def _combine(a, b):
    """Associative composition of affine maps z -> J z + c (rightward).
    Leaves carry a leading scan-block axis inside associative_scan."""
    Ja, ca = a
    Jb, cb = b
    J = jnp.einsum("...ij,...jk->...ik", Jb, Ja)
    c = jnp.einsum("...ij,...j->...i", Jb, ca) + cb
    return J, c


def parallel_time_process(
    circuit: Circuit,
    params,
    inputs: Dict[str, Dict[str, Any]],
    *,
    n_iters: int = 12,
    state0=None,
    damping: float = 1.0,
    static_controls=None,
    return_state: bool = False,
    return_residual: bool = False,
):
    """Solve the full sample recursion by Newton-over-trajectory.

    inputs: {node: {field: [T]}} (single stream; vmap externally for batch).
    static_controls: block-rate controls, adapted once (as in
    ``circuit.process``).  Returns outputs[T], followed by the final state
    if ``return_state`` and by the final trajectory residual
    max|f(z_{t-1}) - z_t| if ``return_residual``.
    Semantics match ``circuit.process`` up to solver tolerance.
    """
    if state0 is None:
        state0 = circuit.init_state()
    s0_vec, unravel = ravel_pytree(state0)
    S = s0_vec.shape[0]
    static_controls = static_controls or {}
    coeffs = circuit.adapt(params, static_controls)

    leaves = jax.tree_util.tree_leaves(inputs)
    T = leaves[0].shape[0]

    def merged(controls_t):
        out = {k: dict(v) for k, v in static_controls.items()}
        for node, fields in controls_t.items():
            out.setdefault(node, {}).update(fields)
        return out

    def step_vec(s_vec, controls_t):
        st, _ = circuit.step(params, coeffs, unravel(s_vec), merged(controls_t))
        out_vec, _ = ravel_pytree(st)
        return out_vec

    def out_of(s_vec, controls_t):
        _, waves = circuit.step(
            params, coeffs, unravel(s_vec), merged(controls_t)
        )
        return circuit.probe(waves)

    step_jac = jax.jacfwd(step_vec)

    def sweep(traj, _):
        # traj: (T, S) guess for z_1..z_T; prev holds z_0..z_{T-1}
        prev = jnp.concatenate([s0_vec[None], traj[:-1]], axis=0)
        F = jax.vmap(step_vec)(prev, inputs)
        J = jax.vmap(step_jac)(prev, inputs)
        c = F - jnp.einsum("tij,tj->ti", J, prev)
        Jc, cc = jax.lax.associative_scan(_combine, (J, c), axis=0)
        new_traj = jnp.einsum("tij,j->ti", Jc, s0_vec) + cc
        if damping != 1.0:
            # damped Newton: circuits with a marginal slow state mode (the
            # HPF clipper's series cap, |df/dz| -> 1) oscillate undamped;
            # damping=0.5 with ~2-3x n_iters converges there
            new_traj = traj + damping * (new_traj - traj)
        return new_traj, None

    traj0 = jnp.zeros((T, S), s0_vec.dtype)
    traj, _ = jax.lax.scan(sweep, traj0, None, length=n_iters)

    prev = jnp.concatenate([s0_vec[None], traj[:-1]], axis=0)
    result = (jax.vmap(out_of)(prev, inputs),)
    if return_state:
        result += (unravel(traj[-1]),)
    if return_residual:
        F = jax.vmap(step_vec)(prev, inputs)
        result += (jnp.max(jnp.abs(F - traj)),)
    return result if len(result) > 1 else result[0]


def parallel_time_process_implicit(
    circuit: Circuit,
    params,
    inputs: Dict[str, Dict[str, Any]],
    *,
    n_iters: int = 12,
    state0=None,
    damping: float = 1.0,
):
    """Like :func:`parallel_time_process`, but gradients use **implicit
    differentiation at the converged trajectory**: one adjoint pass through
    the linearized system instead of differentiating through the Newton
    sweeps (the implicit-function treatment of the whole trajectory solve).

    With G_t(traj, theta) = traj_t - f(traj_{t-1}, u_t, theta) = 0 at the
    solution, the cotangent solve is the backward affine recurrence
    lam_t = gbar_t + J_{t+1}^T lam_{t+1}, evaluated with a reversed
    associative scan; parameter/input cotangents follow from one VJP of
    sum_t lam_t . f(traj*_{t-1}, u_t, theta) with the trajectory held fixed.
    """
    if state0 is None:
        state0 = circuit.init_state()
    s0_vec, unravel = ravel_pytree(state0)
    S = s0_vec.shape[0]
    leaves = jax.tree_util.tree_leaves(inputs)
    T = leaves[0].shape[0]

    def step_vec(s_vec, controls_t, prm):
        coeffs = circuit.adapt(prm, {})
        st, _ = circuit.step(prm, coeffs, unravel(s_vec), controls_t)
        out_vec, _ = ravel_pytree(st)
        return out_vec

    def out_of(s_vec, controls_t, prm):
        coeffs = circuit.adapt(prm, {})
        _, waves = circuit.step(prm, coeffs, unravel(s_vec), controls_t)
        return circuit.probe(waves)

    @jax.custom_vjp
    def solve_traj(prm, inp):
        def sweep(traj, _):
            prev = jnp.concatenate([s0_vec[None], traj[:-1]], axis=0)
            F = jax.vmap(lambda s, u: step_vec(s, u, prm))(prev, inp)
            J = jax.vmap(jax.jacfwd(lambda s, u: step_vec(s, u, prm)))(prev, inp)
            c = F - jnp.einsum("tij,tj->ti", J, prev)
            Jc, cc = jax.lax.associative_scan(_combine, (J, c), axis=0)
            new_traj = jnp.einsum("tij,j->ti", Jc, s0_vec) + cc
            if damping != 1.0:  # same damped-Newton knob as the forward path
                new_traj = traj + damping * (new_traj - traj)
            return new_traj, None

        traj0 = jnp.zeros((T, S), s0_vec.dtype)
        traj, _ = jax.lax.scan(sweep, traj0, None, length=n_iters)
        return traj

    def solve_fwd(prm, inp):
        traj = solve_traj(prm, inp)
        return traj, (traj, prm, inp)

    def solve_bwd(res, gbar):
        traj, prm, inp = res
        prev = jnp.concatenate([s0_vec[None], traj[:-1]], axis=0)
        J = jax.vmap(jax.jacfwd(lambda s, u: step_vec(s, u, prm)))(prev, inp)
        # lam_t = gbar_t + J_{t+1}^T lam_{t+1}: reversed affine recurrence.
        # Composition uses transposed Jacobians shifted by one step; reverse
        # the time axis so the associative scan runs forward.
        Jt = jnp.swapaxes(J, -1, -2)  # (T, S, S)
        A = jnp.concatenate([Jt[1:], jnp.zeros_like(Jt[:1])], axis=0)[::-1]
        b = gbar[::-1]
        Ac, bc = jax.lax.associative_scan(_combine, (A, b), axis=0)
        lam = bc[::-1]  # lam_T..lam_1 reversed back
        # theta/input cotangents with traj held fixed
        def summed(prm_, inp_):
            F = jax.vmap(lambda s, u: step_vec(s, u, prm_))(prev, inp_)
            return jnp.sum(F * lam)

        gp, gi = jax.grad(summed, argnums=(0, 1))(prm, inp)
        return gp, gi

    solve_traj.defvjp(solve_fwd, solve_bwd)

    traj = solve_traj(params, inputs)
    prev = jnp.concatenate([s0_vec[None], traj[:-1]], axis=0)
    return jax.vmap(lambda s, u: out_of(s, u, params))(prev, inputs)


def parallel_time_batched(
    circuit: Circuit,
    params,
    inputs_batched: Dict[str, Dict[str, Any]],
    *,
    n_iters: int = 12,
    state0=None,
    damping: float = 1.0,
    return_residual: bool = False,
):
    """vmap of :func:`parallel_time_process` over a leading batch axis.

    Forwards the solver knobs: marginal slow-mode circuits (the HPF
    clipper) need ``damping`` here exactly as in the single-stream case,
    and ``return_residual=True`` yields a per-stream convergence
    certificate (outputs, residuals[B]).  ``state0`` (unbatched) seeds
    every stream.
    """

    def one(inp):
        return parallel_time_process(
            circuit, params, inp, n_iters=n_iters, state0=state0,
            damping=damping, return_residual=return_residual,
        )

    return jax.vmap(one)(inputs_batched)
