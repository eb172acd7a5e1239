"""Generic differentiable fused engine: fused-kernel forward, PARALLEL
backward.

The reference's training differentiates an unrolled per-sample TF graph
(``clipper_pot.py:245-269``) — strictly sequential in both directions.
This engine takes ANY adapted WDF `Circuit` (multi-state trees, R-type
adaptors, analytic or neural roots) off the sequential-BPTT scan path:

- **Forward**: the fused kernel (``ops.fused_circuit``) runs the whole
  recursion with the state in registers and additionally writes out the
  pre-step state trajectory z_{t-1} (the only residual the backward needs).

- **Backward** is the classic adjoint of a recurrence, evaluated WITHOUT a
  sequential loop, in plain XLA.  Writing one step as
  (z_t, o_t) = F(z_{t-1}, v_t, theta), the state cotangent lam_t = dL/dz_t
  obeys the reverse affine recurrence

      lam_{t-1} = J_t^T lam_t + A_t^T obar_t,        lam_T = zbar_f,

  with J_t = dF_z/dz and A_t = dF_o/dz *at the stored trajectory* — all of
  which are embarrassingly parallel over (B, T): S jvp basis passes through
  the batched step build J and A everywhere at once, one
  ``associative_scan`` over time solves the S x S affine recurrence in
  O(log T) depth, and the parameter/input cotangents are one more batched
  jvp + one grad of a scalar inner product

      g(theta) = sum_{b,t} <F(z_{t-1}, v_t, theta), (lam_t, obar_t)>,

  which XLA reverse-differentiates through ``circuit.adapt`` and the step in
  a single pass — so component values (R, C), diode physics, AND the neural
  root all receive exact cotangents.

Impedance-affecting drives may be batch-constant (``static_controls``),
PER-ROW, or PER-SAMPLE (``row_fields`` — the reference's measured-pot
workload, ``clipper_pot.py:113-124``): adaptation runs batched outside the
kernel and the resulting coefficients stream through the forward as (B,)
rows or (B, T) per-sample streams.  Remaining restrictions: one scalar
output probe; per-row/per-sample controls must not reach matrix-valued
coefficients (keep pots outside R-type adaptors, as the Tube Screamer's
drive pot is).

The backward's dense MLP products follow JAX's ambient matmul precision;
references and gradchecks set ``jax.default_matmul_precision("highest")``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp


def _batched_step(circuit, coeffs, params, static_controls, input_node):
    """The circuit step as a pure array function: (state leaves list, v) ->
    (new state leaves list, out), broadcasting over any leading shape (the
    scatter algebra and roots are elementwise / batched jnp ops)."""
    s_treedef = jax.tree_util.tree_structure(circuit.init_state())

    def step(st_vec, v):
        st = jax.tree_util.tree_unflatten(s_treedef, list(st_vec))
        controls = {k: dict(vv) for k, vv in (static_controls or {}).items()}
        controls.setdefault(input_node, {})
        controls[input_node]["v"] = v
        waves: Dict[str, Any] = {}
        a_root = circuit.tree.reflected(coeffs, st, controls, waves)
        r_up = coeffs[circuit.tree.name]["R"]
        b_root = circuit.root.reflect(a_root, r_up, params, controls)
        new_entries = circuit.tree.incident(coeffs, st, controls, waves, b_root)
        new_state = {**st, **new_entries}
        waves[circuit.root.name] = (a_root, b_root)
        S = len(st_vec)
        out_leaves = jax.tree_util.tree_leaves(new_state)[:S]
        return list(out_leaves), circuit.probe(waves)

    return step


def _affine_reverse_scan(M, b, lam_T, S):
    """Solve lam_{t-1} = M_t lam_t + b_t for t = T..1 in O(log T) depth.

    Layout: the S x S matrices live as NESTED TUPLES of (B, T) arrays, not
    as (B, T, S, S) tensors, so every combine is elementwise work over
    (B, T) instead of tiny S x S products on a trailing axis.

    M[i][j]: (B, T); b[i]: (B, T); lam_T[i]: (B,).
    Returns lam_prev, a list of S (B, T) arrays (lam_prev[k][:, t] = lam_t).
    """

    def combine(e1, e2):
        # scan order = flipped time; x_k = M_k x_{k-1} + b_k composition
        a1, b1 = e1
        a2, b2 = e2
        a = tuple(
            tuple(
                sum(a2[i][k] * a1[k][j] for k in range(S)) for j in range(S)
            )
            for i in range(S)
        )
        bb = tuple(
            sum(a2[i][k] * b1[k] for k in range(S)) + b2[i] for i in range(S)
        )
        return (a, bb)

    Mf = tuple(
        tuple(jnp.flip(M[i][j], axis=1) for j in range(S)) for i in range(S)
    )
    bf = tuple(jnp.flip(b[i], axis=1) for i in range(S))
    A, Bc = jax.lax.associative_scan(combine, (Mf, bf), axis=1)
    lam_f = [
        sum(A[i][k] * lam_T[k][:, None] for k in range(S)) + Bc[i]
        for i in range(S)
    ]
    return [jnp.flip(l, axis=1) for l in lam_f]


def make_fused_circuit_train_generic(
    circuit,
    *,
    input_node: str = "Vs",
    static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
    row_fields: tuple = (),
    interpret: Optional[bool] = None,
):
    """Build the differentiable fused engine for ``circuit``.

    Returns ``f(params, vin, z0_leaves) -> (out, zf_leaves)`` with a custom
    VJP: ``vin`` (B, T), ``z0_leaves`` a list of S (B,) arrays in
    state-pytree leaf order.  Gradients flow to ``params`` (all of them —
    tree components, diode physics, MLP weights), ``vin``, and
    ``z0_leaves``.  Semantics match ``circuit.process`` with hoisted
    adaptation.  ``interpret`` defaults to the device's kernel route.

    row_fields: static tuple of (node, field) pairs naming PER-ROW or
    PER-SAMPLE impedance controls — the reference's measured-pot training
    semantics (``clipper_pot.py:113-124``).  When non-empty the returned fn
    takes a fourth argument ``row_vals`` (one array per pair, data — zero
    cotangent): a (B,) value adapts once per row, a (B, T) value re-adapts
    EVERY SAMPLE — the adapted coefficients become (B, T) streams fed to
    the kernel alongside the drive signal, and the neural root's log-R
    conditioning follows the streamed tree-top impedance.
    """
    from .fused_circuit import _merge_controls, fused_circuit_process

    assert len(circuit.outputs) == 1, (
        "parallel-BPTT engine assumes one scalar output probe"
    )
    s_treedef = jax.tree_util.tree_structure(circuit.init_state())
    S = s_treedef.num_leaves

    def _rc(row_vals):
        rc: Dict[str, Dict[str, Any]] = {}
        for (node, field), val in zip(row_fields, row_vals):
            rc.setdefault(node, {})[field] = jnp.asarray(val, jnp.float32)
        return rc

    def fwd_kernel(params, vin, z0_leaves, row_vals, want_seq):
        state0 = jax.tree_util.tree_unflatten(s_treedef, list(z0_leaves))
        res = fused_circuit_process(
            circuit, params, vin, state0,
            input_node=input_node,
            static_controls=static_controls,
            row_controls=_rc(row_vals) or None,
            interpret=interpret,
            return_state_seq=want_seq,
        )
        zf_leaves = jax.tree_util.tree_leaves(res[1])[:S]
        return res[0], list(zf_leaves), res[2] if want_seq else None

    @jax.custom_vjp
    def f4(params, vin, z0_leaves, row_vals):
        out, zf, _ = fwd_kernel(params, vin, z0_leaves, row_vals, False)
        return out, zf

    def f_fwd(params, vin, z0_leaves, row_vals):
        out, zf, seqs = fwd_kernel(params, vin, z0_leaves, row_vals, True)
        return (out, zf), (params, vin, row_vals, seqs)

    def f_bwd(res, cot):
        params, vin, row_vals, seqs = res
        g_out, g_zf = cot  # (B, T), list of S (B,)
        lam_T = [jnp.asarray(g) for g in g_zf]  # S x (B,)

        # per-row controls enter the XLA path as (B, 1) so the adapted
        # coefficients broadcast against the (B, T) trajectory arrays;
        # per-SAMPLE (B, T) streams already line up
        rc1 = {
            n: {
                fld: (
                    jnp.asarray(v)
                    if jnp.ndim(v) == 2 else jnp.asarray(v)[:, None]
                )
                for fld, v in d.items()
            }
            for n, d in _rc(row_vals).items()
        }
        coeffs = circuit.adapt(params, _merge_controls(static_controls, rc1))
        step = _batched_step(circuit, coeffs, params, static_controls,
                             input_node)
        z_prev = seqs  # list of S (B, T) — state BEFORE each step

        # --- J_t, A_t everywhere at once: ONE linearization, S+1 tangent
        # pulls (the primal is evaluated once, not per basis vector).  All
        # results stay (B, T)-shaped — see _affine_reverse_scan for why ---
        _, lin = jax.linearize(step, z_prev, vin)
        Jz = [[None] * S for _ in range(S)]  # Jz[i][k] = dF_i/dz_k  (B, T)
        Ao = [None] * S  # Ao[k] = dF_o/dz_k  (B, T)
        for k in range(S):
            dz, do = lin(
                [jnp.full_like(z_prev[0], 1.0 if i == k else 0.0)
                 for i in range(S)],
                jnp.zeros_like(vin),
            )
            for i in range(S):
                Jz[i][k] = dz[i]
            Ao[k] = do

        M = tuple(  # J^T: M[k][i] = dF_i/dz_k
            tuple(Jz[i][k] for i in range(S)) for k in range(S)
        )
        b = tuple(Ao[k] * g_out for k in range(S))  # A^T obar
        lam_prev = _affine_reverse_scan(M, b, lam_T, S)  # lam_0..lam_{T-1}
        # lam for step i is lam_{i+1}: shift left, lam_T at the end
        lam_step = [
            jnp.concatenate([lam_prev[k][:, 1:], lam_T[k][:, None]], axis=1)
            for k in range(S)
        ]  # S x (B, T)

        # --- input cotangent: one more tangent pull along v --------------
        dz_dv, do_dv = lin(
            [jnp.zeros_like(z) for z in z_prev], jnp.ones_like(vin)
        )
        g_vin = (
            sum(dz_dv[k] * lam_step[k] for k in range(S)) + do_dv * g_out
        )

        # --- parameter cotangents: grad of a scalar inner product -------
        # (one reverse pass through adapt + the batched step; sums over
        # (B, T) without materializing per-step parameter gradients)
        def inner(p):
            c = circuit.adapt(p, _merge_controls(static_controls, rc1))
            st = _batched_step(circuit, c, p, static_controls, input_node)
            z_new, o = st(z_prev, vin)
            acc = jnp.sum(o * g_out)
            for k in range(S):
                acc = acc + jnp.sum(z_new[k] * lam_step[k])
            return acc

        g_params = jax.grad(inner)(params)
        g_z0 = [lam_prev[k][:, 0] for k in range(S)]
        return g_params, g_vin, g_z0, tuple(
            jnp.zeros_like(jnp.asarray(v)) for v in row_vals
        )

    f4.defvjp(f_fwd, f_bwd)
    if row_fields:

        def f(params, vin, z0_leaves, row_vals):
            assert len(row_vals) == len(row_fields), (
                f"expected {len(row_fields)} row_vals for {row_fields}"
            )
            return f4(params, vin, z0_leaves, tuple(row_vals))

    else:

        def f(params, vin, z0_leaves):
            return f4(params, vin, z0_leaves, ())

    return f
