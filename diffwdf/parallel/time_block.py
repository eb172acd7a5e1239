"""Time-block sharding: long-signal WDF processing across devices.

The WDF sample recursion is strictly sequential, but its state (one capacitor
``z`` per reactive element) is exponentially forgetting — the reference itself
exploits this by resetting state at 2048-sample chunk boundaries and skipping
the first 50 samples in the loss (``clipper_pot.py:110,232``).  We turn that
observation into a parallel decode scheme (BASELINE.json config 5):

- **overlap-save (parallel)**: split the signal into D contiguous blocks, one
  per device on the mesh "time" axis.  Each device prepends the last W
  samples of its left neighbor's block (fetched with one
  ``lax.ppermute``), scans W + T/D samples from zero state, and discards the
  W warm-up outputs.  Fully parallel; error decays like the circuit's state
  memory, exp(-W * 2*pi*fc / fs) for an RC corner at fc, so W is chosen from
  an error budget (see :func:`warmup_for_tolerance`).

- **exact (sequential handoff)**: the mathematically exact chain — device d
  starts from device d-1's final state, passed with ``ppermute``; D rounds,
  no speedup, used to validate the overlap mode's error bound.

Both are built on ``shard_map`` over a ``Mesh`` and work with any `Circuit`.
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..core.circuit import Circuit, _collect_impedance_controls

def warmup_for_tolerance(fc_hz: float, fs: float, tol: float = 1e-6) -> int:
    """Samples of warm-up needed for the state error to decay below ``tol``
    for a circuit whose slowest pole sits at fc_hz."""
    rate = 2.0 * math.pi * fc_hz / fs  # per-sample decay exponent
    return max(1, int(math.ceil(-math.log(tol) / rate)))


def time_block_process(
    circuit: Circuit,
    params,
    inputs: Dict[str, Dict[str, jnp.ndarray]],
    mesh: Mesh,
    *,
    warmup: int = 256,
    axis: str = "time",
):
    """Overlap-save parallel processing of a long signal.

    inputs: {node: {field: array[T]}} with T divisible by the mesh's time
    axis.  Returns outputs[T].  Device 0's warm-up prefix is silence (zero
    drive), matching the reference's cold-start-and-skip convention — but
    only *signal* fields are zeroed: impedance-control streams (a pot "R")
    must stay at valid values through the warm-up, else per-sample
    re-adaptation divides by zero (G = 1/R) and the NaN contaminates the
    carried state far past the discarded prefix.
    """
    D = mesh.shape[axis]
    state0 = circuit.init_state()

    # fields that are impedance controls of their tree node keep their
    # (wrapped-tail) values on device 0; everything else is a drive signal
    # and gets the cold-start zero prefix
    imp_raw: Dict[str, tuple] = {}
    _collect_impedance_controls(circuit.tree, imp_raw)
    imp_fields = {k: frozenset(v) for k, v in imp_raw.items()}

    def run(blk):  # blk: {node: {field: [T/D]}} local shard
        st0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (axis,), to="varying"), state0
        )

        def tail(x):
            return x[-warmup:]

        prev_tail = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(
                tail(x), axis, [(i, (i + 1) % D) for i in range(D)]
            ),
            blk,
        )
        idx = jax.lax.axis_index(axis)
        gate = jnp.where(idx == 0, 0.0, 1.0)
        ext = {
            node: {
                f: jnp.concatenate(
                    [
                        prev_tail[node][f]
                        if f in imp_fields.get(node, frozenset())
                        else gate * prev_tail[node][f],
                        x,
                    ]
                )
                for f, x in fields.items()
            }
            for node, fields in blk.items()
        }
        out, _ = circuit.process(params, st0, ext)
        return out[warmup:]

    spec = jax.tree_util.tree_map(lambda _: P(axis), inputs)
    fn = shard_map(run, mesh=mesh, in_specs=(spec,), out_specs=P(axis))
    return fn(inputs)


def make_time_block_train_step(
    circuit: Circuit,
    cfg,
    mesh: Mesh,
    *,
    warmup: int = 256,
    axis: str = "time",
    batch_axis: str = "data",
    input_node: str = "",
    trainable_filter=None,
):
    """Overlap-save BPTT: train on long sequences with their chunks
    sharded over the mesh ``axis`` (SURVEY §2.4 config 5's training side —
    round-4 left this axis inference-only).

    Semantics: each device prepends the last ``warmup`` samples of its left
    neighbor's block (one ``ppermute``), scans from zero state, and the
    warm-up outputs are EXCLUDED from the loss — the reference's own
    skip-50 practice (``clipper_pot.py:232``) generalized by
    :func:`warmup_for_tolerance`; device 0 skips ``cfg.skip_samples``
    exactly like the single-device loss.  With ``use_pre_emphasis`` the
    one-zero filter runs CONTINUOUSLY across shard boundaries (boundary
    samples are emphasized against the true neighbor sample); note the
    single-device ``make_loss_fn`` emphasizes the already-sliced chunk
    instead, so the two differ at exactly the one sample a restart would
    touch — the continuous form is the faithful filter semantics.  The global MSE+ESR is assembled
    from psum-reduced sums (the ESR energy normalization doesn't decompose
    per shard) and the parameter gradient is psummed, so the step's
    gradient equals the full-length single-scan BPTT gradient up to the
    overlap truncation error, which decays like the circuit's state memory
    exp(-warmup * 2 pi fc / fs).

    Returns (opt, train_step, eval_step) with
    ``train_step(params, opt_state, x, y) -> (params, opt_state, metrics)``
    on [T] arrays sharded P(axis) (T divisible by the axis size) — or, for
    2-axis DP x time training, [n_seq, T] arrays sharded
    P(batch_axis, axis): rows shard over the data axis, each row's chunks
    over the time axis, one step over the whole (data, time) mesh (the
    grad's implicit psum under check_vma=True covers both axes, and the
    loss sums psum over both).
    """
    import optax

    from ..training.losses import dloss_dse, global_loss_from_sums, pre_emphasis

    opt = optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=0.999)
    node = input_node or (
        "Vin" if "Vin" in circuit.init_params() else "Vs"
    )
    D = mesh.shape[axis]
    state0 = circuit.init_state()

    def local_sums(params, x, y, axes=(None,)):
        """Local masked sums.  All collectives stay OUTSIDE this function:
        an in-graph psum's AD transpose re-psums the replicated cotangent
        — a D-times double count (measured exactly 8x on the 8-device
        mesh).  The global loss is assembled from these sums after
        differentiation and the exact chain-rule factor applied (see
        data_parallel._make_dp_train_step_shard_map, same scheme).

        x, y: local [T_loc] (time-sharded only) or [n_loc, T_loc] (rows
        additionally sharded over the data axis; the overlap handoff runs
        per row along the time axis)."""
        st0 = jax.tree_util.tree_map(
            lambda s: jax.lax.pcast(s, axes, to="varying"), state0
        )
        prev = jax.lax.ppermute(
            x[..., -warmup:], axis, [(i, (i + 1) % D) for i in range(D)]
        )
        idx = jax.lax.axis_index(axis)
        gate = jnp.where(idx == 0, 0.0, 1.0)  # cold-start silence on dev 0
        ext = jnp.concatenate([gate * prev, x], axis=-1)

        def run_one(e1):
            out, _ = circuit.process(
                params, st0, {node: {"v": e1}},
                checkpoint=getattr(cfg, "checkpoint_scan", False),
                unroll=getattr(cfg, "unroll", 1),
            )
            return out

        out = (run_one(ext) if x.ndim == 1 else jax.vmap(run_one)(ext))
        if getattr(cfg, "use_pre_emphasis", False):
            # the one-zero filter must NOT restart at shard boundaries:
            # emphasize o with the true previous output (the overlap
            # region's last warm-up sample) and t with the left
            # neighbor's last target (one more tiny ppermute), then drop
            # the seed sample — matching the single-scan emphasis
            # everywhere except device 0's first sample, which keeps the
            # single-device x0-raw convention (and sits inside the
            # skip_samples mask in the reference configuration anyway)
            o = pre_emphasis(out[..., warmup - 1 :], axis=x.ndim - 1)[..., 1:]
            prev_y = jax.lax.ppermute(
                y[..., -1:], axis, [(i, (i + 1) % D) for i in range(D)]
            )
            t_ext = jnp.concatenate([gate * prev_y, y], axis=-1)
            t = pre_emphasis(t_ext, axis=x.ndim - 1)[..., 1:]
        else:
            o = out[..., warmup:]
            t = y
        keep = jnp.arange(x.shape[-1]) >= jnp.where(
            idx == 0, cfg.skip_samples, 0
        )
        mask = keep.astype(jnp.float32)
        se = jnp.sum(mask * jnp.square(o - t))
        te = jnp.sum(mask * jnp.square(t))
        n = jnp.sum(mask) * (1 if x.ndim == 1 else x.shape[0])
        # n varies only over the time axis (the mask reads
        # axis_index(time)); in the 2-axis case the count must still SUM
        # over the data axis (each data shard holds its own rows), so mark
        # it varying there for the typed psum
        missing = tuple(a for a in axes if a not in (axis, None))
        if missing:
            n = jax.lax.pcast(n, missing, to="varying")
        return se, (te, n)

    def _assemble(se_l, te_l, n_l, axes):
        se = jax.lax.psum(se_l, axes)
        te = jax.lax.psum(te_l, axes)
        n = jax.lax.psum(n_l, axes)
        m, e = global_loss_from_sums(se, te, n)
        return se, n, m, e

    def _make_locals(axes):
        def loss_local(params, x, y):
            se_l, (te_l, n_l) = local_sums(params, x, y, axes)
            _, _, m, e = _assemble(se_l, te_l, n_l, axes)
            return m + e, {"mse": m, "esr": e}

        def grads_local(params, x, y):
            (se_l, (te_l, n_l)), g = jax.value_and_grad(
                lambda p, xx, yy: local_sums(p, xx, yy, axes), has_aux=True
            )(params, x, y)
            se, n, m, e = _assemble(se_l, te_l, n_l, axes)
            # NO explicit psum on g: under check_vma=True (this
            # shard_map), grad wrt a replicated (P()) input already
            # carries the implicit psum over every axis the loss varies on
            # — the transpose of the invariant->varying broadcast — so g
            # here IS d(global se)/d(params).  (Verified against both a
            # minimal repro and the full-length scan oracle; contrast
            # data_parallel's check_vma=False path, where the grad is
            # local and the psum is explicit.)
            coef = dloss_dse(se, e, n)
            g = jax.tree_util.tree_map(lambda gg: coef * gg, g)
            if trainable_filter is not None:
                g = trainable_filter(g)
            return m + e, {"mse": m, "esr": e}, g

        return loss_local, grads_local

    two_axis = batch_axis in mesh.shape
    loss_1d, grads_1d = _make_locals((axis,))
    sm_grads = {
        1: shard_map(
            grads_1d, mesh=mesh, in_specs=(P(), P(axis), P(axis)),
            out_specs=(P(), P(), P()),
        )
    }
    sm_loss = {
        1: shard_map(
            loss_1d, mesh=mesh, in_specs=(P(), P(axis), P(axis)),
            out_specs=(P(), P()),
        )
    }
    if two_axis:
        loss_2d, grads_2d = _make_locals((batch_axis, axis))
        spec2 = P(batch_axis, axis)
        sm_grads[2] = shard_map(
            grads_2d, mesh=mesh, in_specs=(P(), spec2, spec2),
            out_specs=(P(), P(), P()),
        )
        sm_loss[2] = shard_map(
            loss_2d, mesh=mesh, in_specs=(P(), spec2, spec2),
            out_specs=(P(), P()),
        )

    def _pick(table, nd):
        if nd not in table:
            raise ValueError(
                f"{nd}-D inputs need the '{batch_axis}' mesh axis for the "
                f"row sharding; mesh axes: {tuple(mesh.shape)}"
            )
        return table[nd]

    @jax.jit
    def _train_jit(params, opt_state, x, y):
        loss, aux, g = _pick(sm_grads, x.ndim)(params, x, y)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **aux}

    def train_step(params, opt_state, x, y):
        return _train_jit(params, opt_state, x, y)

    # for the gradient-vs-long-scan validation tests
    train_step.grads_fn = jax.jit(
        lambda params, x, y: _pick(sm_grads, x.ndim)(params, x, y)
    )

    @jax.jit
    def eval_step(params, x, y):
        loss, aux = _pick(sm_loss, x.ndim)(params, x, y)
        return {"loss": loss, **aux}

    return opt, train_step, eval_step


def time_block_process_exact(
    circuit: Circuit,
    params,
    inputs: Dict[str, Dict[str, jnp.ndarray]],
    mesh: Mesh,
    *,
    axis: str = "time",
):
    """Exact sequential-handoff processing (validation reference).

    Every device scans its block D times in a round-robin; round d uses the
    true carried state once it has arrived from the left neighbor.  Exact but
    offers no speedup — it exists to measure the overlap mode's error.
    """
    D = mesh.shape[axis]
    state0 = circuit.init_state()

    def run(blk):
        idx = jax.lax.axis_index(axis)
        st0 = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (axis,), to="varying"), state0
        )

        def round_fn(d, state_in):
            # device d's state_out is true at round d (its init state is);
            # hand every final state right, and only device d+1 adopts it
            _, state_out = circuit.process(params, state_in, blk)
            handed = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(
                    x, axis, [(i, (i + 1) % D) for i in range(D)]
                ),
                state_out,
            )
            return jax.tree_util.tree_map(
                lambda h, s: jnp.where(idx == d + 1, h, s), handed, state_in
            )

        # propagate states: after round d, device d+1 has its true init state
        state = jax.lax.fori_loop(0, D - 1, round_fn, st0)
        out, _ = circuit.process(params, state, blk)
        return out

    spec = jax.tree_util.tree_map(lambda _: P(axis), inputs)
    fn = shard_map(run, mesh=mesh, in_specs=(spec,), out_specs=P(axis))
    return fn(inputs)
