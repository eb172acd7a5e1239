"""Data-parallel training over the mesh "data" axis.

The reference trains single-device (SURVEY.md §2.4); here the [n_seq, T]
sequence batch is sharded over devices and the gradient all-reduce is inserted
by XLA from the shardings alone — no explicit collectives in user code.
Works for both the pretraining regression and circuit-in-the-loop training.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.circuit import Circuit
from ..training.circuit_train import CircuitTrainConfig, make_train_step
from .mesh import replicate_params, shard_batches


def make_dp_train_step(
    circuit: Circuit,
    cfg: CircuitTrainConfig,
    mesh: Mesh,
    trainable_filter: Optional[Callable] = None,
):
    """Data-parallel version of training.circuit_train.make_train_step.

    The returned step expects batches sharded over the "data" axis and
    replicated params/opt state; out-shardings keep them replicated so the
    gradient psum happens inside the compiled step.

    Engine note: under plain ``jit`` + shardings the fused engine's Pallas
    kernel would be traced at the GLOBAL batch, and the SPMD partitioner
    cannot split a Pallas custom call — it all-gathers the batch instead.
    So ``engine="fused_generic"`` runs the kernel *inside* ``shard_map``:
    each device traces it at its LOCAL batch, and the loss reassembles the
    exact global MSE+ESR from psum-reduced sums; math is identical to the
    single-device step up to f32 reduction order.
    """
    if cfg.engine == "fused_generic":
        return _make_dp_train_step_shard_map(
            circuit, cfg, mesh, trainable_filter
        )
    opt, train_step, eval_step = make_train_step(circuit, cfg, trainable_filter)

    repl = NamedSharding(mesh, P())

    dp_train = jax.jit(train_step, out_shardings=(repl, repl, repl))
    dp_eval = jax.jit(eval_step, out_shardings=repl)

    def prepare(params, opt_state, batches):
        return (
            replicate_params(params, mesh),
            replicate_params(opt_state, mesh),
            shard_batches(batches, mesh),
        )

    return opt, dp_train, dp_eval, prepare


def _make_dp_train_step_shard_map(
    circuit: Circuit,
    cfg: CircuitTrainConfig,
    mesh: Mesh,
    trainable_filter: Optional[Callable] = None,
    axis: str = "data",
):
    """DP for the Pallas-fused engines: per-device fused kernels under
    ``shard_map``, explicit gradient psum, optimizer on replicated params.

    The Pallas calls force ``check_vma=False``, under which the AD
    transpose of an in-graph ``psum`` is ``psum`` (not identity) — a
    D-times double count (measured: grads exactly 8x on the CPU mesh).  So
    every collective here stays OUTSIDE differentiation: the grad taken is
    of the LOCAL masked sum of squares se_l, then se/te/n and the grad are
    psummed once, and the chain-rule factor dL/dse = 1/n + e/(2 se) of the
    global loss L = se/n + sqrt(se/(te+eps)/n) is applied analytically
    (te is target-only, n is constant — se is the only param-dependent
    term, so this is exact, not an approximation)."""
    import jax.numpy as jnp
    import numpy as np

    from ..training.circuit_train import make_forward_fn
    from ..training.losses import dloss_dse, global_loss_from_sums, pre_emphasis

    opt = optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=0.999)
    forward = make_forward_fn(circuit, cfg)
    emphasis = (
        (lambda t: pre_emphasis(t, axis=1)) if cfg.use_pre_emphasis else None
    )

    def local_sums(params, batches):
        outs = forward(params, batches)
        o = outs[:, cfg.skip_samples :]
        t = batches["y"][:, cfg.skip_samples :]
        if emphasis is not None:
            o, t = emphasis(o), emphasis(t)
        se = jnp.sum(jnp.square(o - t))
        te = jnp.sum(jnp.square(t))
        n = jnp.asarray(t.size, jnp.float32)
        return se, (te, n)

    def _assemble(se_l, te_l, n_l):
        se = jax.lax.psum(se_l, axis)
        te = jax.lax.psum(te_l, axis)
        n = jax.lax.psum(n_l, axis)
        m, e = global_loss_from_sums(se, te, n)
        return se, n, m, e

    def grads_local(params, batches):
        (se_l, (te_l, n_l)), g = jax.value_and_grad(
            local_sums, has_aux=True
        )(params, batches)
        se, n, m, e = _assemble(se_l, te_l, n_l)
        g = jax.lax.psum(g, axis)
        coef = dloss_dse(se, e, n)
        g = jax.tree_util.tree_map(lambda x: coef * x, g)
        if trainable_filter is not None:
            g = trainable_filter(g)
        return m + e, {"mse": m, "esr": e}, g

    def loss_local(params, batches):
        se_l, (te_l, n_l) = local_sums(params, batches)
        _, _, m, e = _assemble(se_l, te_l, n_l)
        return m + e, {"mse": m, "esr": e}

    sm_grads = shard_map(
        grads_local, mesh=mesh, in_specs=(P(), P(axis)),
        out_specs=(P(), P(), P()), check_vma=False,
    )
    sm_loss = shard_map(
        loss_local, mesh=mesh, in_specs=(P(), P(axis)), out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def _dp_train_jit(params, opt_state, batches):
        loss, aux, g = sm_grads(params, batches)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **aux}

    def dp_train(params, opt_state, batches):
        return _dp_train_jit(params, opt_state, batches)

    # exposed for the identical-math tests: Adam's update is invariant to a
    # global gradient scale, so comparing post-step params alone cannot
    # catch collective double-counting — the raw psummed gradient can
    dp_train.grads_fn = jax.jit(sm_grads)

    @jax.jit
    def dp_eval(params, batches):
        loss, aux = sm_loss(params, batches)
        return {"loss": loss, **aux}

    def prepare(params, opt_state, batches):
        return (
            replicate_params(params, mesh),
            replicate_params(opt_state, mesh),
            shard_batches(batches, mesh),
        )

    return opt, dp_train, dp_eval, prepare


def train_clipper_dp(
    circuit: Circuit,
    params,
    train_batches,
    mesh: Mesh,
    val_batches=None,
    cfg: CircuitTrainConfig = CircuitTrainConfig(),
    trainable_filter: Optional[Callable] = None,
):
    """Data-parallel twin of training.circuit_train.train_clipper."""
    opt, dp_train, dp_eval, prepare = make_dp_train_step(
        circuit, cfg, mesh, trainable_filter
    )
    opt_state = opt.init(params)
    params, opt_state, train_batches = prepare(params, opt_state, train_batches)
    if val_batches is not None:
        val_batches = shard_batches(val_batches, mesh)
    history = {k: [] for k in ("loss", "mse", "esr", "val_loss", "val_mse", "val_esr")}
    for _ in range(cfg.epochs):
        params, opt_state, m = dp_train(params, opt_state, train_batches)
        for k in ("loss", "mse", "esr"):
            history[k].append(float(m[k]))
        if val_batches is not None:
            vm = dp_eval(params, val_batches)
            for k in ("loss", "mse", "esr"):
                history["val_" + k].append(float(vm[k]))
    return params, history
