"""Synthetic diode pretraining — the reference's pretraining workload
(``diode_pretraining.py``), redesigned for JAX.

Reference config parity: grid of 20 R decades x 1000 a-points, MLP of the
"NxH" family (orthogonal init), loss = MSE + ESR(N=1000), Adam lr 2e-5,
2000 epochs of shuffled minibatches (keras fit default batch 32).

The entire epoch (shuffle + all minibatch steps) is ONE compiled
``lax.scan``, and epochs are scanned too, so a full 2000-epoch pretraining is
a single device execution with no host round-trips.  The target generation is
a vectorized omega evaluation instead of a 20 000-iteration Python scipy loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..data.synthetic import pretraining_grid
from ..roots.diode import DiodeConfig
from ..roots.neural import mlp_apply, mlp_arch, mlp_init
from .losses import esr, mse


@dataclasses.dataclass
class PretrainConfig:
    n_layers: int = 2
    layer_size: int = 16
    epochs: int = 2000
    batch_size: int = 32
    learning_rate: float = 2e-5
    n_r: int = 20
    n_a: int = 1000
    a_span: float = 2.5
    seed: int = 0
    log_every: int = 0  # epochs between host-side metric reports (0 = end only)
    schedule: str = "const"  # "const" (reference parity) | "cosine" (warmup+decay)
    adam_eps: float = 1e-7  # keras default (reference trains with keras Adam)
    epochs_per_call: int = 2000  # split very long runs into several device
    # executions (single executions of many minutes can trip worker watchdogs)
    matmul_precision: str = "default"  # "default" | "high" | "highest" —
    # the MLP is tiny (2-in, 4..16 wide); reduced-precision matmul passes
    # ("default": TF32 on a GPU) put a floor under the reachable MSE;
    # "highest" (f32) lifts it at negligible cost for these shapes


def pretrain_diode(
    diode: DiodeConfig, cfg: PretrainConfig = PretrainConfig()
) -> Tuple[Dict, Tuple[str, ...], Dict[str, jnp.ndarray]]:
    """Train an MLP to mimic the closed-form diode pair.

    Returns (mlp_params, activations, metrics) where metrics carries the
    final/per-epoch loss curves (loss/mse/esr arrays of length epochs).
    """
    x_np, y_np = pretraining_grid(
        diode, n_r=cfg.n_r, n_a=cfg.n_a, a_span=cfg.a_span
    )
    x = jnp.asarray(x_np)
    y = jnp.asarray(y_np)[:, None]

    sizes, acts = mlp_arch(cfg.n_layers, cfg.layer_size)
    key = jax.random.PRNGKey(cfg.seed)
    key, init_key = jax.random.split(key)
    params = mlp_init(init_key, sizes)

    n = x.shape[0]
    n_batches = n // cfg.batch_size
    if cfg.schedule == "cosine":
        total_steps = cfg.epochs * n_batches
        lr = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, int(0.02 * total_steps), total_steps,
            end_value=cfg.learning_rate * 1e-2,
        )
    else:
        lr = cfg.learning_rate
    opt = optax.adam(lr, eps=cfg.adam_eps)
    opt_state = opt.init(params)

    def loss_fn(p, xb, yb):
        pred = mlp_apply(p, acts, xb)
        return mse(yb, pred) + esr(yb, pred, n_norm=cfg.n_a)

    def minibatch_step(carry, idx):
        p, s = carry
        xb = x[idx]
        yb = y[idx]
        loss, g = jax.value_and_grad(loss_fn)(p, xb, yb)
        updates, s = opt.update(g, s, p)
        p = optax.apply_updates(p, updates)
        return (p, s), loss

    def epoch_step(carry, ekey):
        p, s = carry
        perm = jax.random.permutation(ekey, n)[: n_batches * cfg.batch_size]
        idxs = perm.reshape(n_batches, cfg.batch_size)
        (p, s), losses = jax.lax.scan(minibatch_step, (p, s), idxs)
        # full-set metrics once per epoch (cheap: one fused forward)
        pred = mlp_apply(p, acts, x)
        m = {
            "loss": jnp.mean(losses),
            "mse": mse(y, pred),
            "esr": esr(y, pred, n_norm=cfg.n_a),
        }
        return (p, s), m

    @functools.partial(jax.jit, static_argnames=("n_epochs",))
    def train(params, opt_state, key, n_epochs):
        ekeys = jax.random.split(key, n_epochs)
        (params, opt_state), metrics = jax.lax.scan(
            epoch_step, (params, opt_state), ekeys
        )
        return params, opt_state, metrics

    chunks = []
    remaining = cfg.epochs
    ci = 0
    while remaining > 0:
        n_call = min(remaining, cfg.epochs_per_call)
        with jax.default_matmul_precision(cfg.matmul_precision):
            params, opt_state, m = train(
                params, opt_state, jax.random.fold_in(key, ci), n_call
            )
        chunks.append(jax.tree_util.tree_map(np.asarray, m))
        remaining -= n_call
        ci += 1
    metrics = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs), *chunks
    ) if len(chunks) > 1 else chunks[0]
    return params, acts, metrics


def pretrain_diode_multiseed(
    diode: DiodeConfig, cfg: PretrainConfig, seeds
) -> Tuple[Dict, Tuple[str, ...], Dict[str, jnp.ndarray]]:
    """Train the same architecture from several seeds IN ONE device execution.

    The per-step work is tiny (2-in MLPs), so the run time is dominated by the
    sequential minibatch-step count — vmapping the whole training over a seed
    axis makes extra seeds nearly free.  Returns (stacked_params, acts,
    stacked_metrics) with a leading seed axis on every leaf.
    """
    x_np, y_np = pretraining_grid(
        diode, n_r=cfg.n_r, n_a=cfg.n_a, a_span=cfg.a_span
    )
    x = jnp.asarray(x_np)
    y = jnp.asarray(y_np)[:, None]

    sizes, acts = mlp_arch(cfg.n_layers, cfg.layer_size)
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    init_keys, data_keys = jnp.moveaxis(
        jax.vmap(lambda k: jnp.stack(jax.random.split(k)))(keys), 1, 0
    )
    params = jax.vmap(lambda k: mlp_init(k, sizes))(init_keys)

    n = x.shape[0]
    n_batches = n // cfg.batch_size
    if cfg.schedule == "cosine":
        total_steps = cfg.epochs * n_batches
        lr = optax.warmup_cosine_decay_schedule(
            0.0, cfg.learning_rate, int(0.02 * total_steps), total_steps,
            end_value=cfg.learning_rate * 1e-2,
        )
    else:
        lr = cfg.learning_rate
    opt = optax.adam(lr, eps=cfg.adam_eps)
    opt_state = jax.vmap(opt.init)(params)

    def loss_fn(p, xb, yb):
        pred = mlp_apply(p, acts, xb)
        return mse(yb, pred) + esr(yb, pred, n_norm=cfg.n_a)

    def minibatch_step(carry, idx):
        p, s = carry
        loss, g = jax.value_and_grad(loss_fn)(p, x[idx], y[idx])
        updates, s = opt.update(g, s, p)
        p = optax.apply_updates(p, updates)
        return (p, s), loss

    def epoch_step(carry, ekey):
        p, s = carry
        perm = jax.random.permutation(ekey, n)[: n_batches * cfg.batch_size]
        idxs = perm.reshape(n_batches, cfg.batch_size)
        (p, s), losses = jax.lax.scan(minibatch_step, (p, s), idxs)
        pred = mlp_apply(p, acts, x)
        m = {
            "loss": jnp.mean(losses),
            "mse": mse(y, pred),
            "esr": esr(y, pred, n_norm=cfg.n_a),
        }
        return (p, s), m

    def train_one(params, opt_state, key, n_epochs):
        ekeys = jax.random.split(key, n_epochs)
        (params, opt_state), metrics = jax.lax.scan(
            epoch_step, (params, opt_state), ekeys
        )
        return params, opt_state, metrics

    train = jax.jit(
        jax.vmap(train_one, in_axes=(0, 0, 0, None)),
        static_argnames=("n_epochs",),
    )

    chunks = []
    remaining = cfg.epochs
    ci = 0
    while remaining > 0:
        n_call = min(remaining, cfg.epochs_per_call)
        call_keys = jax.vmap(lambda k: jax.random.fold_in(k, ci))(data_keys)
        with jax.default_matmul_precision(cfg.matmul_precision):
            params, opt_state, m = train(params, opt_state, call_keys, n_call)
        chunks.append(jax.tree_util.tree_map(np.asarray, m))
        remaining -= n_call
        ci += 1
    metrics = jax.tree_util.tree_map(
        lambda *xs: np.concatenate(xs, axis=1), *chunks
    ) if len(chunks) > 1 else chunks[0]
    return params, acts, metrics


def evaluate_pretrained(params, acts, diode: DiodeConfig, cfg: PretrainConfig):
    """Final MSE/ESR on the full grid — the numbers the reference records in
    its results table (``diode_pretraining.py:189-201``)."""
    x_np, y_np = pretraining_grid(diode, n_r=cfg.n_r, n_a=cfg.n_a, a_span=cfg.a_span)
    x = jnp.asarray(x_np)
    y = jnp.asarray(y_np)[:, None]
    with jax.default_matmul_precision(cfg.matmul_precision):
        pred = jax.jit(lambda p, xx: mlp_apply(p, acts, xx))(params, x)
    return {
        "mse": float(mse(y, pred)),
        "esr": float(esr(y, pred, n_norm=cfg.n_a)),
    }
