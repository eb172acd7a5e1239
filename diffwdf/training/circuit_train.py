"""Circuit-in-the-loop training: gradients through the WDF sample recursion.

The flagship workload (reference ``clipper_pot.py``): a neural diode root is
fine-tuned *inside* the clipper circuit on measured (or synthesized) data,
with the source voltage AND source resistance driven per sample (the pot).

Reference parity: sequence chunks of 2048 samples treated as a batch
(``clipper_pot.py:58-80``), loss = MSE + ESR over samples [50:] (state
warm-up skip, ``:232``), Adam lr 1e-4 beta1 0.5 (``:180``), optional
pre-emphasis.  The sequence batch is vmapped over the scan (one compiled
step for all chunks), gradients flow through ``lax.scan`` with optional
rematerialization, and the epoch loop is host-side only for metric
logging.

Also includes the simple-circuit component-fitting workloads
(``voltage_divider.py`` / ``lpf.py``): learning R/C values with per-parameter
optimizers (optax.multi_transform standing in for the reference's two
separate Adam instances, ``lpf.py:79-99``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..core.circuit import Circuit
from .losses import esr, mse, pre_emphasis


@dataclasses.dataclass
class CircuitTrainConfig:
    epochs: int = 501
    batch_size: int = 2048  # samples per sequence chunk
    learning_rate: float = 1e-4
    beta1: float = 0.5
    skip_samples: int = 50
    use_pre_emphasis: bool = False
    checkpoint_scan: bool = False  # remat the scan body (memory vs flops)
    unroll: int = 1  # scan unroll factor (compiled-code width; ~1.6x fwd at 8)
    log_every: int = 5
    max_chunks: Optional[int] = None  # cap sequences per split (for tests)
    engine: str = "scan"  # "scan" (general BPTT) | "fused_generic"
    # (ops.parallel_bptt: fused-kernel forward + parallel XLA backward; ANY
    # circuit/root, full param cotangents incl. components, per-row "r0"
    # and per-sample "r" pot data)
    pot_node: str = ""  # node the "r0"/"r" pot stream drives ("" = auto:
    # "Vs" for the clipper family; set "R6" for a Tube Screamer drive-pot
    # sweep)
    pot_field: str = "R"


def make_clipper_batches(data: Dict[str, np.ndarray], batch_size: int, max_chunks=None):
    """{"x","r","y"} streams -> [n_seq, T] arrays (reference ``batch_data``).

    R-hoisting: the pot resistance is piecewise-constant per measurement file
    (``dataimport.py:109`` parses one R per CSV), so almost every chunk has a
    single R value.  When that holds for ALL chunks, the "r" stream collapses
    to a per-chunk scalar "r0" [n_seq] and impedance adaptation runs ONCE per
    chunk outside the scan (SURVEY.md §7) instead of per sample inside it —
    identical math, ~an order of magnitude less per-step work.  Chunks with a
    genuinely time-varying R keep the per-sample "r" stream.
    """
    n = len(data["x"]) // batch_size
    if max_chunks is not None:
        n = min(n, max_chunks)
    out = {
        k: jnp.asarray(np.asarray(v)[: n * batch_size].reshape(n, batch_size))
        for k, v in data.items()
    }
    if "r" in out and n > 0:
        r_np = np.asarray(out["r"])
        const = np.all(r_np == r_np[:, :1], axis=1)
        if const.all():
            out["r0"] = jnp.asarray(r_np[:, 0])
            del out["r"]
    return out


def clipper_forward(circuit: Circuit, params, batches, checkpoint=False,
                    unroll=1, pot_node: str = "Vs"):
    """Run the training clipper over a [n_seq, T] batch of (v[, R]) drives.

    State resets at chunk boundaries (reference behavior: ``Vs.reset();
    C.reset()`` per forward, ``clipper_pot.py:110-111``).  With an "r"
    stream the source resistance is driven per sample and the tree
    re-adapts inside the scan (the reference pot, ``clipper_pot.py:114-117``);
    without one (e.g. the fixed-R HPF topology) adaptation happens once.
    The drive node is auto-detected ("Vin" for the Tube Screamer, else
    "Vs"); the r/r0 streams target ``pot_node`` (default the clipper's
    "Vs" source; "R6" for a Tube Screamer drive-pot sweep).
    Returns outputs [n_seq, T].
    """
    state0 = circuit.init_state()
    drive_r = "r" in batches
    hoisted_r = "r0" in batches  # per-chunk constant R: adapt once per chunk
    node = "Vin" if "Vin" in circuit.init_params() else "Vs"

    def run_one(v, r=None):
        inputs = {node: {"v": v}}
        static = None
        if drive_r:
            inputs[pot_node] = {**inputs.get(pot_node, {}), "R": r}
        elif hoisted_r:
            static = {pot_node: {"R": r}}
        out, _ = circuit.process(
            params, state0, inputs, static_controls=static,
            adapt_per_sample=drive_r, checkpoint=checkpoint, unroll=unroll,
        )
        return out

    if drive_r:
        return jax.vmap(run_one)(batches["x"], batches["r"])
    if hoisted_r:
        return jax.vmap(run_one)(batches["x"], batches["r0"])
    return jax.vmap(run_one)(batches["x"])


def _make_fused_generic_forward(circuit: Circuit, cfg: CircuitTrainConfig):
    """Forward via the generic differentiable fused engine
    (ops.parallel_bptt): any circuit topology / root family, exact
    cotangents for every param.  Pot data — hoisted per-row "r0" (B,) (the
    reference's measured-data regime, one R per CSV chunk) or genuinely
    per-sample "r" (B, T) — drives the node named by ``cfg.pot_node``
    (default "Vs") through per-row or per-sample scatter coefficients."""
    from ..ops.parallel_bptt import make_fused_circuit_train_generic

    init_p = circuit.init_params()
    input_node = "Vin" if "Vin" in init_p else "Vs"
    pot_node = cfg.pot_node or "Vs"
    f_plain = make_fused_circuit_train_generic(circuit, input_node=input_node)
    f_row = make_fused_circuit_train_generic(
        circuit, input_node=input_node,
        row_fields=((pot_node, cfg.pot_field),),
    )
    s_leaves = jax.tree_util.tree_leaves(circuit.init_state())

    def forward(params, batches):
        v = batches["x"]
        r = batches.get("r", batches.get("r0"))
        z0 = [
            jnp.broadcast_to(
                jnp.asarray(l, jnp.float32).reshape(()), (v.shape[0],)
            )
            for l in s_leaves
        ]
        if r is not None:
            out, _ = f_row(params, v, z0, (r,))
        else:
            out, _ = f_plain(params, v, z0)
        return out

    return forward


def make_forward_fn(circuit: Circuit, cfg: CircuitTrainConfig):
    """The engine-selected training forward: (params, batches) -> outs."""
    if cfg.engine == "fused_generic":
        return _make_fused_generic_forward(circuit, cfg)
    if cfg.engine != "scan":
        raise ValueError(f"unknown engine {cfg.engine!r} (scan | fused_generic)")
    return lambda params, batches: clipper_forward(
        circuit, params, batches, cfg.checkpoint_scan, cfg.unroll,
        pot_node=cfg.pot_node or "Vs",
    )


def make_loss_fn(circuit: Circuit, cfg: CircuitTrainConfig):
    """Build the training loss (params, batches) -> (loss, {"mse","esr"}).

    NOTE for mesh use: do NOT wrap this in psums inside a differentiated
    shard_map body — the AD transpose of an in-graph psum re-psums the
    replicated cotangent (a D-times double count).  The data-parallel and
    time-block training steps instead differentiate LOCAL sums and apply
    the global chain-rule factor after the collective
    (``parallel.data_parallel._make_dp_train_step_shard_map``).
    """
    emphasis = (lambda t: pre_emphasis(t, axis=1)) if cfg.use_pre_emphasis else None
    forward = make_forward_fn(circuit, cfg)

    def loss_fn(params, batches):
        outs = forward(params, batches)
        y = batches["y"]
        o = outs[:, cfg.skip_samples :]
        t = y[:, cfg.skip_samples :]
        if emphasis is not None:
            o, t = emphasis(o), emphasis(t)
        m = mse(t, o)
        e = esr(t, o)
        return m + e, {"mse": m, "esr": e}

    return loss_fn


def make_train_step(
    circuit: Circuit,
    cfg: CircuitTrainConfig,
    trainable_filter: Optional[Callable] = None,
):
    """Build the jitted (params, opt_state, batches) -> ... training step."""
    opt = optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=0.999)
    loss_fn = make_loss_fn(circuit, cfg)

    @jax.jit
    def train_step(params, opt_state, batches):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batches)
        if trainable_filter is not None:
            grads = trainable_filter(grads)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **aux}

    @jax.jit
    def eval_step(params, batches):
        loss, aux = loss_fn(params, batches)
        return {"loss": loss, **aux}

    return opt, train_step, eval_step


def train_clipper(
    circuit: Circuit,
    params,
    train_batches,
    val_batches=None,
    cfg: CircuitTrainConfig = CircuitTrainConfig(),
    trainable_filter: Optional[Callable] = None,
    on_epoch: Optional[Callable] = None,
):
    """Full training loop.  Returns (params, history) with the reference's
    history keys (loss/mse/esr + val_ variants, ``clipper_pot.py:233-240``)."""
    opt, train_step, eval_step = make_train_step(circuit, cfg, trainable_filter)
    opt_state = opt.init(params)
    history = {k: [] for k in ("loss", "mse", "esr", "val_loss", "val_mse", "val_esr")}
    for epoch in range(cfg.epochs):
        params, opt_state, m = train_step(params, opt_state, train_batches)
        for k in ("loss", "mse", "esr"):
            history[k].append(float(m[k]))
        if val_batches is not None:
            vm = eval_step(params, val_batches)
            for k in ("loss", "mse", "esr"):
                history["val_" + k].append(float(vm[k]))
        if on_epoch is not None and cfg.log_every and epoch % cfg.log_every == 0:
            on_epoch(epoch, params, history)
    return params, history


def joint_fit_clipper(
    circuit: Circuit,
    params,
    train_batches,
    component_lrs: Dict[str, float],
    cfg: CircuitTrainConfig = CircuitTrainConfig(),
    mlp_lr: Optional[float] = None,
):
    """Joint physics+neural training: learn component values (R/C, clip-
    constrained per element bounds) AND the neural root weights in-circuit,
    simultaneously.

    The reference has two disjoint workloads — neural-root training with
    frozen components (``clipper_pot.py:245-269``) and component fitting with
    an analytic root (``lpf.py:79-99``) — but never combines them; fully
    differentiable physics makes the combination one optimizer call here.
    ``component_lrs`` maps "Node.field" (e.g. "Vs.R", "C.C") to per-parameter
    Adam learning rates (the reference's separate-optimizers trick); the
    neural root subtree trains at ``mlp_lr`` (default cfg.learning_rate);
    everything else is frozen.

    Returns (params, history) where history carries loss/mse/esr plus the
    per-epoch trajectory of every fitted component value.
    """
    mlp_lr = cfg.learning_rate if mlp_lr is None else mlp_lr
    root_name = circuit.root.name

    def label_of(path):
        key = ".".join(str(getattr(p, "key", p)) for p in path)
        if key.startswith(root_name + ".") or key == root_name:
            return "mlp"
        # component params are two levels: Node.field
        two = ".".join(key.split(".")[:2])
        return two if two in component_lrs else "frozen"

    labels = jax.tree_util.tree_map_with_path(
        lambda p, x: label_of(p), params
    )
    transforms = {
        k: optax.adam(lr, b1=cfg.beta1) for k, lr in component_lrs.items()
    }
    transforms["mlp"] = optax.adam(mlp_lr, b1=cfg.beta1)
    transforms["frozen"] = optax.set_to_zero()
    opt = optax.multi_transform(transforms, labels)
    opt_state = opt.init(params)

    emphasis = (lambda t: pre_emphasis(t, axis=1)) if cfg.use_pre_emphasis else None
    generic_forward = (
        _make_fused_generic_forward(circuit, cfg)
        if cfg.engine == "fused_generic" else None
    )

    def loss_fn(p, batches):
        if generic_forward is not None:
            outs = generic_forward(p, batches)
        else:
            outs = clipper_forward(circuit, p, batches, cfg.checkpoint_scan,
                                   cfg.unroll)
        o = outs[:, cfg.skip_samples:]
        t = batches["y"][:, cfg.skip_samples:]
        if emphasis is not None:
            o, t = emphasis(o), emphasis(t)
        m = mse(t, o)
        e = esr(t, o)
        return m + e, {"mse": m, "esr": e}

    @jax.jit
    def step(p, s, batches):
        (loss, aux), g = jax.value_and_grad(loss_fn, has_aux=True)(p, batches)
        updates, s = opt.update(g, s, p)
        p = optax.apply_updates(p, updates)
        p = circuit.constrain(p)  # element bounds (R in [180, 1e6] etc.)
        return p, s, {"loss": loss, **aux}

    history = {"loss": [], "mse": [], "esr": []}
    history.update({k: [] for k in component_lrs})
    for _ in range(cfg.epochs):
        params, opt_state, m = step(params, opt_state, train_batches)
        for k in ("loss", "mse", "esr"):
            history[k].append(float(m[k]))
        for k in component_lrs:
            node, field = k.split(".", 1)
            history[k].append(float(params[node][field]))
    return params, history


# ---------------------------------------------------------------------------
# Simple-circuit component fitting (the reference's sanity workloads)
# ---------------------------------------------------------------------------


def fit_components(
    circuit: Circuit,
    params,
    inputs,
    target,
    lr_by_param: Dict[str, float],
    epochs: int = 100,
    constrain: bool = True,
):
    """Learn component values (R/C) against a target waveform with separate
    per-parameter learning rates — e.g. {"R1.R": 25.0, "C1.C": 1e-8}
    (reference ``lpf.py:79-99``).  Parameters not listed get lr 0 (frozen).

    Returns (params, history dict of per-epoch loss and param trajectories).
    """
    state0 = circuit.init_state()

    def label_of(path):
        # path like (DictKey('R1'), DictKey('R')) -> "R1.R"
        key = ".".join(str(getattr(p, "key", p)) for p in path)
        return key if key in lr_by_param else "frozen"

    labels = jax.tree_util.tree_map_with_path(lambda p, x: label_of(p), params)
    transforms = {k: optax.adam(lr) for k, lr in lr_by_param.items()}
    transforms["frozen"] = optax.set_to_zero()
    opt = optax.multi_transform(transforms, labels)
    opt_state = opt.init(params)

    def loss_fn(p):
        out, _ = circuit.process(p, state0, inputs)
        return mse(target, out)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s, p)
        p = optax.apply_updates(p, updates)
        return p, s, loss

    history = {"loss": [], "params": []}
    for _ in range(epochs):
        params, opt_state, loss = step(params, opt_state)
        if constrain:
            params = circuit.constrain(params)
        history["loss"].append(float(loss))
        history["params"].append(jax.tree_util.tree_map(float, params))
    return params, history
