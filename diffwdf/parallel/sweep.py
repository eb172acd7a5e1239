"""Batched circuit-instance sweeps and model-zoo ensembles.

The answer to "run many circuits": ``vmap`` over a pytree of per-instance
parameters (component values, diode physics, or MLP weights), sharded over the
mesh "data" axis.  This serves BASELINE.json config 4 (1024-instance
parameter sweeps for hyperparameter / component optimization) and the
expert-parallel-style model-zoo ensembles (one diode model per "expert").
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.circuit import Circuit


def expand_params(base_params, overrides: Dict[str, jnp.ndarray]):
    """Broadcast base params to N instances, overriding selected leaves.

    overrides: {"Node.field": array[N]}.  Returns a params pytree whose
    overridden leaves have a leading N axis and a matching vmap axis-tree.
    """
    n = None
    for v in overrides.values():
        n = v.shape[0] if n is None else n
        assert v.shape[0] == n
    out = {}
    axes = {}
    for node, fields in base_params.items():
        out[node] = {}
        axes[node] = {}
        for f, leaf in fields.items():
            key = f"{node}.{f}"
            if key in overrides:
                out[node][f] = jnp.asarray(overrides[key])
                axes[node][f] = 0
            else:
                out[node][f] = leaf
                axes[node][f] = None
    return out, axes


def sweep_process(
    circuit: Circuit,
    base_params,
    overrides: Dict[str, jnp.ndarray],
    inputs,
    mesh: Optional[Mesh] = None,
    data_axis: str = "data",
):
    """Run the circuit once per instance of the sweep, sharing the input.

    Returns outputs[N, T].  With a mesh, instances are sharded over
    ``data_axis`` (pure data parallelism; XLA partitions the vmap).
    """
    params_n, axes = expand_params(base_params, overrides)
    state0 = circuit.init_state()

    def run_one(p):
        out, _ = circuit.process(p, state0, inputs)
        return out

    fn = jax.vmap(run_one, in_axes=(axes,))
    if mesh is not None:
        n = next(iter(overrides.values())).shape[0]
        out_sharding = NamedSharding(mesh, P(data_axis))
        params_n = jax.tree_util.tree_map(
            lambda x: (
                jax.device_put(x, NamedSharding(mesh, P(data_axis)))
                if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == n
                else x
            ),
            params_n,
        )
        fn = jax.jit(fn, out_shardings=out_sharding)
    else:
        fn = jax.jit(fn)
    return fn(params_n)


def ensemble_process(
    circuit_factory: Callable,
    mlp_params_stack,
    activations,
    inputs,
    mesh: Optional[Mesh] = None,
):
    """Model-zoo ensemble: run the same circuit under N stacked MLP roots.

    mlp_params_stack: MLP params pytree with a leading N axis on every leaf
    (stack of model-zoo entries of one architecture).  circuit_factory builds
    the circuit given a NeuralDiodeRoot-compatible root name.
    Returns outputs[N, T].
    """
    from ..roots.neural import NeuralDiodeRoot

    n_layers = len(mlp_params_stack["layers"]) - 2
    width = mlp_params_stack["layers"][0]["kernel"].shape[-1]
    root = NeuralDiodeRoot(
        name="dp", n_layers=n_layers, layer_size=int(width),
        activations=tuple(activations),
    )
    circuit = circuit_factory(root)
    tree_params = circuit.init_params()
    state0 = circuit.init_state()

    def run_one(mlp):
        params = {**tree_params, "dp": mlp}
        out, _ = circuit.process(params, state0, inputs)
        return out

    fn = jax.vmap(run_one)
    if mesh is not None:
        # experts sharded over the mesh data axis (same partitioning
        # contract as sweep_process: XLA partitions the vmap, outputs land
        # sharded so a downstream reduce stays on-device)
        sharding = NamedSharding(mesh, P("data"))
        mlp_params_stack = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding), mlp_params_stack
        )
        fn = jax.jit(fn, out_shardings=sharding)
    else:
        fn = jax.jit(fn)
    return fn(mlp_params_stack)


def stack_mlp_params(mlp_list):
    """Stack a list of same-architecture MLP params into one pytree with a
    leading ensemble axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *mlp_list)
