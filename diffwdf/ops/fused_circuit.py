"""Generic fused-circuit kernel: the whole sample recursion of ANY WDF
``Circuit`` in one Pallas kernel, compiled for the GPU through Triton.

Each program owns a tile of ``_BLOCK_ROWS`` streams and walks all T samples
in one ``fori_loop`` with the circuit state in registers; programs share
nothing, so the grid is the batch alone.  The circuit's own pure step
(up-traversal, root solve, down-traversal — ``core/circuit.py``) is traced
into the loop body: the tree walk is static Python emitting elementwise
float32 math, so one step is a few FMAs plus the root's transcendentals,
and the only device-memory traffic is one drive row in and one output row
out.  Under plain XLA the same recursion (``vmap`` of ``lax.scan``) is a
device-side loop that launches several kernels per sample and round-trips
the state through device memory each time.

Layout: drive, output and per-sample pot streams are time-major, (T, B),
so each step reads one contiguous row of the tile.  B is padded to the
tile; T is free.  Each step's stream rows are loaded during the step
before, so the load latency overlaps the recursion.

Coefficients, parameters and block-rate controls are read as scalars
(matrices such as the R-type S-matrix element by element).  Per-row pot
controls become (B,) rows read once per tile; per-sample pot controls
become (T, B) streams read at every step.  Neural roots run as broadcast
float32 FMAs: their layers are 2 to 16 wide, below the smallest
matrix-unit tile, so there is no precision choice to make.

This is the batch-rendering path for every circuit (reference hot loops
``DiodeClipperWDF.cpp:18-30``, ``TubeScreamer.cpp:43-56``,
``HPFDiodeClipper.cpp:44-55``) and the forward pass of the
``fused_generic`` training engine (``ops.parallel_bptt``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..device import use_interpret
from ..roots.neural import _ACTS, NeuralDiodeRoot

_MAX_STATIC = 1024  # elements of a vector/matrix leaf read as scalars
# streams per program, one per thread of one warp: B=8192 gives 256
# programs for the H100's 132 SMs; fastest or tied for every timed root
_BLOCK_ROWS = 32


class _StaticMatrix:
    """Trace-time 2-D container of scalar reads, supporting the static
    ``S[i, j]`` indexing the adaptors and the MLP root use."""

    def __init__(self, rows):
        self.rows = rows
        self.shape = (len(rows), len(rows[0]) if rows else 0)

    def __getitem__(self, ij):
        i, j = ij
        return self.rows[i][j]


def _classify_leaves(leaves, n_dynamic: int = 0, batch: int = 0, time: int = 0):
    """Split bundle leaves by how the kernel reads them.

    Single values, vectors and matrices become scalars in one flat vector;
    among the first ``n_dynamic`` leaves (the coefficients adapted from pot
    controls), a (batch,) leaf is a per-row "row" leaf and a (batch, time)
    leaf a per-sample "time" stream.  Returns (flat pieces, spec list, row
    leaves, time leaves), each spec (kind, start, shape)."""
    pieces, specs, rows, times = [], [], [], []
    n_flat = 0
    for i, leaf in enumerate(leaves):
        arr = jnp.asarray(leaf, jnp.float32)
        dyn = i < n_dynamic
        if arr.size == 1:
            specs.append(("static", n_flat, ()))
        elif dyn and arr.shape == (batch,):
            specs.append(("row", len(rows), ()))
            rows.append(arr)
            continue
        elif dyn and arr.shape == (batch, time):
            specs.append(("time", len(times), ()))
            times.append(arr)
            continue
        elif arr.ndim in (1, 2) and arr.size <= _MAX_STATIC:
            specs.append(("static", n_flat, arr.shape))
        else:
            raise ValueError(
                f"fused_circuit: unsupported coeff/param leaf shape {arr.shape}"
                " (per-row/per-sample pot controls must not reach"
                " matrix-valued coeffs — keep the pot outside R-type adaptors"
                " or use static_s)"
            )
        pieces.append(arr.reshape(-1))
        n_flat += arr.size
    return pieces, specs, rows, times


def _rebuild_leaves(scalar, specs, row_views=(), time_views=()):
    """Kernel-side leaves: ``scalar(k)`` reads flat element k; row and time
    leaves come as this tile's (_BLOCK_ROWS,) vectors."""
    out = []
    for kind, start, shape in specs:
        if kind == "row":
            out.append(row_views[start])
        elif kind == "time":
            out.append(time_views[start])
        elif len(shape) == 0:
            out.append(scalar(start))
        elif len(shape) == 1:
            out.append([scalar(start + j) for j in range(shape[0])])
        else:
            r, c = shape
            out.append(_StaticMatrix(
                [[scalar(start + i * c + j) for j in range(c)] for i in range(r)]
            ))
    return out


def _merge_controls(static_controls, row_controls):
    """Deep-merge {node: {field: val}} dicts (row values win)."""
    out = {k: dict(v) for k, v in (static_controls or {}).items()}
    for node, fields in (row_controls or {}).items():
        out.setdefault(node, {})
        out[node].update(fields)
    return out


def _mlp_reflect(root: NeuralDiodeRoot):
    """``NeuralDiodeRoot.reflect`` (b = -MLP([a, log R])) as broadcast
    float32 FMAs over scalar weights, one unit at a time."""

    def reflect(a, r_up, params, controls):
        x = [a, jnp.log(r_up)]
        for layer, act in zip(params[root.name]["layers"], root.activations):
            k, b = layer["kernel"], layer["bias"]
            b = b if isinstance(b, list) else [b]  # a (1,) bias reads as a scalar
            n_in, n_out = k.shape
            x = [
                _ACTS[act](sum(k[i, j] * x[i] for i in range(n_in)) + b[j])
                for j in range(n_out)
            ]
        return -x[0]

    return reflect


def _time_major(x, b_pad):
    """(B, T) -> (T, B + b_pad), padded rows copy the last stream."""
    return jnp.pad(x, ((0, b_pad), (0, 0)), mode="edge").T


@functools.partial(
    jax.jit,
    static_argnames=(
        "circuit",
        "input_node",
        "interpret",
        "return_state_seq",
    ),
)
def fused_circuit_process(
    circuit,
    params,
    vin,
    state0,
    *,
    input_node: str = "Vin",
    static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
    row_controls: Optional[Dict[str, Dict[str, Any]]] = None,
    interpret: Optional[bool] = None,
    return_state_seq: bool = False,
):
    """Run ``circuit`` over ``vin`` (B, T) inside one Pallas kernel.

    state0: the circuit state pytree with each leaf of shape (B,).
    Returns (out (B, T), final state pytree).  Matches
    ``circuit.process(...)`` with hoisted adaptation (same math, fused
    execution); impedance-affecting params go in ``static_controls``.

    row_controls: {node: {field: (B,) | (B, T)}} PER-ROW or PER-SAMPLE
    impedance controls (the reference's measured pot — one R per chunk
    after hoisting, ``dataimport.py:109``, or genuinely time-varying,
    ``clipper_pot.py:113-124``).  Adaptation runs batched outside the
    kernel and every stream runs its own scatter algebra.

    ``interpret`` defaults to the device's route (``device.kernel_route``):
    interpret mode on the CPU, Triton on a GPU.

    return_state_seq: additionally return the PRE-step state trajectory
    [S leaves of (B, T)] — z_{t-1} for every step t, the residual the
    training backward (ops.parallel_bptt) linearizes around.
    """
    if interpret is None:
        interpret = use_interpret()
    assert len(circuit.outputs) == 1, "the fused kernel has one output probe"
    B, T = vin.shape
    b_pad = (-B) % _BLOCK_ROWS
    n_tiles = (B + b_pad) // _BLOCK_ROWS

    coeffs = circuit.adapt(params, _merge_controls(static_controls, row_controls))
    bundle = (coeffs, params, static_controls or {})
    leaves, treedef = jax.tree_util.tree_flatten(bundle)
    pieces, specs, row_leaves, time_leaves = _classify_leaves(
        leaves,
        n_dynamic=len(jax.tree_util.tree_leaves(coeffs)) if row_controls else 0,
        batch=B,
        time=T,
    )
    flat = jnp.concatenate(pieces + [jnp.zeros((1,), jnp.float32)])
    n_row, n_time = len(row_leaves), len(time_leaves)

    s_leaves, s_treedef = jax.tree_util.tree_flatten(state0)
    n_s = len(s_leaves)
    for leaf in s_leaves:
        assert leaf.shape == (B,), f"state leaf shape {leaf.shape} != ({B},)"
    n_seq = n_s if return_state_seq else 0
    reflect = (
        _mlp_reflect(circuit.root)
        if isinstance(circuit.root, NeuralDiodeRoot)
        else circuit.root.reflect
    )

    def kernel(flat_ref, x_ref, z0_ref, *rest):
        n_in = 1 if n_row else 0  # all row leaves share one (n_row, B) input
        row_views = tuple(rest[0][k, :] for k in range(n_row))
        time_refs = rest[n_in : n_in + n_time]
        out_ref, zf_ref, *seq_refs = rest[n_in + n_time :]

        def ctx_of(time_views):
            """(coeffs, params, static) as the kernel sees them."""
            rebuilt = _rebuild_leaves(
                lambda k: flat_ref[k], specs, row_views, time_views
            )
            return jax.tree_util.tree_unflatten(treedef, rebuilt)

        if n_time == 0:  # step-invariant: read once, outside the loop
            ctx = ctx_of(())

        def load(t):
            return (x_ref[t, :],) + tuple(r[t, :] for r in time_refs)

        def body(t, carry):
            st_leaves, (v, *tv) = carry
            nxt = load(jnp.minimum(t + 1, T - 1))  # prefetch the next step
            coeffs_k, params_k, static_k = ctx if n_time == 0 else ctx_of(tv)
            for k in range(n_seq):  # pre-step state = the BPTT residual
                seq_refs[k][t, :] = st_leaves[k]
            st = jax.tree_util.tree_unflatten(s_treedef, list(st_leaves))
            controls = {k: dict(v2) for k, v2 in static_k.items()}
            controls.setdefault(input_node, {})
            controls[input_node]["v"] = v
            # inlined circuit.step, with the kernel's root
            waves: Dict[str, Any] = {}
            a_root = circuit.tree.reflected(coeffs_k, st, controls, waves)
            r_up = coeffs_k[circuit.tree.name]["R"]
            b_root = reflect(a_root, r_up, params_k, controls)
            new_entries = circuit.tree.incident(
                coeffs_k, st, controls, waves, b_root
            )
            waves[circuit.root.name] = (a_root, b_root)
            out_ref[t, :] = jnp.broadcast_to(circuit.probe(waves), v.shape)
            new_leaves = jax.tree_util.tree_leaves({**st, **new_entries})[:n_s]
            return (
                tuple(jnp.broadcast_to(z, v.shape) for z in new_leaves),
                nxt,
            )

        z_init = tuple(z0_ref[k, :] for k in range(n_s))
        zf, _ = jax.lax.fori_loop(0, T, body, (z_init, load(0)))
        for k in range(n_s):
            zf_ref[k, :] = zf[k]

    x = _time_major(jnp.asarray(vin, jnp.float32), b_pad)
    z0 = jnp.pad(
        jnp.stack([jnp.asarray(l, jnp.float32) for l in s_leaves])
        if n_s
        else jnp.zeros((1, B), jnp.float32),
        ((0, 0), (0, b_pad)),
    )
    inputs = [flat, x, z0]
    stream = pl.BlockSpec((T, _BLOCK_ROWS), lambda i: (0, i))
    state_spec = pl.BlockSpec((z0.shape[0], _BLOCK_ROWS), lambda i: (0, i))
    in_specs = [pl.BlockSpec(flat.shape, lambda i: (0,)), stream, state_spec]
    if n_row:
        inputs.append(
            jnp.pad(jnp.stack(row_leaves), ((0, 0), (0, b_pad)), mode="edge")
        )
        in_specs.append(pl.BlockSpec((n_row, _BLOCK_ROWS), lambda i: (0, i)))
    inputs += [_time_major(t, b_pad) for t in time_leaves]
    in_specs += [stream] * n_time

    seq_shape = jax.ShapeDtypeStruct(x.shape, jnp.float32)
    out, zf, *seqs = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=in_specs,
        out_specs=[stream, state_spec] + [stream] * n_seq,
        out_shape=[seq_shape, jax.ShapeDtypeStruct(z0.shape, jnp.float32)]
        + [seq_shape] * n_seq,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="fused_circuit",
    )(*inputs)

    out = out[:, :B].T
    state_f = (
        jax.tree_util.tree_unflatten(s_treedef, [zf[k, :B] for k in range(n_s)])
        if n_s
        else state0
    )
    if return_state_seq:
        return out, state_f, [s[:, :B].T for s in seqs]
    return out, state_f
