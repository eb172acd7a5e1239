"""Compiled serving artifacts via ``jax.export`` (StableHLO).

The reference's deploy path is: train in Python -> weights to JSON
(``wdf_py/lib/model_utils.py:82-85``) -> JSON baked into the plugin binary
(``plugin/src/CMakeLists.txt:16-34``) -> parsed by RTNeural at plugin load
(``plugin/src/dsp/diode_clipper/DiodePairNeuralModel.h:55-61``).  The point
of that pipeline is a *self-contained deployable artifact*: the serving side
needs no Python, no training stack, just the artifact plus a fixed runtime.

This module is the analog: a trained circuit (tree + params +
root) is traced once into a pure block-processing function, lowered with
``jax.export`` to serialized StableHLO, and written — together with its
initial state and metadata — as a single ``.npz`` artifact.  Loading the
artifact needs only jax (any version satisfying the export compatibility
window) and reconstructs a callable ``(state, vin) -> (vout, state)`` with
**no access to the circuit definition or parameters** — weights are constants
inside the compiled program, exactly like the JSON baked into the plugin
binary.  Artifacts are exported multi-platform (cpu + cuda by default), so
the same file serves on a GPU and in a CPU container.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as jax_export

from ..core.circuit import Circuit

FORMAT = "diffwdf-artifact-v1"


@dataclasses.dataclass
class ServingArtifact:
    """A loaded compiled artifact: callable block processor + initial state."""

    meta: Dict[str, Any]
    init_state: Tuple[np.ndarray, ...]
    _exported: Any

    @property
    def block_len(self) -> int:
        return int(self.meta["block_len"])

    def process(self, state: Tuple, vin) -> Tuple[Any, Tuple]:
        """One block: (state, vin[block_len]) -> (vout[block_len], state)."""
        return self._exported.call(tuple(state), jnp.asarray(vin, jnp.float32))

    def run(self, vin) -> np.ndarray:
        """Convenience: stream a full signal (padded to whole blocks)."""
        vin = np.asarray(vin, np.float32)
        n, bl = vin.shape[0], self.block_len
        pad = (-n) % bl
        vin = np.pad(vin, (0, pad))
        state = tuple(jnp.asarray(s) for s in self.init_state)
        outs = []
        for i in range(0, vin.shape[0], bl):
            y, state = self.process(state, vin[i : i + bl])
            outs.append(np.asarray(y))
        return np.concatenate(outs)[:n]


def export_circuit(
    circuit: Circuit,
    params,
    *,
    input_node: str = "Vs",
    input_field: str = "v",
    block_len: int = 2048,
    fs: Optional[float] = None,
    static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
    platforms: Sequence[str] = ("cpu", "cuda"),
) -> ServingArtifact:
    """Lower ``circuit`` at fixed ``params`` to StableHLO for ``platforms``.

    Params (weights, component values) and any static controls are closed
    over — they become constants in the compiled program.  State is passed
    as a flat tuple of arrays so the artifact is self-describing without a
    pytree definition.  Returns the artifact in memory;
    :func:`save_artifact` writes it to a file.
    """
    state0 = circuit.init_state()
    leaves, treedef = jax.tree_util.tree_flatten(state0)

    def block_fn(state_leaves, vin):
        st = jax.tree_util.tree_unflatten(treedef, list(state_leaves))
        out, st2 = circuit.process(
            params, st, {input_node: {input_field: vin}},
            static_controls=static_controls,
        )
        return out, tuple(jax.tree_util.tree_leaves(st2))

    state_specs = tuple(
        jax.ShapeDtypeStruct(np.shape(l), np.asarray(l).dtype) for l in leaves
    )
    vin_spec = jax.ShapeDtypeStruct((block_len,), jnp.float32)
    exp = jax_export.export(jax.jit(block_fn), platforms=list(platforms))(
        state_specs, vin_spec
    )
    meta = {
        "format": FORMAT,
        "block_len": int(block_len),
        "fs": fs,
        "platforms": list(platforms),
        "n_state": len(leaves),
        "jax_version": jax.__version__,
    }
    return ServingArtifact(
        meta=meta, init_state=tuple(np.asarray(l) for l in leaves),
        _exported=exp,
    )


def save_artifact(path: str, circuit: Circuit, params, **kw) -> Dict[str, Any]:
    """Export ``circuit`` and write a single-file ``.npz`` artifact
    (serializing needs the ``flatbuffers`` package)."""
    art = export_circuit(circuit, params, **kw)
    meta = art.meta
    arrays = {"blob": np.frombuffer(art._exported.serialize(), dtype=np.uint8),
              "meta": np.asarray(json.dumps(meta))}
    for i, l in enumerate(art.init_state):
        arrays[f"state_{i}"] = l
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return meta


def load_artifact(path: str) -> ServingArtifact:
    """Load an artifact written by :func:`save_artifact`.

    Needs no circuit definition — the compiled program is self-contained.
    """
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} file: {path}")
        blob = z["blob"].tobytes()
        leaves = tuple(z[f"state_{i}"] for i in range(int(meta["n_state"])))
    exp = jax_export.deserialize(bytearray(blob))
    return ServingArtifact(meta=meta, init_state=leaves, _exported=exp)
