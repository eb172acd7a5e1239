"""Circuit = adapted WDF tree + root nonlinearity, compiled to pure step/scan fns.

This is the JAX replacement for both the reference's Python training
models (e.g. ``clipper_pot.py:94-127`` ClipperModel) and the C++ circuit
classes (``plugin/src/dsp/*``): a circuit is described once as a static tree,
and `Circuit` compiles it (at trace time) into

- ``adapt(params, controls) -> coeffs``   impedance/scatter coefficients
- ``step(params, coeffs, state, controls) -> (state, waves)``  one audio sample
- ``process(params, state, inputs) -> (outputs, state)``  `lax.scan` over time

All functions are pure and jit/vmap/grad/shard-compatible.  The per-sample
up-traversal, root solve, and down-traversal (reference call stack
``clipper_pot.py:113-124`` / ``DiodeClipperWDF.cpp:18-30``) become one fused
scan body.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .elements import WDFNode, voltage


class Root:
    """Protocol for WDF root (unadapted) elements.

    ``reflect(a, R, params, controls)`` maps the incident wave collected at the
    top of the adapted tree (and the tree's port impedance R) to the reflected
    wave sent back down.  Pure function; params live under ``self.name``.
    """

    name: str = "root"

    def init_params(self) -> Dict[str, Dict[str, Any]]:
        return {}

    def reflect(self, a, R, params, controls):
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class IdealVoltageSourceRoot(Root):
    """Ideal voltage source used as the tree root: b = -a + 2 Vs.

    Reference: ``tf_wdf.py:13-28`` (used root-level in
    ``voltage_divider.py:38-39`` / ``lpf.py``). Control field: "v".
    """

    name: str = "Vs"

    def reflect(self, a, R, params, controls):
        return -a + 2.0 * controls[self.name]["v"]


@dataclasses.dataclass(eq=False)
class OpenCircuitRoot(Root):
    """Open circuit at the root: total reflection, b = a."""

    name: str = "open"

    def reflect(self, a, R, params, controls):
        return a


def _collect_impedance_controls(node: WDFNode, out: Dict[str, Tuple[str, ...]]):
    out[node.name] = tuple(node.impedance_controls)
    for c in node.children:
        _collect_impedance_controls(c, out)


@dataclasses.dataclass(eq=False)
class Circuit:
    """A complete WDF circuit: adapted tree + root + output probes.

    outputs: element names whose voltage is the circuit output (stacked on the
    last axis if more than one).
    """

    tree: WDFNode
    root: Root
    fs: float
    outputs: Sequence[str] = ()

    # ---- pytrees ---------------------------------------------------------
    def init_params(self) -> Dict[str, Any]:
        p = self.tree.init_params()
        p.update(self.root.init_params())
        return p

    def init_state(self) -> Dict[str, Any]:
        return self.tree.init_state()

    def param_constraints(self):
        return self.tree.param_constraints()

    def constrain(self, params):
        """Clip params to their element bounds (TF-constraint parity)."""
        cons = self.param_constraints()
        out = jax.tree_util.tree_map(lambda x: x, params)  # shallow copy
        for name, fields in cons.items():
            for f, (lo, hi) in fields.items():
                out[name] = dict(out[name])
                out[name][f] = jnp.clip(params[name][f], lo, hi)
        return out

    # ---- pure functions --------------------------------------------------
    def adapt(self, params, controls=None) -> Dict[str, Any]:
        coeffs: Dict[str, Any] = {}
        self.tree.adapt(params, controls or {}, coeffs, self.fs)
        return coeffs

    def step(self, params, coeffs, state, controls):
        """One sample: up-traversal, root solve, down-traversal."""
        waves: Dict[str, Any] = {}
        a_root = self.tree.reflected(coeffs, state, controls, waves)
        R_up = coeffs[self.tree.name]["R"]
        b_root = self.root.reflect(a_root, R_up, params, controls)
        new_entries = self.tree.incident(coeffs, state, controls, waves, b_root)
        new_state = {**state, **new_entries}
        waves[self.root.name] = (a_root, b_root)
        return new_state, waves

    def probe(self, waves):
        outs = [voltage(waves, n) for n in self.outputs]
        if len(outs) == 1:
            return outs[0]
        return jnp.stack(outs, axis=-1)

    def needs_per_sample_adapt(self, inputs: Dict[str, Dict[str, Any]]) -> bool:
        imp: Dict[str, Tuple[str, ...]] = {}
        _collect_impedance_controls(self.tree, imp)
        for name, fields in inputs.items():
            for f in fields:
                if f in imp.get(name, ()):
                    return True
        return False

    def process(
        self,
        params,
        state,
        inputs: Dict[str, Dict[str, Any]],
        *,
        static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
        adapt_per_sample: Optional[bool] = None,
        checkpoint: bool = False,
        unroll: int = 1,
    ):
        """Run the sample recursion over the leading time axis of ``inputs``.

        inputs: {node: {field: array[T, ...]}}.  Returns (outputs[T, ...],
        final_state).  If any driven field affects impedance (pot sweep), the
        adaptation pass runs inside the scan (reference behavior
        ``clipper_pot.py:117``); otherwise it is hoisted out.

        static_controls: {node: {field: scalar}} per-call (block-rate)
        controls — e.g. a cutoff-derived source resistance or a drive pot
        held for the block (the reference's ``setParameters`` path,
        ``DiodeClipperWDF.cpp:10-16``).  They may be traced values; impedance
        adaptation with them still runs once, outside the scan.
        """
        if adapt_per_sample is None:
            adapt_per_sample = self.needs_per_sample_adapt(inputs)
        static_controls = static_controls or {}

        def merge(controls_t):
            if not static_controls:
                return controls_t
            out = {k: dict(v) for k, v in static_controls.items()}
            for node, fields in controls_t.items():
                out.setdefault(node, {})
                out[node].update(fields)
            return out

        if not adapt_per_sample:
            coeffs = self.adapt(params, static_controls)

            def body(carry, controls_t):
                st = carry
                st, waves = self.step(params, coeffs, st, merge(controls_t))
                return st, self.probe(waves)

        else:

            def body(carry, controls_t):
                st = carry
                ct = merge(controls_t)
                coeffs_t = self.adapt(params, ct)
                st, waves = self.step(params, coeffs_t, st, ct)
                return st, self.probe(waves)

        if checkpoint:
            body = jax.checkpoint(body)
        final_state, outs = jax.lax.scan(body, state, inputs, unroll=unroll)
        return outs, final_state

    def __call__(self, params, state, inputs, **kw):
        return self.process(params, state, inputs, **kw)
