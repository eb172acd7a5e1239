"""One-port WDF elements, as pure functional tree nodes.

Capability parity with the reference's differentiable element library
(``/root/reference/wdf_py/lib/tf_wdf.py:8-126``) and the chowdsp ``wdft``
one-port templates used by the C++ stack, re-designed for JAX: instead of
stateful modules mutating ``a``/``b`` wave attributes, every element is a
*static tree-description object* whose methods are pure functions over
explicit pytrees:

- ``params``  : {node name: {field: leaf}}   — trainable/static component values
- ``state``   : {node name: {field: leaf}}   — reactive-element memory (z^-1)
- ``controls``: {node name: {field: leaf}}   — per-sample driven inputs (Vs, pot R)
- ``coeffs``  : {node name: {...}}           — impedances + scattering coefficients
                                               produced by the adaptation pass
- ``waves``   : {node name: (a, b)}          — the wave trace of one sample step,
                                               used for voltage/current probes

The tree structure is plain static Python, so recursing over it at trace time
unrolls into straight-line XLA ops: no data-dependent control flow, static
shapes, everything fuses.  Batching is by ``jax.vmap`` over the pytrees (all
element math is written shape-polymorphic).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax.numpy as jnp

Pytree = Any


def voltage(waves: Dict[str, Tuple[Any, Any]], name: str):
    """Voltage across element `name`: v = (a + b) / 2.

    Mirrors the reference's probe (``tf_wdf.py:8-10`` / ``wdft::voltage``).
    """
    a, b = waves[name]
    return (a + b) * 0.5


def current(waves: Dict[str, Tuple[Any, Any]], coeffs: Dict[str, Any], name: str):
    """Current through element `name`: i = (a - b) / (2 R)."""
    a, b = waves[name]
    return (a - b) / (2.0 * coeffs[name]["R"])


class WDFNode:
    """Base class for all WDF tree nodes (elements and adaptors)."""

    #: names of control fields that change the port impedance when driven
    #: per-sample (e.g. a potentiometer's "R").  Used to decide whether the
    #: adaptation pass must run inside the sample scan.
    impedance_controls: Tuple[str, ...] = ()
    #: names of control fields that do NOT affect impedance (e.g. source "v").
    signal_controls: Tuple[str, ...] = ()

    name: str
    children: Tuple["WDFNode", ...] = ()

    # ---- pytree builders -------------------------------------------------
    def init_params(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for c in self.children:
            out.update(c.init_params())
        own = self._own_params()
        if own:
            out[self.name] = own
        return out

    def init_state(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for c in self.children:
            out.update(c.init_state())
        own = self._own_state()
        if own:
            out[self.name] = own
        return out

    def _own_params(self) -> Dict[str, Any]:
        return {}

    def _own_state(self) -> Dict[str, Any]:
        return {}

    def param_constraints(self) -> Dict[str, Dict[str, Tuple[float, float]]]:
        """{name: {field: (lo, hi)}} clip bounds, applied after optimizer steps
        (parity with the reference's TF variable constraints)."""
        out: Dict[str, Dict[str, Tuple[float, float]]] = {}
        for c in self.children:
            out.update(c.param_constraints())
        own = self._own_constraints()
        if own:
            out[self.name] = own
        return out

    def _own_constraints(self) -> Dict[str, Tuple[float, float]]:
        return {}

    # ---- functional WDF protocol ----------------------------------------
    def adapt(self, params, controls, coeffs, fs) -> Any:
        """Bottom-up impedance adaptation.  Fills ``coeffs[self.name]``
        (must include key "R") and returns this node's port impedance."""
        raise NotImplementedError

    def reflected(self, coeffs, state, controls, waves) -> Any:
        """Up-traversal: compute the reflected wave b of this node (toward the
        root), recording (a=None placeholder, b) into ``waves``."""
        raise NotImplementedError

    def incident(self, coeffs, state, controls, waves, x) -> Dict[str, Dict[str, Any]]:
        """Down-traversal: accept incident wave ``x``; propagate to children.
        Returns the new state entries for this subtree."""
        raise NotImplementedError

    # convenience
    def _record_b(self, waves, b):
        waves[self.name] = (None, b)
        return b

    def _record_a(self, waves, a):
        _, b = waves[self.name]
        waves[self.name] = (a, b)


# ---------------------------------------------------------------------------
# Leaf elements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Resistor(WDFNode):
    """WDF resistor: port impedance R, reflects nothing (b = 0).

    Reference: ``tf_wdf.py:62-88`` (trainable clip [180, 1e6] Ohm).
    """

    name: str
    R: float = 1.0e3
    trainable: bool = False

    children = ()

    def _own_params(self):
        return {"R": jnp.asarray(self.R, dtype=jnp.float32)}

    def _own_constraints(self):
        return {"R": (180.0, 1.0e6)} if self.trainable else {}

    def adapt(self, params, controls, coeffs, fs):
        R = controls.get(self.name, {}).get("R", params[self.name]["R"])
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        # dtype-neutral zero: match the port impedance's dtype so an f64
        # oracle run (params/state cast to f64 under jax.enable_x64) stays
        # f64 end to end while the normal path stays f32.
        R = coeffs[self.name]["R"]
        return self._record_b(waves, jnp.zeros((), jnp.result_type(R)))

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {}

    impedance_controls = ("R",)


@dataclasses.dataclass(eq=False)
class Capacitor(WDFNode):
    """WDF capacitor via the bilinear transform: R = 1 / (2 C fs), one-sample
    memory z (b = z; incident stores z <- a).

    Reference: ``tf_wdf.py:91-126`` (trainable clip [0.1e-12, 1] F).
    """

    name: str
    C: float = 1.0e-6
    trainable: bool = False

    children = ()

    def _own_params(self):
        return {"C": jnp.asarray(self.C, dtype=jnp.float32)}

    def _own_state(self):
        return {"z": jnp.zeros(())}

    def _own_constraints(self):
        return {"C": (0.1e-12, 1.0)} if self.trainable else {}

    def adapt(self, params, controls, coeffs, fs):
        C = params[self.name]["C"]
        R = 1.0 / (2.0 * C * fs)
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        return self._record_b(waves, state[self.name]["z"])

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {self.name: {"z": x}}


@dataclasses.dataclass(eq=False)
class Inductor(WDFNode):
    """WDF inductor via the bilinear transform: R = 2 L fs, b = -z, z <- a.

    Not present in the reference Python lib but part of the chowdsp ``wdft``
    element set the C++ stack builds on; included for completeness.
    """

    name: str
    L: float = 1.0e-3
    trainable: bool = False

    children = ()

    def _own_params(self):
        return {"L": jnp.asarray(self.L, dtype=jnp.float32)}

    def _own_state(self):
        return {"z": jnp.zeros(())}

    def adapt(self, params, controls, coeffs, fs):
        L = params[self.name]["L"]
        R = 2.0 * L * fs
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        return self._record_b(waves, -state[self.name]["z"])

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {self.name: {"z": x}}


@dataclasses.dataclass(eq=False)
class ResistiveVoltageSource(WDFNode):
    """Voltage source with series resistance; matched port, so b = Vs.

    Controls: "v" (source voltage, per-sample) and optionally "R" (pot).
    Reference: ``tf_wdf.py:31-58``.
    """

    name: str
    R: float = 1.0e-9
    trainable: bool = False

    children = ()
    impedance_controls = ("R",)
    signal_controls = ("v",)

    def _own_params(self):
        return {"R": jnp.asarray(self.R, dtype=jnp.float32)}

    def adapt(self, params, controls, coeffs, fs):
        R = controls.get(self.name, {}).get("R", params[self.name]["R"])
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        # jnp.asarray keeps the control's own dtype (f32 serving, f64 oracle
        # runs); a strongly-typed jnp.ones(()) would force promotion under
        # jax.enable_x64 and break f32 kernel bodies traced in that context.
        v = controls[self.name]["v"]
        return self._record_b(waves, jnp.asarray(v))

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {}


@dataclasses.dataclass(eq=False)
class ResistiveCurrentSource(WDFNode):
    """Current source with parallel resistance; matched port: b = Is * R.

    chowdsp ``wdft`` parity element (not in the reference Python lib).
    Controls: "i" (source current)."""

    name: str
    R: float = 1.0e9

    children = ()
    impedance_controls = ("R",)
    signal_controls = ("i",)

    def _own_params(self):
        return {"R": jnp.asarray(self.R, dtype=jnp.float32)}

    def adapt(self, params, controls, coeffs, fs):
        R = controls.get(self.name, {}).get("R", params[self.name]["R"])
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        i = controls[self.name]["i"]
        return self._record_b(waves, i * coeffs[self.name]["R"])

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {}
