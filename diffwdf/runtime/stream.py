"""Streaming block processor — the serving path.

Capability parity with the reference's C++ plugin shell
(``plugin/src/DifferentiableWDFPlugin.cpp:40-82`` and the circuit wrappers
``DiodeClipper.cpp:20-50`` etc.): mono summing, ramped input gain, circuit
dispatch by name, a 25 Hz one-pole DC blocker, per-block parameter updates
(cutoff -> source R, drive pot), and state carried across blocks so arbitrary
block sizes stream gap-free.

The "real-time engine" is a jit-compiled block function; each circuit (and
block size) compiles once and is then a single device call per block.  The
processor also exposes the parameter schema of each circuit
(name/kind/range) — the equivalent of the reference's GUI parameter
reflection (``CircuitModelGUI.cpp:55-66``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.circuit import Circuit

DC_BLOCKER_HZ = 25.0  # reference: DifferentiableWDFPlugin.cpp:31


@dataclasses.dataclass
class ParamSpec:
    """Introspectable parameter descriptor (GUI-reflection parity).

    ``name`` is the reference's parameter tag (``DiodeClipper.cpp:5-7``);
    ``api`` is how the parameter is driven through this framework:
    the ``process_block`` keyword for block-rate params ("gain_db",
    "cutoff_hz", "drive"), or "circuit" for the model choice (selected as
    the circuit name passed to ``process_block`` — the analogue of the
    reference's root hot-swap).  ``skew_centre`` mirrors JUCE's
    ``NormalisableRange::setSkewForCentre`` so a GUI can reproduce the
    reference's log-feel cutoff slider.
    """

    name: str
    kind: str  # "float" | "choice"
    lo: float = 0.0
    hi: float = 1.0
    default: float = 0.0
    choices: Tuple[str, ...] = ()
    default_choice: int = 0
    skew_centre: Optional[float] = None
    api: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["choices"] = list(self.choices)
        return d


def _cutoff_spec() -> ParamSpec:
    # 200 Hz .. 20 kHz, skewed for centre 2 kHz, default 4 kHz
    # (DiodeClipper.cpp:25-27, identical in MultiDiodeClipper/HPFDiodeClipper)
    return ParamSpec("cutoff", "float", 200.0, 20000.0, 4000.0,
                     skew_centre=2000.0, api="cutoff_hz")


def clipper_param_specs(
    choices: Tuple[str, ...] = (
        "1N4148 Ideal", "1N4148 Approx", "1N4148 2x4", "1N4148 2x8",
        "1N4148 2x16", "1N4148 4x4", "1N4148 4x8",
    ),
) -> Tuple[ParamSpec, ...]:
    """The DiodeClipper parameter set (``DiodeClipper.cpp:20-31``):
    gain 0..24 dB, skewed cutoff, 7-model choice."""
    return (
        ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db"),
        _cutoff_spec(),
        ParamSpec("model", "choice", choices=tuple(choices), api="circuit"),
    )


def multi_diode_param_specs() -> Tuple[ParamSpec, ...]:
    """MultiDiodeClipper parameters (``MultiDiodeClipper.cpp:20-31``):
    same gain/cutoff as the clipper, 5 multi-diode-config models."""
    return (
        ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db"),
        _cutoff_spec(),
        ParamSpec("model", "choice", choices=(
            "1up/2down 2x16", "2up/2down 2x16", "1up/3down 2x16",
            "2up/3down 2x16", "3up/3down 2x16",
        ), api="circuit"),
    )


def tube_screamer_param_specs() -> Tuple[ParamSpec, ...]:
    """TubeScreamer parameters (``TubeScreamer.cpp:21-29``):
    gain -12..12 dB, drive 0..1 (default 0.5), 2-model choice."""
    return (
        ParamSpec("gain", "float", -12.0, 12.0, 0.0, api="gain_db"),
        ParamSpec("drive", "float", 0.0, 1.0, 0.5, api="drive"),
        ParamSpec("model", "choice",
                  choices=("1N4148 Approx", "1N4148 2x16"), api="circuit"),
    )


def hpf_param_specs() -> Tuple[ParamSpec, ...]:
    """HPFDiodeClipper parameters (``HPFDiodeClipper.cpp:21-31``):
    gain/cutoff as the clipper, 4-model choice incl. the extrapolation
    probe pair."""
    return (
        ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db"),
        _cutoff_spec(),
        ParamSpec("model", "choice", choices=(
            "1N4148 Ideal", "1N4148 Approx",
            "1N4148 2x16 Extrapolated", "1N4148 2x16 Trained",
        ), api="circuit"),
    )


def default_clipper_params() -> Tuple[ParamSpec, ...]:
    """Deprecated alias for :func:`clipper_param_specs`."""
    return clipper_param_specs()


def _dc_blocker_coeff(fs: float, f_hz: float = DC_BLOCKER_HZ) -> float:
    return 1.0 - 2.0 * math.pi * f_hz / fs


class StreamingProcessor:
    """Block-streaming WDF processor with gain ramp + DC blocker.

    circuits: {name: (Circuit, params)}; the active circuit is selected per
    block (each compiles once — the analogue of the reference's root
    hot-swap, ``DiodeClipperWDF.cpp:36-41``).

    groups: {group_name: (member, member, ...)} — a group is one *served
    circuit* whose root model is switchable at block rate (the reference's
    "model" parameter hot-swaps all 12 clipper roots on one shared tree,
    ``DiodeClipperWDF.cpp:32-41``).  Members of a group share ONE state
    pytree (asserted structurally identical), so switching the model
    mid-stream carries the reactive state across — exactly the reference's
    ``connectToParent`` + ``calcImpedance`` hot-swap semantics.
    ``process_block(audio, group, model=k)`` selects member k; the group's
    registered "model" ParamSpec choices map 1:1 onto the members
    (asserted at construction — the schema can never over-advertise).

    fallback_tol: always-correct serving guard.  A ``process_override``
    (fused parallel-in-time engine) emits a residual certificate; if it
    exceeds this tolerance the block is recomputed with the exact scan
    (from the same block-input state) — the parallel solver is an
    optimization, never a correctness change (the reference's engines are
    unconditionally correct at every operating point,
    ``Toms917DiodePair.h:51-58``).  ``fallbacks`` counts these per circuit;
    set ``fallback_tol=None`` to surface the raw residual only.
    """

    def __init__(self, circuits: Dict[str, Tuple[Circuit, Any]], fs: float,
                 param_maps: Optional[Dict[str, Callable]] = None,
                 param_schemas: Optional[Dict[str, Tuple[ParamSpec, ...]]] = None,
                 process_overrides: Optional[Dict[str, Callable]] = None,
                 groups: Optional[Dict[str, Tuple[str, ...]]] = None,
                 fallback_tol: Optional[float] = 1e-3):
        self.circuits = dict(circuits)
        self.fs = fs
        #: per-circuit mapping of block-rate params (cutoff_hz, drive, ...)
        #: to static controls {node: {field: value}} (setParameters parity)
        self.param_maps = param_maps or {}
        #: per-circuit parameter schemas (GUI-reflection parity); factories
        #: register the reference's exact schema per circuit, ad-hoc circuits
        #: get a schema derived from their param_map signature
        self.param_schemas = dict(param_schemas or {})
        #: per-circuit replacement for ``Circuit.process`` inside the block
        #: fn — e.g. the fused parallel-in-time solver as a low-latency
        #: serving engine; signature (params, state, inputs, static_controls)
        #: -> (out, state) or (out, state, residual)
        self.process_overrides = dict(process_overrides or {})
        #: last solver-residual certificate per circuit (deer engines emit
        #: max|f(z_prev) - z| — the serving health metric next to `load`;
        #: 0.0 for the exact scan engine)
        self.last_residual: Dict[str, float] = {}
        #: residual-triggered exact-scan recomputations per circuit
        self.fallbacks: Dict[str, int] = {}
        self.fallback_tol = fallback_tol
        self.groups = {g: tuple(m) for g, m in (groups or {}).items()}
        # group members share one state slot; assert state compatibility
        self._state_key: Dict[str, str] = {}
        for g, members in self.groups.items():
            if g in self.circuits:
                raise ValueError(f"group {g!r} collides with a circuit name")
            ref_def = None
            for m in members:
                if m not in self.circuits:
                    raise ValueError(f"group {g!r} member {m!r} not registered")
                sdef = jax.tree_util.tree_structure(
                    self.circuits[m][0].init_state()
                )
                ref_def = ref_def if ref_def is not None else sdef
                if sdef != ref_def:
                    raise ValueError(
                        f"group {g!r}: member {m!r} state structure {sdef} "
                        f"!= {ref_def} — members must share state"
                    )
                self._state_key[m] = g
        self._fns: Dict[Tuple[str, int, bool], Callable] = {}
        self._state: Dict[str, Any] = {}
        for name, (ckt, _) in circuits.items():
            self._state.setdefault(self._state_key.get(name, name),
                                   ckt.init_state())
        self._dc_state = (jnp.zeros(()), jnp.zeros(()))  # (x1, y1)
        self._gain = 1.0
        self._load_acc = 0.0
        self._load = 0.0
        self._assert_schema_consistency()

    def _assert_schema_consistency(self):
        """Every registered "model" choice spec must be actionable: its
        choices map 1:1 onto the selectable set (group members, or — for an
        ungrouped circuit registered under several sibling names sharing one
        schema — the sibling circuit names themselves)."""
        for name, specs in self.param_schemas.items():
            for s in specs:
                if s.kind != "choice" or s.api != "circuit":
                    continue
                if name in self.groups:
                    n_sel = len(self.groups[name])
                elif name in self._state_key:  # member: group's schema
                    n_sel = len(self.groups[self._state_key[name]])
                else:
                    # ungrouped: each choice must name a registered circuit
                    missing = [c for c in s.choices if c not in self.circuits]
                    if missing:
                        raise ValueError(
                            f"schema for {name!r} advertises model choices "
                            f"{missing} that are not registered circuits"
                        )
                    continue
                if len(s.choices) != n_sel:
                    raise ValueError(
                        f"schema for {name!r} advertises {len(s.choices)} "
                        f"model choices but {n_sel} are selectable"
                    )

    def _resolve(self, circuit: str, model) -> str:
        """Map (circuit-or-group, model choice) -> concrete circuit name.
        ``model`` may be a choice index, a choice label from the group's
        schema, or a member name."""
        if circuit in self.groups:
            members = self.groups[circuit]
            if model is None:
                specs = self.param_schemas.get(circuit, ())
                choice = next(
                    (s for s in specs if s.kind == "choice"
                     and s.api == "circuit"), None
                )
                return members[choice.default_choice if choice else 0]
            if isinstance(model, str):
                if model in members:
                    return model
                specs = self.param_schemas.get(circuit, ())
                for s in specs:
                    if s.kind == "choice" and model in s.choices:
                        return members[s.choices.index(model)]
                raise KeyError(
                    f"unknown model {model!r} for {circuit!r}; "
                    f"members {members}"
                )
            idx = int(model)
            if not 0 <= idx < len(members):
                raise KeyError(
                    f"model index {idx} out of range for {circuit!r}: "
                    f"{len(members)} choices {members}"
                )
            return members[idx]
        if circuit not in self.circuits:
            raise KeyError(
                f"unknown circuit {circuit!r}; have "
                f"{sorted(self.circuits) + sorted(self.groups)}"
            )
        if model is not None:
            raise ValueError(
                f"circuit {circuit!r} is not a model group; "
                f"pass the circuit name directly"
            )
        return circuit

    # -- parameter schema (GUI reflection parity) --------------------------
    def param_specs(self, name: str) -> Tuple[ParamSpec, ...]:
        """The parameter schema of circuit ``name`` — the analogue
        of the reference's auto-generated GUI (``CircuitModelGUI.cpp:55-66``
        reflects over each circuit's paramTags; here a GUI/CLI reflects over
        these specs).  Registered schemas come from the circuit factories;
        unregistered circuits derive a schema from their param_map signature
        so every circuit exposes something renderable."""
        if name not in self.circuits and name not in self.groups:
            raise KeyError(
                f"unknown circuit {name!r}; have "
                f"{sorted(self.circuits) + sorted(self.groups)}"
            )
        if name in self.param_schemas:
            return self.param_schemas[name]
        import inspect

        specs = [ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db")]
        mapper = self.param_maps.get(name)
        if mapper is not None:
            for arg in inspect.signature(mapper).parameters:
                if arg == "cutoff_hz":
                    specs.append(_cutoff_spec())
                elif arg == "drive":
                    specs.append(
                        ParamSpec("drive", "float", 0.0, 1.0, 0.5, api="drive")
                    )
                else:
                    specs.append(ParamSpec(arg, "float", api=arg))
        return tuple(specs)

    def surfaces(self) -> Tuple[str, ...]:
        """The served circuit names: model groups plus ungrouped circuits —
        what a GUI/CLI should render (group members are internal variants,
        addressed via the group's "model" parameter)."""
        return tuple(self.groups) + tuple(
            n for n in self.circuits if n not in self._state_key
        )

    @property
    def load(self) -> float:
        """Smoothed processing-load estimate (CPU-meter parity,
        ``CPUMeter.h:42-80``): device time / block duration."""
        return self._load

    # -- core ---------------------------------------------------------------
    def _block_fn(self, name: str, block_len: int,
                  use_override: bool = True) -> Callable:
        key = (name, block_len, use_override)
        if key not in self._fns:
            ckt, params = self.circuits[name]
            rho = _dc_blocker_coeff(self.fs)

            node = "Vin" if "Vin" in ckt.init_params() else "Vs"  # drive node

            override = self.process_overrides.get(name) if use_override else None

            @jax.jit
            def fn(params, state, dc_state, vin, gain0, gain1, static_controls):
                t = (jnp.arange(block_len) + 1.0) / block_len
                g = gain0 + (gain1 - gain0) * t  # per-sample gain ramp
                if override is not None:
                    res = override(
                        params, state, {node: {"v": vin * g}}, static_controls
                    )
                    out, state = res[0], res[1]
                    residual = res[2] if len(res) > 2 else jnp.float32(0.0)
                else:
                    out, state = ckt.process(
                        params, state, {node: {"v": vin * g}},
                        static_controls=static_controls,
                    )
                    residual = jnp.float32(0.0)

                # first-order DC blocker y[t] = x[t] - x[t-1] + rho y[t-1]
                # as a PARALLEL (associative) scan: the linear recurrence
                # y = rho * y_prev + d composes in O(log T) depth instead
                # of a T-step sequential scan, matching the log-depth
                # circuit solve of the deer engine
                x1, y1 = dc_state
                d = out - jnp.concatenate([x1[None], out[:-1]])
                coef = jnp.full_like(out, rho)

                def dc_combine(a, b):
                    return (a[0] * b[0], b[0] * a[1] + b[1])

                A, Y = jax.lax.associative_scan(dc_combine, (coef, d))
                out_dc = A * y1 + Y
                dc_state = (out[-1], out_dc[-1])
                return out_dc, state, dc_state, residual

            self._fns[key] = fn
        return self._fns[key]

    def process_block(
        self,
        audio: np.ndarray,
        circuit: str,
        gain_db: float = 0.0,
        model=None,
        **block_params,
    ) -> np.ndarray:
        """Process one audio block.

        audio: (T,) mono or (C, T) multichannel — summed to mono, processed,
        fanned back out to all channels (``DifferentiableWDFPlugin.cpp:50-81``).

        model: for a group circuit, the block's root-model choice (index,
        schema label, or member name) — switchable per block with state
        continuity, the reference's model hot-swap
        (``DiodeClipperWDF.cpp:32-41``).
        """
        x = np.asarray(audio, dtype=np.float32)
        multi = x.ndim == 2
        mono = x.mean(axis=0) if multi else x
        T = mono.shape[-1]

        member = self._resolve(circuit, model)
        state_key = self._state_key.get(member, member)
        gain1 = float(10.0 ** (gain_db / 20.0))
        fn = self._block_fn(member, T)
        _, params = self.circuits[member]
        static_controls = {}
        if block_params:
            mapper = self.param_maps.get(member) or self.param_maps.get(circuit)
            if mapper is None:
                raise ValueError(f"no param map for circuit {circuit!r}")
            static_controls = mapper(**block_params)
        state_in = self._state[state_key]
        t0 = time.perf_counter()
        out, state, dc_state, residual = fn(
            params,
            state_in,
            self._dc_state,
            jnp.asarray(mono),
            self._gain,
            gain1,
            static_controls,
        )
        residual = float(residual)
        if (
            self.fallback_tol is not None
            and member in self.process_overrides
            and residual > self.fallback_tol
        ):
            # the parallel-in-time engine self-flagged this block: recompute
            # with the exact scan from the same block-input state so serving
            # stays unconditionally correct at every operating point
            exact = self._block_fn(member, T, use_override=False)
            out, state, dc_state, _ = exact(
                params, state_in, self._dc_state, jnp.asarray(mono),
                self._gain, gain1, static_controls,
            )
            self.fallbacks[member] = self.fallbacks.get(member, 0) + 1
            if circuit != member:
                self.fallbacks[circuit] = self.fallbacks.get(circuit, 0) + 1
        out = np.asarray(out)
        dt = time.perf_counter() - t0
        block_dur = T / self.fs
        self._load = 0.9 * self._load + 0.1 * (dt / block_dur)

        self._state[state_key] = state
        self._dc_state = dc_state
        self.last_residual[member] = residual
        if circuit != member:
            self.last_residual[circuit] = residual
        self._gain = gain1
        if multi:
            return np.broadcast_to(out, x.shape).copy()
        return out

    def warmup(self, block_sizes, circuits=None,
               block_params: Optional[Dict[str, Dict[str, Any]]] = None
               ) -> Dict[str, Any]:
        """Pre-compile every (member, block size, engine variant) block
        function so the FIRST streamed block runs at steady-state latency.

        The reference engine is real-time safe from sample one because
        ``prepareToPlay`` does all setup up front
        (``DifferentiableWDFPlugin.cpp:27-38``; compile-time WDF templates +
        fixed-size RTNeural models, ``DiodePairNeuralModel.h:11-40``).  Here
        the analogue of "setup" is XLA compilation: without this call the
        first block at a new size, the first hot-swap to an uncompiled group
        member, and the first residual-triggered fallback each stall the
        stream for a full compile.

        block_sizes: iterable of block lengths to compile.
        circuits: served names (groups and/or circuit names; default = all
        surfaces).  Group names expand to every member, so every hot-swap
        target is compiled.
        block_params: optional {served_name: {kwarg: value}} exercised
        through the circuit's param map; by default the registered schema's
        float defaults are used (so the compiled call shape matches real
        ``process_block(..., cutoff_hz=...)`` usage), plus the bare
        no-block-params shape.  For each member with a parallel-in-time
        override the exact-scan fallback variant is compiled too.

        Returns {"n_compiled": int, "seconds": float, "keys": [...]}.
        Processor state (circuit state, DC blocker, gain) is untouched.
        """
        from ..device import enable_compile_cache

        enable_compile_cache()  # a restarted server finds these compiles
        t0 = time.perf_counter()
        if circuits is None:
            circuits = self.surfaces()
        members = []  # (served_name, member_name)
        for c in circuits:
            if c in self.groups:
                members.extend((c, m) for m in self.groups[c])
            else:
                self._resolve(c, None)  # raises on unknown names
                members.append((c, c))

        def _default_block_params(served):
            mapper = self.param_maps.get(served)
            if mapper is None:
                return None
            import inspect

            args = set(inspect.signature(mapper).parameters)
            kw = {}
            for s in self.param_specs(served):
                if s.kind == "float" and s.api in args:
                    kw[s.api] = s.default
            return kw if set(kw) == args else None

        compiled = []
        for served, member in members:
            _, params = self.circuits[member]
            state = self._state[self._state_key.get(member, member)]
            mapper = self.param_maps.get(member) or self.param_maps.get(served)
            ctl_variants = [{}]
            kw = (block_params or {}).get(served)
            if kw is None:
                kw = _default_block_params(served)
            if kw and mapper is not None:
                ctl_variants.append(mapper(**kw))
            variants = [True]
            if (member in self.process_overrides
                    and self.fallback_tol is not None):
                variants.append(False)  # the exact-scan fallback path
            for T in block_sizes:
                x = jnp.zeros((int(T),), jnp.float32)
                for use_override in variants:
                    fn = self._block_fn(member, int(T), use_override)
                    for ctl in ctl_variants:
                        out = fn(params, state, self._dc_state, x, 1.0, 1.0,
                                 ctl)
                        jax.block_until_ready(out)
                        compiled.append((member, int(T), use_override,
                                         bool(ctl)))
        return {
            "n_compiled": len(compiled),
            "seconds": time.perf_counter() - t0,
            "keys": compiled,
        }

    def reset(self):
        for name, (ckt, _) in self.circuits.items():
            self._state[self._state_key.get(name, name)] = ckt.init_state()
        self._dc_state = (jnp.zeros(()), jnp.zeros(()))

    def set_params(self, circuit: str, params, model=None) -> None:
        """Replace the trained params of a circuit — group-aware: for a
        group name this targets the member selected by ``model`` (the
        group's default choice when omitted)."""
        member = self._resolve(circuit, model)
        self.circuits[member] = (self.circuits[member][0], params)


def _deer_override(ckt: Circuit, n_iters: int = 16, damping: float = 1.0):
    """The ``engine="deer"`` block override: Newton over the whole block's
    trajectory (``ops.parallel_time``) — log-depth in the block length
    instead of a sequential scan — returning its final residual as the
    block's certificate, so ``StreamingProcessor.fallback_tol`` can redo a
    flagged block with the exact scan."""
    from ..ops.parallel_time import parallel_time_process

    def run(params, state, inputs, static_controls):
        # float32 products: Newton over the trajectory amplifies reduced-
        # precision (TF32) root evaluations into a residual floor above
        # the fallback tolerance
        with jax.default_matmul_precision("highest"):
            return parallel_time_process(
                ckt, params, inputs, n_iters=n_iters, state0=state,
                damping=damping, static_controls=static_controls,
                return_state=True, return_residual=True,
            )

    return run


def make_clipper_processor(
    fs: float,
    cutoff_hz: float = 4000.0,
    models: Tuple[str, ...] = ("toms", "approx", "neural_2x16"),
    mlp_json: Optional[str] = None,
    engine: str = "scan",
) -> StreamingProcessor:
    """Build the reference plugin's circuit set: diode clipper under all
    root models, with cutoff mapped to source resistance.

    engine="deer" serves every root through the parallel-in-time solver
    (``_deer_override``) at any block length, with the exact scan as the
    residual-triggered fallback."""
    import diffwdf as dwdf
    from ..models.diode_clipper import cutoff_to_resistance, make_diode_clipper

    cap = 2.2e-9
    r = cutoff_to_resistance(cutoff_hz, cap)
    circuits = {}
    for m in models:
        if m == "toms":
            root = dwdf.DiodePairRoot(
                name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best"
            )
            ckt = make_diode_clipper(root, fs, r_source=r, cap=cap)
            params = {**ckt.init_params(), **root.init_params()}
        elif m == "approx":
            root = dwdf.DiodePairRoot(
                name="dp", diode=dwdf.diode_1n4148_1u1d, quality="low"
            )
            ckt = make_diode_clipper(root, fs, r_source=r, cap=cap)
            params = {**ckt.init_params(), **root.init_params()}
        elif m.startswith("neural"):
            from ..models.diode_clipper import make_neural_root_or_default

            try:  # "neural_2x16" -> (2, 16); bare "neural" -> 2x16
                n_l, width = (int(v) for v in m.split("_")[1].split("x"))
            except (IndexError, ValueError):
                n_l, width = 2, 16
            root, frag = make_neural_root_or_default(
                "dp", n_l, width, json_path=mlp_json
            )
            ckt = make_diode_clipper(root, fs, r_source=r, cap=cap)
            params = {**ckt.init_params(), **frag}
        else:
            raise ValueError(m)
        circuits[m] = (ckt, params)

    def clipper_map(cutoff_hz):
        return {"Vs": {"R": cutoff_to_resistance(cutoff_hz, cap)}}

    overrides = (
        {m: _deer_override(c) for m, (c, _) in circuits.items()}
        if engine == "deer" else {}
    )

    specs = clipper_param_specs(choices=tuple(circuits))
    names = list(circuits) + ["clipper"]
    return StreamingProcessor(
        circuits, fs, param_maps={m: clipper_map for m in names},
        param_schemas={m: specs for m in names},
        process_overrides=overrides,
        groups={"clipper": tuple(circuits)},
    )


def make_hpf_processor(
    fs: float,
    cutoff_hz: float = 4000.0,
    lpf_trained_json: Optional[str] = None,
    hpf_trained_json: Optional[str] = None,
    engine: str = "scan",
) -> StreamingProcessor:
    """The HPF clipper circuit under its 4 root choices
    (``HPFDiodeClipper.cpp:29-30,60-66``): TOMS, approx, the LPF-trained
    2x16 run in the unseen topology ("extrapolated"), and the HPF-trained
    2x16 ("trained").  Cutoff maps to the load resistor R = 1/(2 pi f C)
    with C fixed at 2.2 nF."""
    from ..models.diode_clipper import (
        cutoff_to_resistance,
        make_hpf_diode_clipper,
        make_hpf_root_from_zoo,
    )

    cap = 2.2e-9
    r_load = cutoff_to_resistance(cutoff_hz, cap)
    names = ("toms", "approx", "extrapolated", "trained")
    json_for = {
        "extrapolated": lpf_trained_json,
        "trained": hpf_trained_json,
    }
    circuits = {}
    for i, name in enumerate(names):
        root, frag = make_hpf_root_from_zoo(i, json_path=json_for.get(name))
        ckt = make_hpf_diode_clipper(root, fs, r_load=r_load, cap=cap)
        circuits[name] = (ckt, {**ckt.init_params(), **frag})

    def hpf_map(cutoff_hz):
        return {"R": {"R": cutoff_to_resistance(cutoff_hz, cap)}}

    overrides = {}
    if engine == "deer":
        # the HPF's series capacitor is a marginal slow state mode
        # (|df/dz| -> 1): plain Newton oscillates there, damped Newton with
        # ~4x the sweeps converges (see ops.parallel_time)
        overrides = {
            n: _deer_override(c, n_iters=48, damping=0.5)
            for n, (c, _) in circuits.items()
        }

    specs = hpf_param_specs()
    all_names = list(circuits) + ["hpf"]
    return StreamingProcessor(
        circuits, fs, param_maps={n: hpf_map for n in all_names},
        param_schemas={n: specs for n in all_names},
        process_overrides=overrides,
        groups={"hpf": tuple(circuits)},
    )


def make_plugin_processor(
    fs: float,
    cutoff_hz: float = 4000.0,
    drive: float = 0.5,
    mlp_json: Optional[str] = None,
    clipper_zoo: Optional[int] = None,
    clipper_json: Optional[str] = None,
    engine: str = "scan",
) -> StreamingProcessor:
    """The full reference-plugin circuit set (``DifferentiableWDFPlugin.h:41-43``):
    diode clipper, multi-diode clipper, and Tube Screamer, as model GROUPS —
    every advertised "model" choice is registered and hot-swappable at block
    rate with state continuity, exactly the reference's root hot-swap
    (``DiodeClipperWDF.cpp:32-41``, ``MultiDiodeClipper.cpp:48``,
    ``CircuitModelGUI.cpp:55-66``):

    - "clipper": all 7 DiodeClipper roots (zoo entries 0-6 — TOMS, approx,
      five 1U-1D neural sizes), members "clipper/0".."clipper/6";
    - "multi_diode_clipper": the 5 multi-diode 2x16 nets (zoo 7-11);
    - "tube_screamer": approx analytic + 2x16 neural
      (``TubeScreamer.h:73-74``).

    ``clipper_zoo`` picks the DEFAULT model choice by GLOBAL zoo index
    (0-11): 0-6 set the clipper group's default, 7-11 the multi-diode
    group's (``MultiDiodeClipper.cpp:48``); ``clipper_json`` overrides the
    selected entry's neural weights; ``mlp_json`` overrides the Tube
    Screamer's neural-model weights.  Neural entries default to the
    checked-in pretrained zoo (ZOO_MODEL_PATHS)."""
    import diffwdf as dwdf
    from ..models.diode_clipper import (
        cutoff_to_resistance,
        make_diode_clipper,
        make_neural_root_or_default,
        make_root_from_zoo,
    )
    from ..models.tube_screamer import drive_to_r6, make_tube_screamer

    cap = 2.2e-9
    r = cutoff_to_resistance(cutoff_hz, cap)
    circuits = {}
    param_maps = {}
    groups = {}

    zoo = clipper_zoo if clipper_zoo is not None else 0
    if not 0 <= zoo < 12:
        raise ValueError(f"clipper_zoo must be a zoo index 0-11, got {zoo}")
    default_clipper = zoo if zoo < 7 else 0
    default_md = zoo - 7 if zoo >= 7 else 0

    # clipper group: the full 7-root zoo, one circuit per root on the shared
    # Vs(R) || C tree (state {"C": {"z"}} carried across model switches)
    clipper_members = []
    for i in range(7):
        root, frag = make_root_from_zoo(
            i, json_path=clipper_json if (i == zoo) else None
        )
        ckt_i = make_diode_clipper(root, fs, r_source=r, cap=cap)
        name = f"clipper/{i}"
        circuits[name] = (ckt_i, {**ckt_i.init_params(), **frag})
        clipper_members.append(name)
    groups["clipper"] = tuple(clipper_members)

    # multi-diode group: zoo entries 7-11 (``MultiDiodeClipper.cpp:48``
    # offsets the model index by +7 into the same WDF)
    md_members = []
    for k, i in enumerate(range(7, 12)):
        root, frag = make_root_from_zoo(
            i, json_path=clipper_json if (i == zoo) else None
        )
        ckt_i = make_diode_clipper(root, fs, r_source=r, cap=cap)
        name = f"multi_diode_clipper/{k}"
        circuits[name] = (ckt_i, {**ckt_i.init_params(), **frag})
        md_members.append(name)
    groups["multi_diode_clipper"] = tuple(md_members)

    def clipper_map(cutoff_hz):
        return {"Vs": {"R": cutoff_to_resistance(cutoff_hz, cap)}}

    for n in clipper_members + md_members + ["clipper", "multi_diode_clipper"]:
        param_maps[n] = clipper_map

    # tube screamer group: approx analytic root (the reference's
    # wdft::DiodePairT choice) + the 2x16 neural root
    ts_root0 = dwdf.DiodePairRoot(
        name="dp", diode=dwdf.diode_1n4148_1u1d, quality="low"
    )
    ts0 = make_tube_screamer(ts_root0, fs, drive=drive)
    circuits["tube_screamer/0"] = (
        ts0, {**ts0.init_params(), **ts_root0.init_params()}
    )
    ts_root1, ts_frag1 = make_neural_root_or_default(
        "dp", 2, 16, json_path=mlp_json
    )
    ts1 = make_tube_screamer(ts_root1, fs, drive=drive)
    circuits["tube_screamer/1"] = (ts1, {**ts1.init_params(), **ts_frag1})
    groups["tube_screamer"] = ("tube_screamer/0", "tube_screamer/1")
    ts_map = lambda drive: {"R6": {"R": drive_to_r6(drive)}}
    for n in ("tube_screamer/0", "tube_screamer/1", "tube_screamer"):
        param_maps[n] = ts_map

    overrides = (
        {n: _deer_override(c) for n, (c, _) in circuits.items()}
        if engine == "deer" else {}
    )

    cl_specs = clipper_param_specs()
    cl_specs = tuple(
        dataclasses.replace(s, default_choice=default_clipper)
        if s.name == "model" else s
        for s in cl_specs
    )
    md_specs = tuple(
        dataclasses.replace(s, default_choice=default_md)
        if s.name == "model" else s
        for s in multi_diode_param_specs()
    )
    ts_specs = tube_screamer_param_specs()
    schemas = {"clipper": cl_specs, "multi_diode_clipper": md_specs,
               "tube_screamer": ts_specs}
    for m in clipper_members:
        schemas[m] = cl_specs
    for m in md_members:
        schemas[m] = md_specs
    schemas["tube_screamer/0"] = schemas["tube_screamer/1"] = ts_specs

    return StreamingProcessor(
        circuits, fs, param_maps=param_maps,
        param_schemas=schemas,
        process_overrides=overrides,
        groups=groups,
    )
