"""Circuit -> native C codegen: compile any WDF `Circuit`'s per-sample step
to a single-core C engine.

This is the native-runtime analog of ``ops/fused_circuit.py`` (and of the
reference's compile-time C++ circuit templates, ``plugin/src/dsp/*``): the
circuit's pure ``step`` is traced once with scalar f64 inputs, and the
resulting jaxpr is translated — fully unrolled, constants folded — into a C
function ``step_block(in, out, n, state)`` that g++ compiles to a shared
library.  Any topology (series/parallel/R-type), any root whose math traces
to elementwise ops (analytic diode pairs, MLPs) gets a deployable CPU
engine with zero hand-written per-circuit C++.

Component params and adapted coefficients are baked in as compile-time
constants, exactly like the reference plugin bakes component values into
template instantiations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Any, Dict, Optional

import numpy as np

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "build", "codegen"
)


class _Emit:
    """Collects C statements; every produced value is a fresh double var."""

    def __init__(self):
        self.lines = []
        self.n = 0

    def tmp(self, expr: str) -> "Expr":
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"double {name} = {expr};")
        return Expr(name, self)


class Expr:
    """A named C double value.  Arithmetic emits new temp assignments, so
    numpy object arrays of Expr support broadcasting and structural ops."""

    __array_priority__ = 1000  # beat numpy scalars in mixed ops

    def __init__(self, name: str, em: _Emit):
        self.name = name
        self.em = em

    def _c(self, other) -> str:
        if isinstance(other, Expr):
            return other.name
        return _lit(other)

    def __add__(self, o):
        return self.em.tmp(f"{self.name} + {self._c(o)}")

    def __radd__(self, o):
        return self.em.tmp(f"{self._c(o)} + {self.name}")

    def __sub__(self, o):
        return self.em.tmp(f"{self.name} - {self._c(o)}")

    def __rsub__(self, o):
        return self.em.tmp(f"{self._c(o)} - {self.name}")

    def __mul__(self, o):
        return self.em.tmp(f"{self.name} * {self._c(o)}")

    def __rmul__(self, o):
        return self.em.tmp(f"{self._c(o)} * {self.name}")

    def __truediv__(self, o):
        return self.em.tmp(f"{self.name} / {self._c(o)}")

    def __rtruediv__(self, o):
        return self.em.tmp(f"{self._c(o)} / {self.name}")

    def __neg__(self):
        return self.em.tmp(f"-{self.name}")


def _lit(x) -> str:
    v = float(np.asarray(x))
    return f"{v!r}"


def _is_const(x) -> bool:
    if isinstance(x, Expr):
        return False
    return not (isinstance(x, np.ndarray) and x.dtype == object)


def _to_obj(x, em: _Emit) -> np.ndarray:
    """Promote a constant numpy array to an object array of literal Exprs."""
    if isinstance(x, Expr):
        a = np.empty((), dtype=object)
        a[()] = x
        return a
    if _is_const(x):
        flat = [em.tmp(_lit(v)) for v in np.ravel(np.asarray(x, np.float64))]
        return np.array(flat, dtype=object).reshape(np.shape(x))
    return x


def _unary(em, fn):
    def run(x):
        if _is_const(x):
            return getattr(np, fn)(np.asarray(x, np.float64))
        out = np.empty(x.shape, dtype=object)
        for idx in np.ndindex(x.shape or (1,)):
            idx = idx if x.shape else ()
            out[idx] = em.tmp(f"{fn}({x[idx].name})")
        return out

    return run


def _translate(jaxpr, consts, invals, em: _Emit):
    """Evaluate a (closed) jaxpr over numpy-constant / Expr-array values."""
    env: Dict[Any, Any] = {}

    def read(v):
        if hasattr(v, "val"):  # Literal
            return np.asarray(v.val, np.float64)
        return env[v]

    def write(v, val):
        env[v] = val

    for v, c in zip(jaxpr.constvars, consts):
        write(v, np.asarray(c, np.float64))
    for v, a in zip(jaxpr.invars, invals):
        write(v, a)

    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        ins = [read(v) for v in eqn.invars]

        if prim in ("pjit", "jit", "closed_call", "custom_jvp_call",
                    "custom_vjp_call", "custom_jvp_call_jaxpr"):
            inner = eqn.params.get("jaxpr") or eqn.params.get("call_jaxpr")
            if hasattr(inner, "jaxpr"):  # ClosedJaxpr
                outs = _translate(inner.jaxpr, inner.consts, ins, em)
            else:
                outs = _translate(inner, [], ins, em)
            if eqn.primitive.name.startswith("custom_vjp"):
                pass
            for v, o in zip(eqn.outvars, outs):
                write(v, o)
            continue

        if all(_is_const(x) for x in ins):
            # constant fold with numpy
            val = _fold_const(prim, eqn, ins)
            if val is not NotImplemented:
                for v, o in zip(
                    eqn.outvars, val if isinstance(val, tuple) else (val,)
                ):
                    write(v, o)
                continue

        objs = [_to_obj(x, em) for x in ins]
        out = _emit_prim(prim, eqn, objs, em)
        for v, o in zip(eqn.outvars, out if isinstance(out, tuple) else (out,)):
            write(v, o)

    return [read(v) for v in jaxpr.outvars]


def _broadcast_in_dim(x, p):
    shape = tuple(p["shape"])
    x = np.asarray(x)
    if x.ndim == 0:
        return np.broadcast_to(x, shape).copy() if shape else x
    resh = [1] * len(shape)
    for src_d, dst_d in enumerate(p["broadcast_dimensions"]):
        resh[dst_d] = x.shape[src_d]
    return np.broadcast_to(np.reshape(x, resh), shape).copy()


def _fold_const(prim, eqn, ins):
    p = eqn.params
    try:
        if prim == "add":
            return ins[0] + ins[1]
        if prim == "sub":
            return ins[0] - ins[1]
        if prim == "mul":
            return ins[0] * ins[1]
        if prim == "div":
            return ins[0] / ins[1]
        if prim == "neg":
            return -ins[0]
        if prim in ("exp", "log", "tanh", "sign", "sin", "cos", "sqrt"):
            return getattr(np, prim)(ins[0])
        if prim == "integer_pow":
            return ins[0] ** p["y"]
        if prim == "max":
            return np.maximum(ins[0], ins[1])
        if prim == "min":
            return np.minimum(ins[0], ins[1])
        if prim in ("ge", "gt", "le", "lt", "eq", "ne"):
            op = {"ge": np.greater_equal, "gt": np.greater, "le": np.less_equal,
                  "lt": np.less, "eq": np.equal, "ne": np.not_equal}[prim]
            return op(ins[0], ins[1]).astype(np.float64)
        if prim == "select_n":
            c = ins[0].astype(np.int64)
            return np.choose(c, ins[1:])
        if prim == "convert_element_type":
            return np.asarray(ins[0], np.float64)
        if prim == "broadcast_in_dim":
            return _broadcast_in_dim(ins[0], p)
        if prim == "squeeze":
            return np.squeeze(ins[0], axis=tuple(p["dimensions"]))
        if prim == "reshape":
            return np.reshape(ins[0], p["new_sizes"])
        if prim == "slice":
            sl = tuple(
                slice(s, l, st)
                for s, l, st in zip(
                    p["start_indices"], p["limit_indices"],
                    p["strides"] or [1] * len(p["start_indices"]),
                )
            )
            return ins[0][sl]
        if prim == "concatenate":
            return np.concatenate(ins, axis=p["dimension"])
        if prim == "transpose":
            return np.transpose(ins[0], p["permutation"])
        if prim == "dot_general":
            return NotImplemented  # rare as all-const; just emit
        if prim == "stop_gradient":
            return ins[0]
    except Exception:
        return NotImplemented
    return NotImplemented


def _emit_prim(prim, eqn, ins, em: _Emit):
    p = eqn.params

    def scalarwise(fmt, *xs):
        shape = np.broadcast_shapes(*[np.shape(x) for x in xs])
        bs = [np.broadcast_to(x, shape) for x in xs]
        out = np.empty(shape, dtype=object)
        for idx in np.ndindex(shape or (1,)):
            idx = idx if shape else ()
            out[idx] = em.tmp(fmt.format(*[b[idx].name for b in bs]))
        return out

    if prim == "add":
        return ins[0] + ins[1]
    if prim == "sub":
        return ins[0] - ins[1]
    if prim == "mul":
        return ins[0] * ins[1]
    if prim == "div":
        return ins[0] / ins[1]
    if prim == "neg":
        return -ins[0]
    if prim in ("exp", "log", "tanh", "sqrt", "sin", "cos"):
        return scalarwise(prim + "({0})", ins[0])
    if prim == "sign":
        return scalarwise("(double)(({0} > 0.0) - ({0} < 0.0))", ins[0])
    if prim == "integer_pow":
        y = p["y"]
        if y == 2:
            return scalarwise("{0} * {0}", ins[0])
        return scalarwise(f"pow({{0}}, {float(y)!r})", ins[0])
    if prim == "max":
        return scalarwise("fmax({0}, {1})", ins[0], ins[1])
    if prim == "min":
        return scalarwise("fmin({0}, {1})", ins[0], ins[1])
    if prim in ("ge", "gt", "le", "lt", "eq", "ne"):
        op = {"ge": ">=", "gt": ">", "le": "<=", "lt": "<", "eq": "==",
              "ne": "!="}[prim]
        return scalarwise(f"(double)({{0}} {op} {{1}})", ins[0], ins[1])
    if prim == "select_n":
        assert len(ins) == 3, "select_n with >2 cases not needed"
        return scalarwise("({0} != 0.0) ? {2} : {1}", ins[0], ins[1], ins[2])
    if prim in ("convert_element_type", "stop_gradient", "copy"):
        return ins[0]
    if prim == "broadcast_in_dim":
        return _broadcast_in_dim(ins[0], p)
    if prim == "squeeze":
        return np.squeeze(ins[0], axis=tuple(p["dimensions"]))
    if prim == "reshape":
        return np.reshape(ins[0], p["new_sizes"])
    if prim == "slice":
        sl = tuple(
            slice(s, l, st)
            for s, l, st in zip(
                p["start_indices"], p["limit_indices"],
                p["strides"] or [1] * len(p["start_indices"]),
            )
        )
        return ins[0][sl]
    if prim == "concatenate":
        return np.concatenate(ins, axis=p["dimension"])
    if prim == "transpose":
        return np.transpose(ins[0], p["permutation"])
    if prim == "dot_general":
        ((lc, rc), (lb, rb)) = p["dimension_numbers"]
        a, b = ins
        assert not lb and not rb, "batched dot not supported"
        assert len(lc) == 1 and len(rc) == 1, "one contraction dim"
        a2 = np.moveaxis(a, lc[0], -1)
        b2 = np.moveaxis(b, rc[0], 0)
        out_shape = a2.shape[:-1] + b2.shape[1:]
        out = np.empty(out_shape, dtype=object)
        K = a2.shape[-1]
        for ai in np.ndindex(a2.shape[:-1] or (1,)):
            ai = ai if a2.shape[:-1] else ()
            for bi in np.ndindex(b2.shape[1:] or (1,)):
                bi = bi if b2.shape[1:] else ()
                terms = " + ".join(
                    f"{a2[ai + (k,)].name} * {b2[(k,) + bi].name}"
                    for k in range(K)
                )
                out[ai + bi] = em.tmp(terms)
        return out
    raise NotImplementedError(f"codegen: unsupported primitive {prim!r}")


_TEMPLATE = """// generated by diffwdf.native.codegen — do not edit
#include <cmath>
using std::exp; using std::log; using std::tanh; using std::pow;
using std::fmax; using std::fmin; using std::sqrt; using std::sin; using std::cos;

extern "C" void step_block(const float* in, float* out, long long n,
                           double* state) {{
{state_load}
  for (long long i = 0; i < n; ++i) {{
    double v = (double) in[i];
{body}
    out[i] = (float) {out_var};
{state_update}
  }}
{state_store}
}}
"""


class NativeCircuit:
    """A circuit compiled to a native single-core C engine."""

    def __init__(self, so_path: str, n_states: int, source: str):
        self.n_states = n_states
        self.source = source
        self._lib = ctypes.CDLL(so_path)
        self._lib.step_block.restype = None
        self._lib.step_block.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_double),
        ]

    def process(self, x: np.ndarray, state: Optional[np.ndarray] = None):
        """x: float32 [T] -> (out [T], state [S])."""
        x = np.ascontiguousarray(x, np.float32)
        out = np.empty_like(x)
        st = (
            np.zeros(self.n_states, np.float64)
            if state is None
            else np.ascontiguousarray(state, np.float64).copy()
        )
        self._lib.step_block(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(x),
            st.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out, st


def compile_circuit(
    circuit,
    params,
    *,
    input_node: str = "Vin",
    static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
    cache: bool = True,
) -> NativeCircuit:
    """Trace circuit.step at f64 scalars, translate the jaxpr to C, build
    with g++, and return a NativeCircuit engine."""
    import jax
    import jax.numpy as jnp

    # trace in f64 without disturbing global config
    enable_x64 = jax.enable_x64

    coeffs = circuit.adapt(params, static_controls or {})
    s_leaves, s_td = jax.tree_util.tree_flatten(circuit.init_state())
    S = len(s_leaves)

    def f(svec, v):
        st = jax.tree_util.tree_unflatten(s_td, [svec[i] for i in range(S)])
        controls = {k: dict(vv) for k, vv in (static_controls or {}).items()}
        controls.setdefault(input_node, {})
        controls[input_node]["v"] = v
        new_state, waves = circuit.step(params, coeffs, st, controls)
        out = circuit.probe(waves)
        return jnp.stack(jax.tree_util.tree_leaves(new_state)), out

    with enable_x64():
        closed = jax.make_jaxpr(f)(jnp.zeros((S,), jnp.float64), jnp.float64(0.0))

    em = _Emit()
    svec = np.array([Expr(f"s{i}", em) for i in range(S)], dtype=object)
    vexp = Expr("v", em)
    new_s, out = _translate(closed.jaxpr, closed.consts, [svec, vexp], em)

    out_e = out if isinstance(out, Expr) else np.asarray(out, dtype=object).reshape(())[()]
    if not isinstance(out_e, Expr):
        out_e = em.tmp(_lit(out_e))
    new_s = _to_obj(new_s, em)

    body = "\n".join("    " + l for l in em.lines)
    src = _TEMPLATE.format(
        state_load="\n".join(f"  double s{i} = state[{i}];" for i in range(S)),
        body=body,
        out_var=out_e.name,
        state_update="\n".join(
            f"    s{i} = {np.ravel(new_s)[i].name};" for i in range(S)
        ),
        state_store="\n".join(f"  state[{i}] = s{i};" for i in range(S)),
    )

    os.makedirs(_CACHE_DIR, exist_ok=True)
    h = hashlib.sha1(src.encode()).hexdigest()[:16]
    so = os.path.join(_CACHE_DIR, f"circuit_{h}.so")
    if not (cache and os.path.exists(so)):
        with tempfile.NamedTemporaryFile(
            "w", suffix=".cpp", dir=_CACHE_DIR, delete=False
        ) as fsrc:
            fsrc.write(src)
            cpath = fsrc.name
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", f"{so}.{os.getpid()}", cpath],
                check=True, capture_output=True, text=True,
            )
            os.replace(f"{so}.{os.getpid()}", so)  # atomic for other workers
        finally:
            os.unlink(cpath)
    return NativeCircuit(so, S, src)
