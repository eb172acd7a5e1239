"""The fused kernel across root families, tile shapes, pot streams and
outputs, plus its Triton (GPU) lowering.

On the CPU the kernel runs in Pallas interpret mode; the lowering tests
build the Triton version of the kernel, which needs no card.  The one test
marked ``gpu`` runs the compiled kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import diffwdf as dwdf
from diffwdf.models.diode_clipper import (
    make_diode_clipper,
    make_hpf_diode_clipper,
    make_root_from_zoo,
    make_training_clipper,
)
from diffwdf.models.tube_screamer import drive_to_r6, make_tube_screamer
from diffwdf.ops.fused_circuit import fused_circuit_process
from diffwdf.roots.neural import NeuralDiodeRoot

FS = 96000.0
B, T = 40, 96  # B fills no 32-row tile exactly


def _vin(seed=0, amp=1.5, b=B, t=T):
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = amp * np.sin(2 * np.pi * 1000.0 * n / FS)[None, :] * np.ones((b, 1))
    x = x + 0.1 * amp * rng.standard_normal((b, t))
    return jnp.asarray(x, jnp.float32)


def _batched_state(circuit, b=B):
    return jax.tree_util.tree_map(
        lambda z: jnp.zeros((b,), jnp.float32), circuit.init_state()
    )


def _scan_ref(circuit, params, vin, input_node):
    def one(v):
        return circuit.process(params, circuit.init_state(),
                               {input_node: {"v": v}})

    return jax.vmap(one)(vin)


def _neural(n_layers, width, acts=(), seed=3):
    root = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width,
                           activations=acts)
    return root, root.init_params(jax.random.PRNGKey(seed))


def _case(name):
    """(circuit, params, drive node, drive amplitude)."""
    analytic = lambda q, d=dwdf.diode_1n4148_1u1d: (  # noqa: E731
        dwdf.DiodePairRoot(name="dp", diode=d, quality=q), None)
    roots = {
        "clipper_analytic": lambda: analytic("best", dwdf.diode_1n4148_1u2d),
        "clipper_approx": lambda: analytic("low"),
        "neural_2x4": lambda: _neural(2, 4),
        "neural_2x16": lambda: _neural(2, 16),
        "neural_4x8": lambda: _neural(4, 8),
        "neural_relu_mixed": lambda: _neural(2, 8, ("tanh", "relu", "tanh", "")),
        "multi_diode_2u3d": lambda: make_root_from_zoo(10),  # pretrained 2x16
        "ts_analytic": lambda: analytic("low"),
        "ts_neural": lambda: _neural(2, 16),
        "hpf": lambda: analytic("best"),
    }
    root, frag = roots[name]()
    frag = frag or root.init_params()
    if name.startswith("ts_"):
        ckt, node, amp = make_tube_screamer(root, FS, drive=0.5), "Vin", 0.2
    elif name == "hpf":
        ckt, node, amp = make_hpf_diode_clipper(root, FS), "Vs", 1.5
    else:
        ckt, node, amp = make_diode_clipper(root, FS), "Vs", 1.5
    return ckt, {**ckt.init_params(), **frag}, node, amp


CASES = (
    "clipper_analytic", "clipper_approx", "neural_2x4", "neural_2x16",
    "neural_4x8", "neural_relu_mixed", "multi_diode_2u3d", "ts_analytic",
    "ts_neural", "hpf",
)


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_scan(name):
    """Outputs and final state of every circuit/root family, including the
    R-type Tube Screamer (3 states + 4x4 S-matrix) and relu-mixed MLPs."""
    ckt, params, node, amp = _case(name)
    vin = _vin(CASES.index(name), amp)
    ref, ref_st = _scan_ref(ckt, params, vin, node)
    out, st = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), input_node=node, interpret=True
    )
    assert out.shape == (B, T)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref_st)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)


@pytest.mark.parametrize("b,t", [(1, 7), (33, 50), (64, 1)])
def test_partial_tiles(b, t):
    """B and T that fill no tile: rows are padded to the tile and dropped."""
    ckt, params, node, amp = _case("ts_analytic")
    vin = _vin(5, amp, b, t)
    ref, _ = _scan_ref(ckt, params, vin, node)
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt, b), input_node=node,
        interpret=True,
    )
    assert out.shape == (b, t)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_return_state_seq_is_the_pre_step_trajectory():
    """return_state_seq yields z_{t-1} for every step t: column 0 is the
    initial state, column t+1 the state the scan holds after step t."""
    ckt, params, node, amp = _case("ts_analytic")
    vin = _vin(8, amp)
    _, _, seqs = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), input_node=node,
        interpret=True, return_state_seq=True,
    )
    coeffs = ckt.adapt(params, {})

    def traj(v):
        def body(s, x):
            s2, _ = ckt.step(params, coeffs, s, {node: {"v": x}})
            return s2, jax.tree_util.tree_leaves(s)

        return jax.lax.scan(body, ckt.init_state(), v)[1]

    want = jax.vmap(traj)(vin)
    assert len(seqs) == len(want) == 3
    for got, w in zip(seqs, want):
        assert got.shape == (B, T)
        np.testing.assert_allclose(np.asarray(got), np.asarray(w), atol=2e-5)


def _pot_case(name, per_sample):
    """(circuit, params, drive node, pot node, amp, R values)."""
    rng = np.random.default_rng(41)
    if name == "hpf":
        ckt, params, node, amp = _case("hpf")
        pot = "Vs"
        walk = (np.cumsum(0.02 * rng.standard_normal((B, T)), axis=1)
                if per_sample else rng.uniform(0.0, 0.7, B))
        r = np.exp(np.log(36e3) + walk)
    else:
        root, frag = _neural(2, 8)
        ckt = make_tube_screamer(root, FS)
        params, node, amp, pot = {**ckt.init_params(), **frag}, "Vin", 0.3, "R6"
        d = (np.clip(0.5 + np.cumsum(0.01 * rng.standard_normal((B, T)), 1),
                     0.0, 1.0)
             if per_sample else rng.uniform(0.0, 1.0, B))
        r = drive_to_r6(d)
    return ckt, params, node, pot, amp, jnp.asarray(r, jnp.float32)


@pytest.mark.parametrize("per_sample", [False, True], ids=["row", "sample"])
@pytest.mark.parametrize("name", ["hpf", "ts_neural"])
def test_pot_streams_match_scan(name, per_sample):
    """Per-row (B,) and per-sample (B, T) pot controls re-adapt the tree per
    stream / per step; the neural root's log-R conditioning follows."""
    ckt, params, node, pot, amp, r = _pot_case(name, per_sample)
    vin = _vin(9, amp)

    def one(v, rr):
        inputs = {node: {"v": v}}
        if per_sample:
            inputs.setdefault(pot, {})["R"] = rr
            return ckt.process(params, ckt.init_state(), inputs,
                               adapt_per_sample=True)[0]
        return ckt.process(params, ckt.init_state(), inputs,
                           static_controls={pot: {"R": rr}})[0]

    ref = jax.vmap(one)(vin, r)
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt), input_node=node,
        row_controls={pot: {"R": r}}, interpret=True,
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-5)


def _lower_for_cuda(ckt, params, node, b, t, **kw):
    """StableHLO of the kernel wrapper for CUDA: the Pallas Triton lowering
    runs on the host, no card needed."""
    from jax import export

    st = _batched_state(ckt, b)
    f = jax.jit(lambda p, v, s: fused_circuit_process(
        ckt, p, v, s, input_node=node, interpret=False, **kw))
    exp = export.export(
        f, platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(params, jnp.zeros((b, t), jnp.float32), st)
    return exp.mlir_module()


@pytest.mark.parametrize(
    "name", ["clipper_analytic", "neural_2x16", "ts_analytic", "hpf_row_seq"]
)
def test_triton_lowering_for_cuda(name):
    """The GPU route lowers every root family through Triton (one
    ``xla.gpu.triton`` custom call), including pot rows and the state
    trajectory output."""
    kw = {}
    if name == "hpf_row_seq":
        ckt, params, node, _ = _case("hpf")
        kw = dict(row_controls={"Vs": {"R": jnp.full((64,), 45e3)}},
                  return_state_seq=True)
    else:
        ckt, params, node, _ = _case(name)
    mod = _lower_for_cuda(ckt, params, node, 64, 128, **kw)
    assert mod.count("xla.gpu.triton") == 1, name


def test_fused_generic_clipper_gradcheck():
    """The training clipper (neural root, per-row pot r0) on the
    fused_generic engine: loss and every gradient match scan BPTT."""
    from diffwdf.training.circuit_train import CircuitTrainConfig, make_loss_fn

    root, frag = _neural(2, 8, seed=4)
    ckt = make_training_clipper(root, 48000.0)
    params = {**ckt.init_params(), **frag}
    rng = np.random.default_rng(12)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    r0 = np.exp(rng.uniform(np.log(36e3), np.log(73e3), 16))
    batches = {"x": jnp.asarray(x), "y": jnp.asarray(np.tanh(x)),
               "r0": jnp.asarray(r0, jnp.float32)}
    res = {}
    for engine in ("scan", "fused_generic"):
        cfg = CircuitTrainConfig(batch_size=64, skip_samples=4, engine=engine)
        res[engine] = jax.value_and_grad(make_loss_fn(ckt, cfg),
                                         has_aux=True)(params, batches)
    (l_s, _), g_s = res["scan"]
    (l_f, _), g_f = res["fused_generic"]
    np.testing.assert_allclose(float(l_f), float(l_s), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_f),
                    jax.tree_util.tree_leaves(g_s)):
        assert float(jnp.max(jnp.abs(a - b))) <= 1e-3 * float(
            jnp.max(jnp.abs(b)) + 1e-30
        )


def test_unknown_training_engine_is_rejected():
    from diffwdf.training.circuit_train import CircuitTrainConfig, make_forward_fn

    ckt, _, _, _ = _case("clipper_approx")
    with pytest.raises(ValueError, match="engine"):
        make_forward_fn(ckt, CircuitTrainConfig(engine="fused"))


@pytest.mark.gpu
def test_kernel_on_gpu_matches_scan(gpu):
    """The compiled Triton kernel on the card vs the float32 scan."""
    ckt, params, node, amp = _case("ts_neural")
    vin = _vin(1, amp, 256, 512)
    with jax.default_matmul_precision("highest"):
        ref, _ = jax.jit(lambda v: _scan_ref(ckt, params, v, node))(vin)
    out, _ = fused_circuit_process(
        ckt, params, vin, _batched_state(ckt, 256), input_node=node,
        interpret=False,
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-4)
