"""Parallel-in-time (DEER) solving of any circuit (ops.parallel_time):
multi-state S x S affine composition, jacfwd-derived Jacobians, and the
``engine="deer"`` serving processors built on it."""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import (
    make_diode_clipper,
    make_hpf_diode_clipper,
)
from diffwdf.models.tube_screamer import make_tube_screamer
from diffwdf.ops.parallel_time import parallel_time_process

FS = 96000.0


def deer_solve(ckt, params, vin, *, input_node, sweeps=12,
                       damping=1.0, static_controls=None, state0=None):
    """(outputs, final state, residual) of the plain DEER solve."""
    return parallel_time_process(
        ckt, params, {input_node: {"v": vin}}, n_iters=sweeps,
        damping=damping, static_controls=static_controls, state0=state0,
        return_state=True, return_residual=True,
    )


def test_tube_screamer_three_state():
    """The showcase: 4-port R-type op-amp stage, S=3 reactive states —
    the whole Newton-over-trajectory solve matches the sequential scan."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    ts = make_tube_screamer(root, FS, drive=0.5)
    params = {**ts.init_params(), **root.init_params()}
    rng = np.random.default_rng(2)
    vin = jnp.asarray((0.5 * rng.standard_normal(2048)).astype(np.float32))
    ref, ref_st = ts.process(params, ts.init_state(), {"Vin": {"v": vin}})
    out, st, res = deer_solve(ts, params, vin, input_node="Vin")
    assert float(jnp.max(jnp.abs(out - ref))) < 1e-4, "TS output parity"
    # final state pytree matches too
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(ref_st)):
        np.testing.assert_allclose(float(a), float(b), atol=1e-4)


def test_clipper_matches_dedicated_kernel_math():
    """S=1 sanity: the solve reproduces the sequential clipper."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    ckt = make_diode_clipper(root, FS, 47e3, 2.2e-9)
    params = {**ckt.init_params(), **root.init_params()}
    rng = np.random.default_rng(4)
    vin = jnp.asarray((2.0 * rng.standard_normal(1024)).astype(np.float32))
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": vin}})
    out, _, _ = deer_solve(ckt, params, vin, input_node="Vs")
    assert float(jnp.max(jnp.abs(out - ref))) < 1e-6


def test_hpf_needs_damping():
    """The HPF's series capacitor is a marginal slow mode (|df/dz| -> 1):
    full Newton oscillates (as does the XLA DEER path), damping=0.5
    converges to the f32 limit of the mode (~1e-4)."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    hpf = make_hpf_diode_clipper(root, FS)
    params = {**hpf.init_params(), **root.init_params()}
    rng = np.random.default_rng(2)
    vin = jnp.asarray((2.0 * rng.standard_normal(2048)).astype(np.float32))
    ref, _ = hpf.process(params, hpf.init_state(), {"Vs": {"v": vin}})
    bad, _, _ = deer_solve(hpf, params, vin, input_node="Vs",
                                sweeps=8)
    good, _, _ = deer_solve(hpf, params, vin, input_node="Vs",
                                 sweeps=24, damping=0.5)
    err_bad = float(jnp.max(jnp.abs(bad - ref)))
    err_good = float(jnp.max(jnp.abs(good - ref)))
    assert err_good < 3e-4, err_good
    assert err_good < err_bad / 100


def test_xla_deer_damping_matches():
    """The damping knob on the XLA path fixes the same HPF oscillation."""
    from diffwdf.ops.parallel_time import parallel_time_process

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    hpf = make_hpf_diode_clipper(root, FS)
    params = {**hpf.init_params(), **root.init_params()}
    rng = np.random.default_rng(2)
    vin = jnp.asarray((2.0 * rng.standard_normal(1024)).astype(np.float32))
    ref, _ = hpf.process(params, hpf.init_state(), {"Vs": {"v": vin}})
    out, resid = parallel_time_process(
        hpf, params, {"Vs": {"v": vin}}, n_iters=30, damping=0.5,
        return_residual=True,
    )
    assert float(resid) < 1e-3, float(resid)
    assert float(jnp.max(jnp.abs(out - ref))) < 3e-4


def test_static_controls_drive_pot():
    """Block-rate impedance controls (the TS drive pot) enter through
    static_controls, same contract as the fused forward kernel"""
    from diffwdf.models.tube_screamer import drive_to_r6

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ts = make_tube_screamer(root, FS, drive=0.2)
    params = {**ts.init_params(), **root.init_params()}
    rng = np.random.default_rng(6)
    vin = jnp.asarray((0.3 * rng.standard_normal(1024)).astype(np.float32))
    ctl = {"R6": {"R": drive_to_r6(0.9)}}
    ref, _ = ts.process(params, ts.init_state(), {"Vin": {"v": vin}},
                        static_controls=ctl)
    out, _, _ = deer_solve(ts, params, vin, input_node="Vin",
                                static_controls=ctl)
    assert float(jnp.max(jnp.abs(out - ref))) < 1e-4


def test_plugin_processor_deer_engine():
    """make_plugin_processor(engine='deer'): clipper AND tube screamer serve
    through the parallel-in-time solver, matching the scan engine
    block-for-block (incl. the drive-pot static control)."""
    from diffwdf.runtime.stream import make_plugin_processor

    fs = 48000.0
    rng = np.random.default_rng(9)
    x = (0.8 * rng.standard_normal(2048)).astype(np.float32)
    p_scan = make_plugin_processor(fs)
    p_deer = make_plugin_processor(fs, engine="deer")
    for circuit, knobs in (
        ("clipper", {"cutoff_hz": 3000.0}),
        ("tube_screamer", {"drive": 0.7}),
    ):
        a = p_scan.process_block(x, circuit, gain_db=3.0, **knobs)
        b = p_deer.process_block(x, circuit, gain_db=3.0, **knobs)
        np.testing.assert_allclose(a, b, atol=2e-4, err_msg=circuit)


def test_plugin_processor_deer_zoo1_quality_parity():
    """Zoo entry 1 ('approx', 1-iter omega) through the plugin's deer
    engine must match the scan engine — the solver must inherit the
    root's omega quality, not the default 3 iterations."""
    from diffwdf.runtime.stream import make_plugin_processor

    fs = 48000.0
    rng = np.random.default_rng(17)
    x = (1.5 * rng.standard_normal(2048)).astype(np.float32)
    a = make_plugin_processor(fs, clipper_zoo=1).process_block(x, "clipper")
    b = make_plugin_processor(fs, clipper_zoo=1, engine="deer").process_block(
        x, "clipper")
    np.testing.assert_allclose(a, b, atol=5e-6)


def test_clipper_processor_approx_quality_parity():
    """engine='deer' must not change the model: the 'approx' circuit's
    1-iteration omega quality carries into the solver."""
    from diffwdf.runtime.stream import make_clipper_processor

    fs = 48000.0
    rng = np.random.default_rng(13)
    x = (1.5 * rng.standard_normal(2048)).astype(np.float32)
    a = make_clipper_processor(fs, models=("approx",)).process_block(x, "approx")
    b = make_clipper_processor(fs, models=("approx",), engine="deer"
                               ).process_block(x, "approx")
    np.testing.assert_allclose(a, b, atol=5e-6)


def test_hpf_processor_deer_engine():
    """engine='deer' on the HPF processor: damped generic fused solver,
    block-parity with the scan engine across carried state."""
    from diffwdf.runtime.stream import make_hpf_processor

    fs = 48000.0
    rng = np.random.default_rng(14)
    x = (1.0 * rng.standard_normal(4096)).astype(np.float32)
    p_scan = make_hpf_processor(fs)
    p_deer = make_hpf_processor(fs, engine="deer")
    for blk in (0, 1):
        a = p_scan.process_block(x[blk * 2048:(blk + 1) * 2048], "toms")
        b = p_deer.process_block(x[blk * 2048:(blk + 1) * 2048], "toms")
        np.testing.assert_allclose(a, b, atol=5e-4)


def test_implicit_variant_damping():
    """The implicit-VJP solver accepts the same damping knob (HPF gradient
    workloads need it for the same marginal-mode reason)."""
    from diffwdf.ops.parallel_time import parallel_time_process_implicit

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    hpf = make_hpf_diode_clipper(root, FS)
    params = {**hpf.init_params(), **root.init_params()}
    rng = np.random.default_rng(2)
    vin = jnp.asarray((2.0 * rng.standard_normal(1024)).astype(np.float32))
    ref, _ = hpf.process(params, hpf.init_state(), {"Vs": {"v": vin}})
    out = parallel_time_process_implicit(
        hpf, params, {"Vs": {"v": vin}}, n_iters=30, damping=0.5
    )
    assert float(jnp.max(jnp.abs(out - ref))) < 3e-4


def test_parity_gap_is_the_f32_floor():
    """The fused solver's deviation from the f32 scan is NOT a solver
    deficiency: against an f64 oracle (params/state/input cast to float64
    under jax.enable_x64; the TS built with static_s=False so the R-type
    scattering matrix is derived in f64 too), the fused-DEER f32 output is
    as accurate as the sequential f32 scan itself.  The deer-vs-scan gap is
    two equally-valid f32 round-off floors diverging."""
    import jax

    def to64(t):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), t
        )

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")

    # --- clipper (S=1) ---
    ckt = make_diode_clipper(root, FS, 47e3, 2.2e-9)
    params = {**ckt.init_params(), **root.init_params()}
    rng = np.random.default_rng(4)
    vin64 = 2.0 * rng.standard_normal(2048)
    vin32 = jnp.asarray(vin64.astype(np.float32))
    scan32, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": vin32}})
    deer32, _, _ = deer_solve(ckt, params, vin32, input_node="Vs")
    with jax.enable_x64():
        oracle, _ = ckt.process(to64(params), to64(ckt.init_state()),
                                {"Vs": {"v": jnp.asarray(vin64)}})
        assert oracle.dtype == jnp.float64
    o = np.asarray(oracle)
    e_scan = np.max(np.abs(np.asarray(scan32, np.float64) - o))
    e_deer = np.max(np.abs(np.asarray(deer32, np.float64) - o))
    assert e_scan < 1e-6, e_scan  # both at the f32 floor ...
    assert e_deer < 1e-6, e_deer
    assert e_deer < 3.0 * e_scan, (e_deer, e_scan)  # ... and comparable

    # --- tube screamer (S=3, R-type adaptor) ---
    ts32 = make_tube_screamer(root, FS, drive=0.5)
    ts64 = make_tube_screamer(root, FS, drive=0.5, static_s=False)
    p32 = {**ts32.init_params(), **root.init_params()}
    p64 = {**ts64.init_params(), **root.init_params()}
    rng = np.random.default_rng(2)
    v64 = 0.5 * rng.standard_normal(2048)
    v32 = jnp.asarray(v64.astype(np.float32))
    scan32, _ = ts32.process(p32, ts32.init_state(), {"Vin": {"v": v32}})
    deer32, _, _ = deer_solve(ts32, p32, v32, input_node="Vin")
    with jax.enable_x64():
        oracle, _ = ts64.process(to64(p64), to64(ts64.init_state()),
                                 {"Vin": {"v": jnp.asarray(v64)}})
        assert oracle.dtype == jnp.float64
    o = np.asarray(oracle)
    e_scan = np.max(np.abs(np.asarray(scan32, np.float64) - o))
    e_deer = np.max(np.abs(np.asarray(deer32, np.float64) - o))
    # the 3-state recursion's own f32 floor is ~2e-5 at T=2048; the fused
    # solver sits at the same floor (measured 1.61e-5 vs the scan's 1.71e-5)
    assert e_scan < 1e-4, e_scan
    assert e_deer < 2.0 * e_scan, (e_deer, e_scan)


def test_fused_deer_neural_matches_scan():
    """Neural-root parallel-in-time (round-2 VERDICT #3): the generic fused
    DEER solve (Jacobians through the MLP) matches the sequential
    scan on the pretrained 2x16 clipper (the reference's headline real-time
    engine, ``DiodePairNeuralModel.h:68-73``)."""
    from diffwdf.models.diode_clipper import (
        make_diode_clipper, make_root_from_zoo,
    )
    
    fs = 48000.0
    root, frag = make_root_from_zoo(4)  # 2x16, pretrained weights
    ckt = make_diode_clipper(root, fs)
    params = {**ckt.init_params(), **frag}
    rng = np.random.default_rng(7)
    x = jnp.asarray((2.0 * rng.standard_normal(2048)).astype(np.float32))
    ref, ref_state = ckt.process(params, ckt.init_state(), {"Vs": {"v": x}})
    out, stf, res = deer_solve(
        ckt, params, x, input_node="Vs", state0=ckt.init_state(),
    )
    assert float(jnp.max(jnp.abs(out - ref))) < 5e-6
    assert float(res) < 1e-5
    np.testing.assert_allclose(
        float(stf["C"]["z"]), float(ref_state["C"]["z"]), atol=5e-6
    )


def test_fused_deer_neural_multi_diode_and_sizes():
    """The whole NxH family solves: a 4x8 net and a multi-diode 2x16."""
    from diffwdf.models.diode_clipper import (
        make_diode_clipper, make_root_from_zoo,
    )
    
    fs = 48000.0
    rng = np.random.default_rng(9)
    x = jnp.asarray((1.5 * rng.standard_normal(1024)).astype(np.float32))
    for zoo_idx in (6, 10):  # 4x8 1U-1D, 2x16 2U-3D
        root, frag = make_root_from_zoo(zoo_idx)
        ckt = make_diode_clipper(root, fs)
        params = {**ckt.init_params(), **frag}
        ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": x}})
        out, _, res = deer_solve(
            ckt, params, x, input_node="Vs", state0=ckt.init_state(),
        )
        assert float(jnp.max(jnp.abs(out - ref))) < 5e-6, zoo_idx
        assert float(res) < 1e-5, zoo_idx


def test_neural_deer_serving_engine_parity():
    """make_clipper_processor(engine='deer') serves the NEURAL clipper
    through the fused parallel-in-time solver with scan-engine parity
    (gain ramp, cutoff map, DC blocker, carried state identical)."""
    from diffwdf.runtime.stream import make_clipper_processor

    fs = 48000.0
    rng = np.random.default_rng(13)
    x = (1.5 * rng.standard_normal(4096)).astype(np.float32)
    p_scan = make_clipper_processor(fs, models=("neural_2x16",))
    p_deer = make_clipper_processor(fs, models=("neural_2x16",),
                                    engine="deer")
    for blk in (0, 1):
        a = p_scan.process_block(x[blk * 2048:(blk + 1) * 2048],
                                 "neural_2x16", gain_db=6.0,
                                 cutoff_hz=3000.0)
        b = p_deer.process_block(x[blk * 2048:(blk + 1) * 2048],
                                 "neural_2x16", gain_db=6.0,
                                 cutoff_hz=3000.0)
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert p_deer.fallbacks.get("neural_2x16", 0) == 0
    assert 0.0 <= p_deer.last_residual["neural_2x16"] < 1e-4


def test_hpf_neural_deer_serving_parity():
    """make_hpf_processor(engine='deer') now serves the NEURAL HPF roots
    (extrapolated/trained) through the damped generic solver too, with
    scan-engine parity — every member of the HPF group gets the
    parallel-in-time path."""
    from diffwdf.runtime.stream import make_hpf_processor

    fs = 48000.0
    rng = np.random.default_rng(17)
    x = (1.0 * rng.standard_normal(2048)).astype(np.float32)
    p_scan = make_hpf_processor(fs)
    p_deer = make_hpf_processor(fs, engine="deer")
    for name in ("extrapolated", "trained"):
        a = p_scan.process_block(x, name, cutoff_hz=3000.0)
        b = p_deer.process_block(x, name, cutoff_hz=3000.0)
        # marginal series-cap mode: damped solver reaches ~1e-4 (see
        # ops.parallel_time); fallback handles flagged blocks
        np.testing.assert_allclose(a, b, atol=5e-4)
        assert np.all(np.isfinite(b))
