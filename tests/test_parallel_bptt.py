"""Generic differentiable fused engine (ops.parallel_bptt).

Gradcheck target: scan BPTT (jax.grad through ``circuit.process``).  The
forward kernel runs in interpret mode on the CPU; the identical kernel
compiles for the GPU through Triton (``chip_smoke.py`` checks a step there).
"""

import jax
import jax.numpy as jnp
import numpy as np

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_hpf_diode_clipper
from diffwdf.models.tube_screamer import make_tube_screamer
from diffwdf.ops.parallel_bptt import make_fused_circuit_train_generic
from diffwdf.roots.neural import NeuralDiodeRoot

FS = 48000.0
B, T = 1024, 48


def _scan_fwd(ckt, node):
    state0 = ckt.init_state()

    def run(p, v):
        def one(vv):
            o, _ = ckt.process(p, state0, {node: {"v": vv}})
            return o

        return jax.vmap(one)(v)

    return run


def _rel_errs(g1, g2):
    return jax.tree_util.tree_map(
        lambda a, b: float(
            jnp.max(jnp.abs(a - b)) / (jnp.max(jnp.abs(b)) + 1e-12)
        ),
        g1, g2,
    )


def test_ts_gradcheck_vs_scan_bptt():
    """Tube Screamer (R-type stage, 3 reactive states, neural root): the
    parallel backward matches scan BPTT on EVERY parameter — MLP weights AND
    circuit components — plus the input stream."""
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    ts = make_tube_screamer(root, FS)
    params = {**ts.init_params(), **root.init_params()}
    rng = np.random.default_rng(0)
    vin = jnp.asarray((0.5 * rng.standard_normal((B, T))).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))

    f = make_fused_circuit_train_generic(ts, input_node="Vin", interpret=True)
    z0 = [jnp.zeros((B,), jnp.float32) for _ in range(3)]
    scan = _scan_fwd(ts, "Vin")

    out, _ = f(params, vin, z0)
    ref = scan(params, vin)
    assert float(jnp.max(jnp.abs(out - ref))) < 5e-5

    def loss_fused(p, v):
        o, _ = f(p, v, z0)
        return jnp.mean((o - y) ** 2)

    def loss_scan(p, v):
        return jnp.mean((scan(p, v) - y) ** 2)

    g1, gv1 = jax.grad(loss_fused, argnums=(0, 1))(params, vin)
    g2, gv2 = jax.grad(loss_scan, argnums=(0, 1))(params, vin)
    errs = _rel_errs(g1, g2)
    for leaf in jax.tree_util.tree_leaves(errs):
        assert leaf < 5e-4, errs
    # headline parameters to the reference workload: tight
    assert errs["dp"]["layers"][0]["kernel"] < 1e-4, errs["dp"]
    assert float(
        jnp.max(jnp.abs(gv1 - gv2)) / jnp.max(jnp.abs(gv2))
    ) < 1e-4


def test_hpf_analytic_root_gradcheck():
    """HPF topology with the ANALYTIC diode root: cotangents reach the diode
    physics (Is, Vt, nabla) and the load resistor through the implicit-omega
    jvp — no neural root required."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    ckt = make_hpf_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    rng = np.random.default_rng(3)
    vin = jnp.asarray((1.0 * rng.standard_normal((B, T))).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))

    f = make_fused_circuit_train_generic(ckt, input_node="Vs", interpret=True)
    z0 = [jnp.zeros((B,), jnp.float32)]
    scan = _scan_fwd(ckt, "Vs")

    def loss_fused(p):
        o, _ = f(p, vin, z0)
        return jnp.mean((o - y) ** 2)

    def loss_scan(p):
        return jnp.mean((scan(p, vin) - y) ** 2)

    g1 = jax.grad(loss_fused)(params)
    g2 = jax.grad(loss_scan)(params)
    errs = _rel_errs(g1, g2)
    for leaf in jax.tree_util.tree_leaves(errs):
        assert leaf < 1e-3, errs
    # physics grads are real, not zero
    assert float(jnp.max(jnp.abs(g1["dp"]["Is"]))) > 0.0


def test_train_step_fused_generic_reduces_loss():
    """engine='fused_generic' plugs into make_train_step and optimizes the
    Tube Screamer's neural root against analytic-root targets."""
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig, make_train_step,
    )

    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ts_a = make_tube_screamer(aroot, FS)
    pa = {**ts_a.init_params(), **aroot.init_params()}
    rng = np.random.default_rng(5)
    n_seq, t_seq = 8, 64
    x = (0.8 * rng.standard_normal((n_seq, t_seq))).astype(np.float32)
    scan = _scan_fwd(ts_a, "Vin")
    y = np.asarray(scan(pa, jnp.asarray(x)))

    nroot = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ts_n = make_tube_screamer(nroot, FS)
    params = {**ts_n.init_params(), **nroot.init_params()}
    cfg = CircuitTrainConfig(
        epochs=1, batch_size=t_seq, learning_rate=3e-3, skip_samples=4,
        engine="fused_generic",
    )
    opt, train_step, eval_step = make_train_step(ts_n, cfg)
    opt_state = opt.init(params)
    batches = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    m0 = eval_step(params, batches)
    for _ in range(8):
        params, opt_state, m = train_step(params, opt_state, batches)
    assert float(m["loss"]) < float(m0["loss"]), (m0, m)


def _scan_fwd_row(ckt, node, pot_node, pot_field="R"):
    """Per-row pot oracle: vmapped scan with one static R per row (the
    hoisted measured-data semantics, reference clipper_pot.py:113-124)."""
    state0 = ckt.init_state()

    def run(p, v, r):
        def one(vv, rr):
            o, _ = ckt.process(
                p, state0, {node: {"v": vv}},
                static_controls={pot_node: {pot_field: rr}},
            )
            return o

        return jax.vmap(one)(v, r)

    return run


def test_row_pot_hpf_gradcheck_vs_scan():
    """Per-row source R on the HPF clipper (analytic root): the round-5
    lifted restriction — the generic fused engine now trains the
    reference's per-sample re-adaptation semantics (one pot R per data
    row).  Forward and every cotangent match the scan-BPTT oracle."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="best")
    ckt = make_hpf_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    rng = np.random.default_rng(7)
    vin = jnp.asarray((1.0 * rng.standard_normal((B, T))).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))
    r_rows = jnp.asarray(
        np.exp(rng.uniform(np.log(36e3), np.log(73e3), B)).astype(np.float32)
    )  # the reference's measured pot range (dataimport.py:120-137)

    f = make_fused_circuit_train_generic(
        ckt, input_node="Vs", interpret=True, row_fields=(("Vs", "R"),),
    )
    z0 = [jnp.zeros((B,), jnp.float32)]
    scan = _scan_fwd_row(ckt, "Vs", "Vs")

    out, _ = f(params, vin, z0, (r_rows,))
    ref = scan(params, vin, r_rows)
    assert float(jnp.max(jnp.abs(out - ref))) < 5e-5

    def loss_fused(p, v):
        o, _ = f(p, v, z0, (r_rows,))
        return jnp.mean((o - y) ** 2)

    def loss_scan(p, v):
        return jnp.mean((scan(p, v, r_rows) - y) ** 2)

    g1, gv1 = jax.grad(loss_fused, argnums=(0, 1))(params, vin)
    g2, gv2 = jax.grad(loss_scan, argnums=(0, 1))(params, vin)
    errs = _rel_errs(g1, g2)
    for leaf in jax.tree_util.tree_leaves(errs):
        assert leaf < 1e-3, errs
    assert float(
        jnp.max(jnp.abs(gv1 - gv2)) / jnp.max(jnp.abs(gv2))
    ) < 1e-4


def test_row_pot_ts_neural_gradcheck_vs_scan():
    """Per-row DRIVE pot (R6) on the Tube Screamer with a neural root: the
    per-row scatter coefficients and the per-row log-R MLP conditioning
    both stream through the fused forward AND the parallel backward.  MLP
    cotangents (the reference training target) match scan BPTT <= 1e-4."""
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    ts = make_tube_screamer(root, FS)
    params = {**ts.init_params(), **root.init_params()}
    rng = np.random.default_rng(11)
    vin = jnp.asarray((0.5 * rng.standard_normal((B, T))).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))
    # drive pot sweep over [0, 1]: R6 in [51k, 551k] (TubeScreamer.cpp:66)
    from diffwdf.models.tube_screamer import drive_to_r6

    r6_rows = jnp.asarray(
        drive_to_r6(rng.uniform(0.0, 1.0, B)).astype(np.float32)
    )

    f = make_fused_circuit_train_generic(
        ts, input_node="Vin", interpret=True, row_fields=(("R6", "R"),),
    )
    z0 = [jnp.zeros((B,), jnp.float32) for _ in range(3)]
    scan = _scan_fwd_row(ts, "Vin", "R6")

    out, _ = f(params, vin, z0, (r6_rows,))
    ref = scan(params, vin, r6_rows)
    assert float(jnp.max(jnp.abs(out - ref))) < 5e-5

    def loss_fused(p):
        o, _ = f(p, vin, z0, (r6_rows,))
        return jnp.mean((o - y) ** 2)

    def loss_scan(p):
        return jnp.mean((scan(p, vin, r6_rows) - y) ** 2)

    g1 = jax.grad(loss_fused)(params)
    g2 = jax.grad(loss_scan)(params)
    errs = _rel_errs(g1, g2)
    for leaf in jax.tree_util.tree_leaves(errs):
        assert leaf < 5e-4, errs
    assert errs["dp"]["layers"][0]["kernel"] < 1e-4, errs["dp"]


def test_per_sample_pot_gradcheck_vs_scan():
    """PER-SAMPLE pot streams (round 5): a genuinely time-varying R — the
    un-hoistable case the reference runs by re-adapting inside its sample
    loop (``clipper_pot.py:113-124``) — streams (B, T) coefficients through
    the fused forward AND the parallel backward.  Checked on the training clipper with a
    random-walk source R (analytic root, in-scan re-adaptation oracle) and
    on the TS with a per-sample drive pot + NEURAL root (the streamed
    log-R conditioning path)."""
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.models.tube_screamer import drive_to_r6

    rng = np.random.default_rng(19)
    vin = jnp.asarray((1.0 * rng.standard_normal((B, T))).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((B, T)).astype(np.float32))

    cases = []
    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    clip = make_training_clipper(aroot, FS)
    r_walk = np.exp(
        np.log(45e3)
        + np.cumsum(0.02 * rng.standard_normal((B, T)), axis=1)
    ).astype(np.float32)
    cases.append((clip, "Vs", ("Vs", "R"), jnp.asarray(r_walk),
                  {**clip.init_params(), **aroot.init_params()}, 1))
    nroot = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    ts = make_tube_screamer(nroot, FS)
    r6_walk = drive_to_r6(
        np.clip(0.5 + np.cumsum(0.01 * rng.standard_normal((B, T)), axis=1),
                0.0, 1.0)
    ).astype(np.float32)
    cases.append((ts, "Vin", ("R6", "R"), jnp.asarray(r6_walk),
                  {**ts.init_params(), **nroot.init_params()}, 3))

    for ckt, node, rf, r_bt, params, S in cases:
        state0 = ckt.init_state()
        pot_node, pot_field = rf

        def scan_run(p, v, r):
            def one(vv, rr):
                inputs = {node: {"v": vv}}
                inputs.setdefault(pot_node, {})
                inputs[pot_node][pot_field] = rr
                o, _ = ckt.process(p, state0, inputs, adapt_per_sample=True)
                return o

            return jax.vmap(one)(v, r)

        f = make_fused_circuit_train_generic(
            ckt, input_node=node, interpret=True, row_fields=(rf,))
        z0 = [jnp.zeros((B,), jnp.float32) for _ in range(S)]

        out, _ = f(params, vin, z0, (r_bt,))
        ref = scan_run(params, vin, r_bt)
        assert float(jnp.max(jnp.abs(out - ref))) < 5e-5, ckt

        def loss_fused(p):
            o, _ = f(p, vin, z0, (r_bt,))
            return jnp.mean((o - y) ** 2)

        def loss_scan(p):
            return jnp.mean((scan_run(p, vin, r_bt) - y) ** 2)

        g1 = jax.grad(loss_fused)(params)
        g2 = jax.grad(loss_scan)(params)
        errs = _rel_errs(g1, g2)
        for leaf in jax.tree_util.tree_leaves(errs):
            assert leaf < 1e-3, (ckt, errs)
        assert errs["dp"][next(iter(errs["dp"]))] is not None  # tree sanity


def test_joint_fit_with_pot_sweep_data():
    """joint_fit_clipper (components + MLP together) on the fused_generic
    engine with per-row pot data: the combination of the round-4 joint
    physics+neural fit with the round-5 pot streams — every cotangent
    (R, C, MLP) flows through the per-row coefficient tiles."""
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig, joint_fit_clipper,
    )

    rng = np.random.default_rng(31)
    n_seq, t_seq = 8, 64
    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt_a = make_training_clipper(aroot, FS)
    pa = {**ckt_a.init_params(), **aroot.init_params()}
    x = (0.9 * rng.standard_normal((n_seq, t_seq))).astype(np.float32)
    r0 = np.exp(rng.uniform(np.log(36e3), np.log(73e3), n_seq)).astype(
        np.float32
    )
    scan = _scan_fwd_row(ckt_a, "Vs", "Vs")
    y = np.asarray(scan(pa, jnp.asarray(x), jnp.asarray(r0)))

    nroot = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt_n = make_training_clipper(nroot, FS)
    params = {**ckt_n.init_params(), **nroot.init_params()}
    # perturb C; the joint fit must pull it back while training the MLP
    params["C"]["C"] = jnp.asarray(6.5e-9, jnp.float32)
    batches = {
        "x": jnp.asarray(x), "y": jnp.asarray(y), "r0": jnp.asarray(r0),
    }
    cfg = CircuitTrainConfig(
        epochs=12, batch_size=t_seq, skip_samples=4, engine="fused_generic",
    )
    p2, hist = joint_fit_clipper(
        ckt_n, params, batches, component_lrs={"C.C": 2e-10},
        cfg=cfg, mlp_lr=3e-3,
    )
    assert hist["loss"][-1] < hist["loss"][0]
    # C moved toward the true 4.7n from the 6.5n perturbation
    assert abs(float(p2["C"]["C"]) - 4.7e-9) < abs(6.5e-9 - 4.7e-9)


def test_train_step_fused_generic_accepts_r0_batches():
    """engine='fused_generic' + hoisted per-row 'r0' batches — the exact
    measured-data workload the round-4 engine rejected — trains the HPF's
    neural root end to end and reduces the loss."""
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig, make_train_step,
    )

    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    hpf_a = make_hpf_diode_clipper(aroot, FS)
    pa = {**hpf_a.init_params(), **aroot.init_params()}
    rng = np.random.default_rng(17)
    n_seq, t_seq = 8, 64
    x = (1.0 * rng.standard_normal((n_seq, t_seq))).astype(np.float32)
    r0 = np.exp(rng.uniform(np.log(36e3), np.log(73e3), n_seq)).astype(
        np.float32
    )
    scan = _scan_fwd_row(hpf_a, "Vs", "Vs")
    y = np.asarray(scan(pa, jnp.asarray(x), jnp.asarray(r0)))

    nroot = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    hpf_n = make_hpf_diode_clipper(nroot, FS)
    params = {**hpf_n.init_params(), **nroot.init_params()}
    cfg = CircuitTrainConfig(
        epochs=1, batch_size=t_seq, learning_rate=3e-3, skip_samples=4,
        engine="fused_generic",
    )
    opt, train_step, eval_step = make_train_step(hpf_n, cfg)
    opt_state = opt.init(params)
    batches = {
        "x": jnp.asarray(x), "y": jnp.asarray(y), "r0": jnp.asarray(r0),
    }
    m0 = eval_step(params, batches)
    for _ in range(8):
        params, opt_state, m = train_step(params, opt_state, batches)
    assert float(m["loss"]) < float(m0["loss"]), (m0, m)


def test_mixed_r_chunks_train_on_fused_generic():
    """The real measured-data edge case that motivated per-sample streams:
    a chunk straddling a FILE BOUNDARY carries two R values, so it cannot
    hoist ("r" stays (B, T) in make_clipper_batches).  Round 4 dropped such
    chunks on the fused path (drop_mixed_r); the fused_generic engine now
    trains them directly, matching the scan engine's loss trajectory."""
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig,
        make_clipper_batches,
        train_clipper,
    )

    rng = np.random.default_rng(37)
    T_chunk, n = 128, 6
    total = n * T_chunk
    x = (0.8 * rng.standard_normal(total)).astype(np.float32)
    # two "files": R jumps mid-stream, NOT on a chunk boundary
    r = np.full(total, 45e3, np.float32)
    r[total // 2 + T_chunk // 2 :] = 62e3
    y = np.tanh(x).astype(np.float32)
    batches = make_clipper_batches(
        {"x": x, "r": r, "y": y}, T_chunk
    )
    assert "r" in batches and batches["r"].shape == (n, T_chunk)  # mixed

    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt = make_training_clipper(root, FS)
    params0 = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(2))}

    hists = {}
    for engine in ("scan", "fused_generic"):
        cfg = CircuitTrainConfig(
            epochs=4, batch_size=T_chunk, learning_rate=3e-3,
            skip_samples=8, engine=engine,
        )
        _, hist = train_clipper(ckt, dict(params0), batches, cfg=cfg)
        hists[engine] = hist["loss"]
    np.testing.assert_allclose(
        hists["fused_generic"], hists["scan"], rtol=5e-4
    )
