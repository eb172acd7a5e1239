"""Multi-device tests on the virtual 8-device CPU mesh.

These validate the sharding/collective design the driver separately dry-runs
(time-block handoff, DP gradient reduction, sharded sweeps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.parallel.mesh import make_mesh, shard_batches
from diffwdf.parallel.sweep import (
    ensemble_process,
    stack_mlp_params,
    sweep_process,
)
from diffwdf.parallel.time_block import (
    time_block_process,
    time_block_process_exact,
    warmup_for_tolerance,
)
from diffwdf.roots.neural import NeuralDiodeRoot, mlp_arch, mlp_init

FS = 48000.0


def _clipper():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    return ckt, params


def test_time_block_overlap_matches_serial(devices8):
    ckt, params = _clipper()
    mesh = make_mesh((1, 8), ("data", "time"))
    T = 8 * 512
    n = np.arange(T)
    vin = jnp.asarray(
        (2.0 * np.sin(2 * np.pi * 330.0 * n / FS)).astype(np.float32)
    )
    inputs = {"Vs": {"v": vin}}

    serial, _ = ckt.process(params, ckt.init_state(), inputs)
    warm = warmup_for_tolerance(787.0, FS, tol=1e-6)  # clipper corner ~787 Hz
    assert warm <= 512
    par = time_block_process(ckt, params, inputs, mesh, warmup=warm)
    err = np.max(np.abs(np.asarray(par) - np.asarray(serial)))
    assert err < 1e-5, err


def test_time_block_exact_matches_serial(devices8):
    ckt, params = _clipper()
    mesh = make_mesh((1, 8), ("data", "time"))
    T = 8 * 128
    rng = np.random.default_rng(0)
    vin = jnp.asarray((1.5 * rng.standard_normal(T)).astype(np.float32))
    inputs = {"Vs": {"v": vin}}
    serial, _ = ckt.process(params, ckt.init_state(), inputs)
    exact = time_block_process_exact(ckt, params, inputs, mesh)
    np.testing.assert_allclose(
        np.asarray(exact), np.asarray(serial), atol=1e-6
    )


def test_warmup_error_decays_with_window(devices8):
    """Quantifies the overlap-save error vs warm-up length — the measurement
    justifying block-parallel decode (SURVEY.md hard-parts list)."""
    ckt, params = _clipper()
    mesh = make_mesh((1, 8), ("data", "time"))
    T = 8 * 256
    rng = np.random.default_rng(1)
    vin = jnp.asarray((2.0 * rng.standard_normal(T)).astype(np.float32))
    inputs = {"Vs": {"v": vin}}
    serial, _ = ckt.process(params, ckt.init_state(), inputs)
    errs = []
    for w in (8, 32, 128):
        par = time_block_process(ckt, params, inputs, mesh, warmup=w)
        errs.append(float(np.max(np.abs(np.asarray(par) - np.asarray(serial)))))
    assert errs[2] < errs[0]
    assert errs[2] < 1e-4, errs


def test_dp_training_matches_single_device(devices8):
    """Gradient psum over the data axis == single-device step (same math)."""
    from diffwdf.data.synthetic import synth_clipper_measurement
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.parallel.data_parallel import make_dp_train_step
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig,
        make_clipper_batches,
        make_train_step,
    )

    fs = 8000.0
    diode = dwdf.diode_1n4148_1u1d
    vin, vout = synth_clipper_measurement(diode, 45e3, fs=fs, duration_s=0.5)
    data = {"x": vin, "r": np.full_like(vin, 45e3), "y": vout}

    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt = make_training_clipper(root, fs)
    params0 = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(0))}
    cfg = CircuitTrainConfig(epochs=2, batch_size=128, max_chunks=8)
    batches = make_clipper_batches(data, cfg.batch_size, cfg.max_chunks)

    # single device
    opt, step, _ = make_train_step(ckt, cfg)
    s = opt.init(params0)
    p1, s, m1 = step(params0, s, batches)

    # 8-way DP
    mesh = make_mesh((8, 1), ("data", "time"))
    opt2, dp_step, _, prepare = make_dp_train_step(ckt, cfg, mesh)
    s2 = opt2.init(params0)
    p2, s2, bsh = prepare(params0, s2, batches)
    p2, s2, m2 = dp_step(p2, s2, bsh)

    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    l1 = jax.tree_util.tree_leaves(p1)
    l2 = jax.tree_util.tree_leaves(p2)
    for a, b in zip(l1, l2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_dp_fused_engines_match_single_device(devices8):
    """The fused_generic training step composes with DP on the training
    clipper and the HPF.  Each device runs the fused kernel on its LOCAL
    batch under shard_map (plain jit would make the partitioner all-gather
    the Pallas custom call), the exact global MSE+ESR is reassembled from
    psum-reduced sums, and gradients psum — matching the single-device
    step's math."""
    from diffwdf.models.diode_clipper import (
        make_hpf_diode_clipper,
        make_training_clipper,
    )
    from diffwdf.parallel.data_parallel import make_dp_train_step
    from diffwdf.training.circuit_train import (
        CircuitTrainConfig,
        make_train_step,
    )

    rng = np.random.default_rng(23)
    n_seq, T = 16, 48
    r0 = np.exp(rng.uniform(np.log(36e3), np.log(73e3), n_seq)).astype(
        np.float32
    )

    froot = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt_f = make_training_clipper(froot, FS)
    groot = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt_g = make_hpf_diode_clipper(groot, FS)

    def only_root(grads):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
        zeros["dp"] = grads["dp"]
        return zeros

    mesh = make_mesh((8, 1), ("data", "time"))
    for engine, ckt, root in (("fused_generic", ckt_f, froot),
                              ("fused_generic", ckt_g, groot)):
        params0 = {
            **ckt.init_params(),
            **root.init_params(jax.random.PRNGKey(1)),
        }
        batches = {
            "x": jnp.asarray(
                rng.standard_normal((n_seq, T)).astype(np.float32)
            ),
            "y": jnp.asarray(
                np.tanh(rng.standard_normal((n_seq, T))).astype(np.float32)
            ),
            "r0": jnp.asarray(r0),
        }
        cfg = CircuitTrainConfig(
            epochs=2, batch_size=T, learning_rate=3e-3, skip_samples=8,
            engine=engine,
        )
        # the training clipper trains its root only (the reference's
        # policy): an Adam step of 3e-3 on C = 4.7 nF would wreck the circuit
        filt = only_root if ckt is ckt_f else None
        opt, step, _ = make_train_step(ckt, cfg, filt)
        s = opt.init(params0)
        p1, s, m1 = step(params0, s, batches)

        opt2, dp_step, dp_eval, prepare = make_dp_train_step(ckt, cfg, mesh,
                                                             filt)
        s2 = opt2.init(params0)
        p2, s2, bsh = prepare(params0, s2, batches)

        # raw psummed gradient vs single-device gradient (Adam's update is
        # scale-invariant, so the params check below alone would not catch
        # a collective double count)
        from diffwdf.training.circuit_train import make_loss_fn

        _, _, g_dp = dp_step.grads_fn(p2, bsh)
        (_, _), g_1 = jax.value_and_grad(
            make_loss_fn(ckt, cfg), has_aux=True
        )(params0, batches)
        g_1 = filt(g_1) if filt else g_1
        for a, b in zip(
            jax.tree_util.tree_leaves(g_dp), jax.tree_util.tree_leaves(g_1)
        ):
            denom = float(jnp.max(jnp.abs(b))) + 1e-12
            assert (
                float(jnp.max(jnp.abs(a - b))) / denom < 1e-4
            ), engine

        p2, s2, m2 = dp_step(p2, s2, bsh)

        np.testing.assert_allclose(
            float(m1["loss"]), float(m2["loss"]), rtol=1e-5, err_msg=engine
        )
        for a, b in zip(
            jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p2)
        ):
            # 5e-6: psum reduction order differs from the single-device sum
            # and Adam's m/sqrt(v) rescaling amplifies the f32 noise on the
            # first step (loss itself agrees to rtol 1e-5 above)
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=5e-6, err_msg=engine
            )
        ev = dp_eval(p2, bsh)
        assert np.isfinite(float(ev["loss"]))


def test_time_block_training_matches_long_scan(devices8):
    """Overlap-save BPTT (VERDICT r4 weak #3): one long sequence's chunks
    sharded over the mesh time axis, warm-up excluded from the loss, grads
    psummed.  The psummed gradient matches the single-device FULL-LENGTH
    scan BPTT gradient within the overlap truncation budget, and the step
    reduces the loss."""
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.parallel.time_block import make_time_block_train_step
    from diffwdf.training.circuit_train import CircuitTrainConfig

    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt = make_training_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(2))}
    T = 8 * 512
    rng = np.random.default_rng(31)
    x = jnp.asarray((0.8 * rng.standard_normal(T)).astype(np.float32))
    y = jnp.asarray(np.tanh(0.8 * np.asarray(x)).astype(np.float32))
    # training clipper slowest pole: RC corner of 45k x 4.7n; W from the
    # 1e-6 state-error budget (well under the 512-sample block)
    fc = 1.0 / (2 * np.pi * 45e3 * 4.7e-9)
    W = warmup_for_tolerance(fc, FS, 1e-6)
    assert W < 512, W

    mesh = make_mesh((1, 8), ("data", "time"))
    cfg = CircuitTrainConfig(learning_rate=3e-3, skip_samples=50)

    opt, step, eval_step = make_time_block_train_step(
        ckt, cfg, mesh, warmup=W
    )

    # single-device oracle: the same masked global loss on one full scan
    eps = np.float32(np.finfo(np.float32).eps)
    state0 = ckt.init_state()

    def oracle_loss(p):
        out, _ = ckt.process(p, state0, {"Vs": {"v": x}})
        o, t = out[cfg.skip_samples:], y[cfg.skip_samples:]
        se = jnp.sum(jnp.square(o - t))
        te = jnp.sum(jnp.square(t))
        n = jnp.asarray(t.size, jnp.float32)
        return se / n + jnp.sqrt(se / (te + eps) / n)

    l_ref, g_ref = jax.value_and_grad(oracle_loss)(params)
    l_tb, _, g_tb = step.grads_fn(params, x, y)
    np.testing.assert_allclose(float(l_tb), float(l_ref), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_tb), jax.tree_util.tree_leaves(g_ref)
    ):
        denom = float(jnp.max(jnp.abs(b))) + 1e-12
        assert float(jnp.max(jnp.abs(a - b))) / denom < 1e-3

    # pre-emphasis: the one-zero filter must not restart at shard
    # boundaries (each boundary sample is emphasized with the true
    # neighbor sample, fetched via the overlap / one extra ppermute)
    cfg_e = CircuitTrainConfig(
        learning_rate=3e-3, skip_samples=50, use_pre_emphasis=True
    )
    _, step_e, _ = make_time_block_train_step(ckt, cfg_e, mesh, warmup=W)

    def oracle_loss_emph(p):
        from diffwdf.training.losses import pre_emphasis

        out, _ = ckt.process(p, state0, {"Vs": {"v": x}})
        o = pre_emphasis(out, axis=0)[cfg_e.skip_samples:]
        t = pre_emphasis(y, axis=0)[cfg_e.skip_samples:]
        se = jnp.sum(jnp.square(o - t))
        te = jnp.sum(jnp.square(t))
        n = jnp.asarray(t.size, jnp.float32)
        return se / n + jnp.sqrt(se / (te + eps) / n)

    le_ref, ge_ref = jax.value_and_grad(oracle_loss_emph)(params)
    le_tb, _, ge_tb = step_e.grads_fn(params, x, y)
    np.testing.assert_allclose(float(le_tb), float(le_ref), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(ge_tb), jax.tree_util.tree_leaves(ge_ref)
    ):
        denom = float(jnp.max(jnp.abs(b))) + 1e-12
        assert float(jnp.max(jnp.abs(a - b))) / denom < 1e-3

    # and the step optimizes (NN-only updates, the reference's in-circuit
    # training policy — component grads are huge relative to C=4.7e-9 and
    # Adam's unit-scale steps would wreck the physics)
    def only_root(grads):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
        zeros["dp"] = grads["dp"]
        return zeros

    opt2, step2, _ = make_time_block_train_step(
        ckt, cfg, mesh, warmup=W, trainable_filter=only_root
    )
    s = opt2.init(params)
    m0 = eval_step(params, x, y)
    p = params
    for _ in range(5):
        p, s, m = step2(p, s, x, y)
    assert float(m["loss"]) < float(m0["loss"])


def test_time_block_training_2axis_dp_x_time(devices8):
    """2-axis composition: [n_seq, T] sequences with rows sharded over the
    DATA axis and each row's chunks overlap-save-sharded over the TIME
    axis — one training step over a (4, 2) mesh.  The psummed gradient
    matches the single-device all-rows full-length BPTT gradient within
    the overlap budget."""
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.parallel.time_block import make_time_block_train_step
    from diffwdf.training.circuit_train import CircuitTrainConfig

    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt = make_training_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(3))}
    n_seq, T = 4, 2 * 1024
    rng = np.random.default_rng(41)
    x = jnp.asarray((0.8 * rng.standard_normal((n_seq, T))).astype(np.float32))
    y = jnp.tanh(0.8 * x)
    fc = 1.0 / (2 * np.pi * 45e3 * 4.7e-9)
    W = warmup_for_tolerance(fc, FS, 1e-6)

    mesh = make_mesh((4, 2), ("data", "time"))
    cfg = CircuitTrainConfig(learning_rate=1e-3, skip_samples=50)
    opt, step, eval_step = make_time_block_train_step(
        ckt, cfg, mesh, warmup=W
    )

    eps = np.float32(np.finfo(np.float32).eps)
    state0 = ckt.init_state()

    def oracle_loss(p):
        def one(v):
            out, _ = ckt.process(p, state0, {"Vs": {"v": v}})
            return out

        o = jax.vmap(one)(x)[:, cfg.skip_samples:]
        t = y[:, cfg.skip_samples:]
        se = jnp.sum(jnp.square(o - t))
        te = jnp.sum(jnp.square(t))
        n = jnp.asarray(t.size, jnp.float32)
        return se / n + jnp.sqrt(se / (te + eps) / n)

    l_ref, g_ref = jax.value_and_grad(oracle_loss)(params)
    l_tb, _, g_tb = step.grads_fn(params, x, y)
    np.testing.assert_allclose(float(l_tb), float(l_ref), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_tb), jax.tree_util.tree_leaves(g_ref)
    ):
        denom = float(jnp.max(jnp.abs(b))) + 1e-12
        assert float(jnp.max(jnp.abs(a - b))) / denom < 1e-3


def test_sweep_1024_instances(devices8):
    """BASELINE config 4: vmap sweep over circuit instances, sharded."""
    ckt, params = _clipper()
    mesh = make_mesh((8, 1), ("data", "time"))
    N, T = 64, 128
    r_values = np.linspace(1e3, 100e3, N).astype(np.float32)
    n = np.arange(T)
    vin = jnp.asarray((2.0 * np.sin(2 * np.pi * 440.0 * n / FS)).astype(np.float32))
    outs = sweep_process(
        ckt, params, {"Vs.R": jnp.asarray(r_values)}, {"Vs": {"v": vin}}, mesh=mesh
    )
    assert outs.shape == (N, T)
    assert np.all(np.isfinite(np.asarray(outs)))
    # more source resistance -> stronger lowpass -> less output energy
    e = np.mean(np.asarray(outs[:, 32:]) ** 2, axis=1)
    assert e[0] > e[-1]


def test_ensemble_over_model_zoo(devices8):
    """EP-style ensemble: one clipper per stacked MLP root."""
    sizes, acts = mlp_arch(1, 4)
    mlps = [mlp_init(jax.random.PRNGKey(i), sizes) for i in range(4)]
    stack = stack_mlp_params(mlps)
    T = 64
    vin = jnp.asarray(np.random.default_rng(0).normal(size=T).astype(np.float32))
    outs = ensemble_process(
        lambda root: make_diode_clipper(root, FS),
        stack,
        acts,
        {"Vs": {"v": vin}},
    )
    assert outs.shape == (4, T)
    # different weights -> different outputs
    assert float(jnp.max(jnp.abs(outs[0] - outs[1]))) > 1e-6


def test_ensemble_sharded_over_mesh(devices8):
    """ensemble_process with a mesh shards the expert axis (it previously
    ignored the mesh argument); numbers match the unsharded run."""
    sizes, acts = mlp_arch(1, 4)
    mlps = [mlp_init(jax.random.PRNGKey(i), sizes) for i in range(8)]
    stack = stack_mlp_params(mlps)
    T = 64
    vin = jnp.asarray(np.random.default_rng(0).normal(size=T).astype(np.float32))
    factory = lambda root: make_diode_clipper(root, FS)
    ref = ensemble_process(factory, stack, acts, {"Vs": {"v": vin}})
    mesh = make_mesh((8, 1), ("data", "time"))
    outs = ensemble_process(factory, stack, acts, {"Vs": {"v": vin}}, mesh=mesh)
    assert outs.shape == (8, T)
    np.testing.assert_allclose(np.asarray(outs), np.asarray(ref), atol=1e-6)


def test_scaling_harness(devices8):
    """Weak-scaling measurement machinery on the virtual mesh (numbers are
    not meaningful on CPU; the harness behavior is what's under test)."""
    import jax.numpy as jnp

    from diffwdf.parallel.distributed import measure_scaling
    from diffwdf.parallel.mesh import shard_batches

    ckt, params = _clipper()

    def make_step(mesh):
        n = mesh.devices.size
        vin = jnp.asarray(
            np.random.default_rng(0).normal(size=(2 * n, 64)).astype(np.float32)
        )
        batch = shard_batches({"x": vin}, mesh)

        @jax.jit
        def step(b):
            def one(v):
                out, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": v}})
                return out

            return jax.vmap(one)(b["x"])

        return lambda: step(batch)

    res = measure_scaling(make_step, (1, 4, 8), iters=3, items_per_call=128)
    assert set(res) == {1, 4, 8}
    for n, rec in res.items():
        assert rec["mean_s"] > 0 and np.isfinite(rec["efficiency"])


def test_time_block_pot_driven_r_stream(devices8):
    """Impedance-control streams (the pot 'R') must NOT be zeroed in device
    0's warm-up prefix — R=0 would make per-sample re-adaptation divide by
    zero and propagate NaN through the whole first block (regression)."""
    ckt, params = _clipper()
    mesh = make_mesh((1, 8), ("data", "time"))
    T = 8 * 512
    n = np.arange(T)
    vin = jnp.asarray(
        (2.0 * np.sin(2 * np.pi * 330.0 * n / FS)).astype(np.float32)
    )
    # slowly-swept pot: R from 30k to 60k over the signal
    r = jnp.asarray(np.linspace(30e3, 60e3, T).astype(np.float32))
    inputs = {"Vs": {"v": vin, "R": r}}

    serial, _ = ckt.process(params, ckt.init_state(), inputs)
    par = time_block_process(ckt, params, inputs, mesh, warmup=256)
    assert np.all(np.isfinite(np.asarray(par)))
    err = np.max(np.abs(np.asarray(par) - np.asarray(serial)))
    assert err < 1e-4, err
