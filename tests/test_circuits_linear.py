"""Linear WDF circuits vs analytic transfer functions.

These are the reference's de-facto integration oracles
(``wdf_py/simple_circuits/``): voltage-divider ratio, RC one-pole response.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.signal as sig

import diffwdf as dwdf

FS = 48000.0


def _divider_circuit(r1=2.0e3, r2=100.0):
    R1 = dwdf.Resistor("R1", r1, trainable=True)
    R2 = dwdf.Resistor("R2", r2, trainable=True)
    S1 = dwdf.Series("S1", R1, R2)
    I1 = dwdf.Inverter("I1", S1)
    return dwdf.Circuit(
        tree=I1, root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("R1",)
    )


def test_voltage_divider_ratio():
    """Output across R1 of Vs -> series(R1, R2) must be Vin * R1/(R1+R2)."""
    ckt = _divider_circuit()
    params, state = ckt.init_params(), ckt.init_state()
    t = np.arange(256) / FS
    vin = np.sin(2 * np.pi * 100.0 * t).astype(np.float32)
    inputs = {"Vs": {"v": jnp.asarray(vin)}}
    out, _ = ckt.process(params, state, inputs)
    want = vin * 2000.0 / 2100.0
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_divider_is_memoryless_and_jittable():
    ckt = _divider_circuit()
    params, state = ckt.init_params(), ckt.init_state()
    fn = jax.jit(lambda p, s, i: ckt.process(p, s, i))
    vin = jnp.asarray(np.random.default_rng(0).normal(size=64).astype(np.float32))
    out, st = fn(params, state, {"Vs": {"v": vin}})
    assert st == {}  # no reactive elements
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(vin) * 2000.0 / 2100.0, atol=1e-5
    )


def _rc_lpf_circuit(r=1000.0, c=1.0e-6):
    R1 = dwdf.Resistor("R1", r, trainable=True)
    C1 = dwdf.Capacitor("C1", c, trainable=True)
    S1 = dwdf.Series("S1", R1, C1)
    I1 = dwdf.Inverter("I1", S1)
    return dwdf.Circuit(
        tree=I1, root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("C1",)
    )


def test_rc_lowpass_impulse_response():
    """WDF RC lowpass == bilinear-transform discretization of 1/(1+sRC)."""
    r, c = 1000.0, 1.0e-6
    ckt = _rc_lpf_circuit(r, c)
    params, state = ckt.init_params(), ckt.init_state()
    N = 512
    x = np.zeros(N, dtype=np.float32)
    x[0] = 1.0
    out, _ = ckt.process(params, state, {"Vs": {"v": jnp.asarray(x)}})

    # analytic: bilinear transform of H(s) = 1/(1 + sRC) at fs
    b, a = sig.bilinear([1.0], [r * c, 1.0], fs=FS)
    want = sig.lfilter(b, a, x)
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_rc_lowpass_cutoff_gain():
    """-3 dB at fc = 1/(2 pi R C) on a long sine (steady state)."""
    r, c = 1000.0, 1.0e-6
    fc = 1.0 / (2 * np.pi * r * c)
    ckt = _rc_lpf_circuit(r, c)
    params, state = ckt.init_params(), ckt.init_state()
    n = np.arange(9600)
    vin = np.sin(2 * np.pi * fc * n / FS).astype(np.float32)
    out, _ = ckt.process(params, state, {"Vs": {"v": jnp.asarray(vin)}})
    y = np.asarray(out)[4800:]
    gain = np.sqrt(np.mean(y**2) * 2.0)
    np.testing.assert_allclose(gain, 1.0 / np.sqrt(2.0), rtol=2e-2)


def test_gradients_flow_to_component_values():
    """d(loss)/dR and d(loss)/dC are finite and nonzero — the property the
    reference's simple-circuit workloads rely on."""
    ckt = _rc_lpf_circuit()
    params, state = ckt.init_params(), ckt.init_state()
    vin = jnp.asarray(np.random.default_rng(1).normal(size=128).astype(np.float32))

    def loss(p):
        out, _ = ckt.process(p, state, {"Vs": {"v": vin}})
        return jnp.mean(out**2)

    g = jax.grad(loss)(params)
    assert np.isfinite(float(g["R1"]["R"])) and abs(float(g["R1"]["R"])) > 0
    assert np.isfinite(float(g["C1"]["C"])) and abs(float(g["C1"]["C"])) > 0


def test_constraints_clip():
    ckt = _rc_lpf_circuit()
    params = ckt.init_params()
    params["R1"]["R"] = jnp.asarray(5.0)  # below the 180 Ohm floor
    params["C1"]["C"] = jnp.asarray(10.0)  # above the 1 F ceiling
    clipped = ckt.constrain(params)
    assert float(clipped["R1"]["R"]) == 180.0
    assert float(clipped["C1"]["C"]) == 1.0


def test_vmap_over_batch():
    """Batch of independent circuit instances via vmap over controls+state."""
    ckt = _divider_circuit()
    params, state = ckt.init_params(), ckt.init_state()
    B, T = 4, 32
    vin = jnp.asarray(np.random.default_rng(2).normal(size=(B, T)).astype(np.float32))

    def run(v):
        out, _ = ckt.process(params, state, {"Vs": {"v": v}})
        return out

    outs = jax.vmap(run)(vin)
    assert outs.shape == (B, T)
    np.testing.assert_allclose(
        np.asarray(outs), np.asarray(vin) * 2000.0 / 2100.0, atol=1e-5
    )


def test_parallel_adaptor_current_divider():
    """Vs with series resistance feeding R2 || R3: check node voltage."""
    rs, r2 = 1.0e3, 2.0e3
    Vs = dwdf.ResistiveVoltageSource("Vs", rs)
    R2 = dwdf.Resistor("R2", r2)
    P1 = dwdf.Parallel("P1", Vs, R2)
    ckt = dwdf.Circuit(
        tree=P1, root=dwdf.OpenCircuitRoot("open"), fs=FS, outputs=("R2",)
    )
    params, state = ckt.init_params(), ckt.init_state()
    vin = np.ones(16, dtype=np.float32)
    out, _ = ckt.process(params, state, {"Vs": {"v": jnp.asarray(vin)}})
    want = vin * r2 / (rs + r2)  # open-circuit root => plain divider into R2
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_rl_highpass_impulse_response():
    """WDF inductor == bilinear discretization of the RL highpass
    H(s) = sL/(R + sL), probed across L in Vs -> series(R, L)."""
    r, l = 1000.0, 0.1
    R1 = dwdf.Resistor("R1", r)
    L1 = dwdf.Inductor("L1", l)
    S1 = dwdf.Series("S1", R1, L1)
    I1 = dwdf.Inverter("I1", S1)
    ckt = dwdf.Circuit(
        tree=I1, root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("L1",)
    )
    params, state = ckt.init_params(), ckt.init_state()
    N = 512
    x = np.zeros(N, dtype=np.float32)
    x[0] = 1.0
    out, _ = ckt.process(params, state, {"Vs": {"v": jnp.asarray(x)}})
    b, a = sig.bilinear([l, 0.0], [l, r], fs=FS)
    want = sig.lfilter(b, a, x)
    np.testing.assert_allclose(np.asarray(out), want, atol=1e-5)


def test_resistive_current_source():
    """Norton source: I into R_src || R_load -> v = I * (R_src || R_load)."""
    i_src, r_src, r_load = 1e-3, 10e3, 5e3
    Is = dwdf.ResistiveCurrentSource("Is", R=r_src)
    RL = dwdf.Resistor("RL", r_load)
    P1 = dwdf.Parallel("P1", Is, RL)
    ckt = dwdf.Circuit(
        tree=P1, root=dwdf.OpenCircuitRoot("open"), fs=FS, outputs=("RL",)
    )
    params, state = ckt.init_params(), ckt.init_state()
    drive = {"Is": {"i": jnp.full((8,), i_src, jnp.float32)}}
    out, _ = ckt.process(params, state, drive)
    want = i_src * (r_src * r_load) / (r_src + r_load)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-5)
