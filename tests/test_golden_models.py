"""Golden tests against the reference's checked-in model zoo.

The ~60 JSON weight files under the reference's ``wdf_py/diode_clipper/models``
are golden vectors: a pretrained net approximates the *analytic* diode-pair
wave equation (its training target, ``diode_pretraining.py:98-105``), so
loading it into our MLP root and comparing against our analytic root
cross-validates the JSON loader, the MLP forward, the sign/log-R conventions,
and the analytic root all at once.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import diffwdf as dwdf
from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.roots.diode import diode_1n4148_1u1d, diode_pair_reflected
from diffwdf.roots.neural import NeuralDiodeRoot, mlp_apply

REF_MODELS = "/root/reference/wdf_py/diode_clipper/models"
PRETRAINED_2x16 = os.path.join(
    REF_MODELS, "pretrained", "1N4148 (1U-1D)_2x16_pretrained_model.json"
)

needs_zoo = pytest.mark.skipif(
    not os.path.exists(PRETRAINED_2x16), reason="reference model zoo not mounted"
)


@needs_zoo
def test_load_pretrained_json_structure():
    mlp, acts, d_in = dwdf.load_model_json(PRETRAINED_2x16)
    assert d_in == 2
    # "2x16" = input dense + 2 hidden (all tanh) + linear head
    assert acts == ("tanh", "tanh", "tanh", "")
    shapes = [l["kernel"].shape for l in mlp["layers"]]
    assert shapes == [(2, 16), (16, 16), (16, 16), (16, 1)]


@needs_zoo
def test_pretrained_net_matches_analytic_root():
    """-MLP([a, log R]) must approximate the eqn-45 reflected wave over the
    pretraining grid (a in [-2.5, 2.5], R in 10^1..10^9) to the advertised
    accuracy (rel RMS ~3e-3 for the 2x16 net, ``diode_pretraining.py:194``)."""
    mlp, acts, _ = dwdf.load_model_json(PRETRAINED_2x16)
    diode = diode_1n4148_1u1d
    Vt = diode.Vt * diode.nabla

    errs = []
    for logR in np.linspace(np.log(10.0), np.log(1e9), 10):
        a = np.linspace(-2.5, 2.5, 501).astype(np.float32)
        x = np.stack([a, np.full_like(a, logR)], axis=-1)
        pred_b = -np.asarray(mlp_apply(mlp, acts, jnp.asarray(x)))[:, 0]
        true_b = np.asarray(
            diode_pair_reflected(
                jnp.asarray(a), jnp.float32(np.exp(logR)), diode.Is, Vt, 1.0, 1.0
            )
        )
        errs.append(
            np.sqrt(np.sum((pred_b - true_b) ** 2) / (np.sum(true_b**2) + 1e-12))
        )
    assert np.median(errs) < 5e-2, errs


@needs_zoo
def test_roundtrip_save_load():
    mlp, acts, d_in = dwdf.load_model_json(PRETRAINED_2x16)
    d = dwdf.save_model_json(mlp, acts, d_in=d_in)
    mlp2, acts2, d_in2 = dwdf.load_model_json(d)
    assert acts2 == acts and d_in2 == d_in
    for l1, l2 in zip(mlp["layers"], mlp2["layers"]):
        np.testing.assert_allclose(
            np.asarray(l1["kernel"]), np.asarray(l2["kernel"]), rtol=1e-7
        )
        np.testing.assert_allclose(
            np.asarray(l1["bias"]), np.asarray(l2["bias"]), rtol=1e-7
        )


@needs_zoo
def test_neural_clipper_close_to_analytic_clipper():
    """End-to-end: the LPF diode clipper with the pretrained neural root must
    track the analytic (TOMS-equivalent) clipper on a sine sweep — this is the
    reference's whole premise (neural root as drop-in for Wright omega)."""
    fs = 48000.0
    diode = diode_1n4148_1u1d

    analytic_root = dwdf.DiodePairRoot(name="dp", diode=diode, quality="best")
    ckt_a = make_diode_clipper(analytic_root, fs)
    pa = {**ckt_a.init_params(), **analytic_root.init_params()}

    mlp, acts, _ = dwdf.load_model_json(PRETRAINED_2x16)
    nroot, np_frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    ckt_n = make_diode_clipper(nroot, fs)
    pn = {**ckt_n.init_params(), **np_frag}

    n = np.arange(4096)
    vin = (2.0 * np.sin(2 * np.pi * 220.0 * n / fs)).astype(np.float32)
    inputs = {"Vs": {"v": jnp.asarray(vin)}}

    ya, _ = ckt_a.process(pa, ckt_a.init_state(), inputs)
    yn, _ = ckt_n.process(pn, ckt_n.init_state(), inputs)
    ya, yn = np.asarray(ya)[50:], np.asarray(yn)[50:]
    esr = np.sum((ya - yn) ** 2) / (np.sum(ya**2) + 1e-12)
    assert esr < 5e-3, esr


def test_make_root_from_zoo_all_entries():
    from diffwdf.models.diode_clipper import ZOO, make_root_from_zoo

    for idx in range(len(ZOO)):
        root, frag = make_root_from_zoo(idx)
        assert root.name == "dp"
        if ZOO[idx][0] == "neural":
            n_layers, width = ZOO[idx][1]
            ks = frag["dp"]["layers"][0]["kernel"].shape
            assert ks == (2, width)
            assert len(frag["dp"]["layers"]) == n_layers + 2


def test_trained_artifacts_track_their_circuits():
    """Our own trained artifacts (HPF-trained, OA1154 circuit-trained) track
    the analytic oracle in their training topology (skip if not built yet)."""
    import os

    import jax
    import jax.numpy as jnp
    import pytest

    import diffwdf as dwdf
    from diffwdf.models.diode_clipper import (
        make_hpf_diode_clipper,
        make_training_clipper,
    )
    from diffwdf.roots.neural import NeuralDiodeRoot

    cases = [
        ("runs/hpf_1u1d/1N4148_1U1D_2x16_hpf_trained.json",
         dwdf.diode_1n4148_1u1d,
         lambda r: make_hpf_diode_clipper(r, 48000.0), "Vs"),
        ("runs/oa1154/OA1154_1U1D_2x16_circuit_trained.json",
         dwdf.diode_oa1154_1u1d,
         lambda r: make_training_clipper(r, 48000.0, r_source=45.0e3), "Vs"),
    ]
    ran = 0
    for path, diode, mk, node in cases:
        if not os.path.exists(path):
            continue
        ran += 1
        mlp, acts, _ = dwdf.load_model_json(path)
        nroot, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
        ckt_n = mk(nroot)
        pn = {**ckt_n.init_params(), **frag}
        aroot = dwdf.DiodePairRoot(name="dp", diode=diode)
        ckt_a = mk(aroot)
        pa = {**ckt_a.init_params(), **aroot.init_params()}
        n = np.arange(9600)
        x = jnp.asarray((1.5 * np.sin(2 * np.pi * 300.0 * n / 48000.0))
                        .astype(np.float32))
        yn, _ = ckt_n.process(pn, ckt_n.init_state(), {node: {"v": x}})
        ya, _ = ckt_a.process(pa, ckt_a.init_state(), {node: {"v": x}})
        yn, ya = np.asarray(yn)[200:], np.asarray(ya)[200:]
        esr = np.sum((yn - ya) ** 2) / (np.sum(ya**2) + 1e-12)
        assert esr < 1e-2, (path, esr)
    if not ran:
        pytest.skip("no trained artifacts present")


@needs_zoo
def test_full_reference_zoo_interchange():
    """EVERY JSON in the reference's model directory (pretrained, circuit-
    trained, legacy ``old/`` exports — 68 files) loads through our
    serialization, runs finitely through the MLP forward, and survives a
    save→load round trip bit-exactly in f32.  Covers the legacy format
    variants (nested/int ``in_shape``, InputLayer rows, 3-D kernels)."""
    import glob

    from diffwdf.nn.serialization import load_model_json, save_model_json

    files = sorted(glob.glob(os.path.join(REF_MODELS, "**", "*.json"),
                             recursive=True))
    assert len(files) >= 60
    for f in files:
        mlp, acts, d_in = load_model_json(f)
        assert len(mlp["layers"]) == len(acts) >= 3
        x = jnp.stack(
            [jnp.linspace(-2.5, 2.5, 32)] * d_in, axis=1
        )
        y = np.asarray(mlp_apply(mlp, acts, x))
        assert np.all(np.isfinite(y)), f
        mlp2, acts2, d2 = load_model_json(save_model_json(mlp, acts, d_in=d_in))
        assert acts2 == acts and d2 == d_in
        y2 = np.asarray(mlp_apply(mlp2, acts2, x))
        np.testing.assert_array_equal(y, y2, err_msg=f)
