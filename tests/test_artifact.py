"""Compiled serving artifacts (jax.export / StableHLO).

The analog of the reference's deploy pipeline
(train -> JSON -> binary-embedded -> RTNeural parse,
``plugin/src/CMakeLists.txt:16-34`` / ``DiodePairNeuralModel.h:55-61``):
a trained circuit is lowered to a self-contained artifact that serves with
no access to the circuit definition or weights.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from diffwdf.models.diode_clipper import make_diode_clipper
from diffwdf.models.tube_screamer import make_tube_screamer
from diffwdf.roots.diode import DiodePairRoot
from diffwdf.roots.neural import NeuralDiodeRoot
from diffwdf.runtime.artifact import export_circuit, load_artifact, save_artifact

FS = 48000.0
PRETRAINED_2x16 = "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"


def _sine(n, amp=2.0, f=220.0):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / FS)).astype(np.float32)


def _make_clipper():
    root = DiodePairRoot(name="dp")
    ckt = make_diode_clipper(root, FS)
    return ckt, {**ckt.init_params(), **root.init_params()}


def test_artifact_roundtrip_matches_scan(tmp_path):
    ckt, params = _make_clipper()
    path = str(tmp_path / "clip.npz")
    meta = save_artifact(path, ckt, params, block_len=256, fs=FS)
    assert meta["format"] == "diffwdf-artifact-v1"

    art = load_artifact(path)
    x = _sine(1000)  # non-multiple of block_len: exercises padding
    y = art.run(x)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(y - np.asarray(ref))) < 1e-5


def test_artifact_exports_for_cpu_and_cuda():
    """The default export lowers for the host and the GPU alike (lowering
    for CUDA needs no card); the in-memory artifact runs here."""
    ckt, params = _make_clipper()
    art = export_circuit(ckt, params, block_len=128, fs=FS)
    assert art.meta["platforms"] == ["cpu", "cuda"]
    assert tuple(art._exported.platforms) == ("cpu", "cuda")
    x = _sine(300)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(art.run(x) - np.asarray(ref))) < 1e-5


def test_artifact_state_carries_across_blocks(tmp_path):
    """Block-wise artifact serving must be gap-free: capacitor state crosses
    block boundaries exactly, so chunked == one-shot."""
    ckt, params = _make_clipper()
    path = str(tmp_path / "clip.npz")
    save_artifact(path, ckt, params, block_len=128, fs=FS)
    art = load_artifact(path)

    x = _sine(512)
    y_stream = art.run(x)

    state = tuple(jnp.asarray(s) for s in art.init_state)
    y_manual = []
    for i in range(0, 512, 128):
        out, state = art.process(state, x[i : i + 128])
        y_manual.append(np.asarray(out))
    assert np.array_equal(y_stream, np.concatenate(y_manual))


def test_artifact_is_self_contained(tmp_path):
    """Loading needs only the file — no circuit, params, or root objects."""
    ckt, params = _make_clipper()
    path = str(tmp_path / "clip.npz")
    save_artifact(path, ckt, params, block_len=64, fs=FS)
    del ckt, params

    art = load_artifact(path)
    assert art.block_len == 64 and len(art.init_state) == art.meta["n_state"]
    y = art.run(_sine(200))
    assert y.shape == (200,) and np.all(np.isfinite(y)) and np.max(np.abs(y)) > 0.1


@pytest.mark.skipif(not os.path.exists(PRETRAINED_2x16), reason="zoo absent")
def test_artifact_neural_root_weights_baked_in(tmp_path):
    from diffwdf.nn.serialization import load_model_json

    mlp, acts, _ = load_model_json(PRETRAINED_2x16)
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **frag}
    path = str(tmp_path / "neural.npz")
    save_artifact(path, ckt, params, block_len=256, fs=FS)

    art = load_artifact(path)
    x = _sine(1024)
    y = art.run(x)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(y - np.asarray(ref))) < 1e-5


def test_artifact_tube_screamer(tmp_path):
    """The R-type-adaptor circuit (two reactive states + op-amp S matrix)
    exports and round-trips too."""
    root = DiodePairRoot(name="dp")
    ckt = make_tube_screamer(root, FS, drive=0.5)
    params = {**ckt.init_params(), **root.init_params()}
    path = str(tmp_path / "ts.npz")
    save_artifact(path, ckt, params, input_node="Vin", block_len=256, fs=FS)

    art = load_artifact(path)
    x = _sine(512, amp=0.5)
    y = art.run(x)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vin": {"v": jnp.asarray(x)}})
    assert np.max(np.abs(y - np.asarray(ref))) < 1e-5


def test_artifact_rejects_foreign_file(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, meta=np.asarray('{"format": "other"}'))
    with pytest.raises(ValueError):
        load_artifact(path)


def test_cli_export_then_run_artifact(tmp_path):
    """Full deploy loop through the user surface: export on the 'trainer',
    serve from the artifact alone."""
    from diffwdf.cli import main

    art = str(tmp_path / "a.npz")
    inp = str(tmp_path / "x.npy")
    out = str(tmp_path / "y.npy")
    np.save(inp, _sine(700, amp=0.8))
    main(["export-artifact", "--circuit", "clipper", "--model", "0",
          "--block", "256", "--out", art])
    main(["run-artifact", "--artifact", art, "--input", inp, "--out", out])
    y = np.load(out)
    assert y.shape == (700,) and np.all(np.isfinite(y)) and np.max(np.abs(y)) > 0.05
