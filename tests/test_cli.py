"""CLI surface smoke tests (the user entry point, ``diffwdf/cli.py``)."""

import json
import os

import numpy as np
import pytest

from diffwdf.cli import main


def test_cli_pretrain_smoke(tmp_path, capsys):
    out = tmp_path / "m.json"
    main([
        "pretrain", "--epochs", "5", "--width", "4", "--lr", "2e-3",
        "--schedule", "cosine", "--precision", "highest",
        "--out", str(out),
    ])
    cap = capsys.readouterr().out
    assert "backend:" in cap
    rec = json.loads([l for l in cap.splitlines() if l.startswith("{")][0])
    assert rec["arch"] == "2x4" and np.isfinite(rec["mse"])
    m = json.load(open(out))
    assert m["in_shape"] == [None, 2]  # reference schema


def test_cli_params_reflection(capsys):
    """`params` renders every circuit's schema as JSON — the CLI analogue of
    the reference's auto-generated GUI (``CircuitModelGUI.cpp:55-66``)."""
    main(["params", "--set", "plugin"])
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(rec["circuits"]) == {
        "clipper", "multi_diode_clipper", "tube_screamer"
    }
    for name, specs in rec["circuits"].items():
        assert {s["name"] for s in specs} >= {"gain", "model"}
        for s in specs:
            assert s["kind"] in ("float", "choice") and s["api"]
    ts = {s["name"]: s for s in rec["circuits"]["tube_screamer"]}
    assert ts["drive"]["default"] == 0.5
    main(["params", "--set", "hpf", "--pretty"])
    rec = json.loads(capsys.readouterr().out)
    assert set(rec["circuits"]) == {"hpf"}


def test_cli_simulate_smoke(tmp_path, capsys):
    out = tmp_path / "y.npy"
    main([
        "simulate", "--circuit", "tube_screamer", "--seconds", "0.05",
        "--drive", "0.8", "--out", str(out),
    ])
    y = np.load(out)
    assert y.shape == (2400,) and np.all(np.isfinite(y))


def test_cli_simulate_wav_roundtrip(tmp_path, capsys):
    """WAV in → distorted mono WAV out, fs taken from the file (serving parity
    with the reference plugin's audio-file path, DifferentiableWDFPlugin.cpp:50-64)."""
    from scipy.io import wavfile

    from diffwdf.data.audio import read_wav

    fs = 32000
    n = np.arange(int(0.05 * fs))
    sine = 0.9 * np.sin(2 * np.pi * 110.0 * n / fs)
    stereo16 = np.stack([sine, sine], axis=1)
    stereo16 = (stereo16 * 32767).astype(np.int16)
    wav_in = tmp_path / "in.wav"
    wavfile.write(wav_in, fs, stereo16)

    wav_out = tmp_path / "out.wav"
    main([
        "simulate", "--circuit", "clipper", "--fs", "48000",
        "--input", str(wav_in), "--out", str(wav_out),
    ])
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["samples"] == len(sine)
    fs_out, y = read_wav(wav_out)
    assert fs_out == fs  # file rate overrode --fs
    assert y.dtype == np.float32 and len(y) == len(sine)
    assert np.all(np.isfinite(y)) and 0 < np.max(np.abs(y)) < 1.5
    # the clipper must actually clip: output crest factor below the sine's
    assert np.max(np.abs(y)) / np.sqrt(np.mean(y**2)) < np.sqrt(2.0)


def test_cli_process_warmup_flag(tmp_path, capsys):
    """`process --warmup` pre-compiles the served circuit's block variants
    (prepareToPlay parity) and produces output identical to a cold run."""
    from diffwdf.data.audio import read_wav, write_wav

    fs = 24000
    n = np.arange(2048)
    x = 0.5 * np.sin(2 * np.pi * 330.0 * n / fs).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    write_wav(wav_in, fs, x)

    out_cold = tmp_path / "cold.wav"
    main(["process", "--input", str(wav_in), "--circuit", "clipper",
          "--block", "1024", "--out", str(out_cold)])
    rec_cold = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec_cold["warmup_s"] == 0.0

    out_warm = tmp_path / "warm.wav"
    main(["process", "--input", str(wav_in), "--circuit", "clipper",
          "--block", "1024", "--warmup", "--out", str(out_warm)])
    rec_warm = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec_warm["warmup_s"] > 0.0
    _, yc = read_wav(out_cold)
    _, yw = read_wav(out_warm)
    np.testing.assert_array_equal(yc, yw)


def test_cli_process_plugin_parity(tmp_path, capsys):
    """`process` streams blocks through the full plugin processor with the
    reference knob set (gain dB / cutoff / drive) and carried state."""
    from diffwdf.data.audio import read_wav, write_wav

    fs = 24000
    n = np.arange(int(0.2 * fs))
    x = 0.8 * np.sin(2 * np.pi * 220.0 * n / fs).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    write_wav(wav_in, fs, x)

    wav_out = tmp_path / "out.wav"
    main([
        "process", "--input", str(wav_in), "--circuit", "clipper",
        "--gain-db", "12", "--cutoff", "2000", "--block", "1024",
        "--out", str(wav_out),
    ])
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["samples"] == len(x) and rec["fs"] == fs
    assert rec["blocks"] == -(-len(x) // 1024) and rec["load"] >= 0
    _, y = read_wav(wav_out)
    assert np.all(np.isfinite(y)) and 0 < np.max(np.abs(y)) < 1.5
    # +12 dB into the clipper: heavily clipped, low crest factor
    assert np.max(np.abs(y)) / np.sqrt(np.mean(y**2)) < np.sqrt(2.0)


def test_cli_process_zoo_model_choice(tmp_path, capsys):
    """--model selects the clipper root from the 12-entry zoo (the reference
    DiodeClipper's model dropdown, DiodeClipperWDF.h:24-36); neural entries
    pick up the pretrained weights, so output stays near the analytic root."""
    from diffwdf.data.audio import write_wav

    fs = 24000
    n = np.arange(int(0.1 * fs))
    x = 1.0 * np.sin(2 * np.pi * 220.0 * n / fs).astype(np.float32)
    wav_in = tmp_path / "in.wav"
    write_wav(wav_in, fs, x)

    outs = {}
    for model in (0, 4):
        out = tmp_path / f"m{model}.npy"
        main(["process", "--input", str(wav_in), "--circuit", "clipper",
              "--model", str(model), "--out", str(out)])
        capsys.readouterr()
        outs[model] = np.load(out)
    has_pretrained = os.path.exists(
        "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"
    )
    a, b = outs[0][500:], outs[4][500:]
    esr = np.sum((a - b) ** 2) / np.sum(a**2)
    if has_pretrained:
        assert esr < 5e-2  # pretrained 2x16 tracks the analytic root
    assert np.all(np.isfinite(b))


def test_cli_rejects_bad_choice(capsys):
    with pytest.raises(SystemExit):
        main(["pretrain", "--precision", "bogus"])


def test_cli_fit_components_smoke(capsys):
    main(["fit-components", "--circuit", "divider", "--epochs", "30"])
    cap = capsys.readouterr().out
    assert "R1" in cap or "loss" in cap.lower()


def test_cli_engines_agree(tmp_path):
    """scan / fused-kernel / parallel-in-time engines give the same audio."""
    outs = {}
    for eng in ("scan", "fused", "pint", "native"):
        f = tmp_path / f"{eng}.npy"
        main([
            "simulate", "--circuit", "clipper", "--seconds", "0.02",
            "--engine", eng, "--out", str(f),
        ])
        outs[eng] = np.load(f)
    np.testing.assert_allclose(outs["scan"], outs["fused"], atol=5e-5)
    np.testing.assert_allclose(outs["scan"], outs["pint"], atol=5e-5)
    np.testing.assert_allclose(outs["scan"], outs["native"], atol=5e-5)
