"""chip_smoke.py's phases at tiny sizes on the CPU (Pallas in interpret
mode), and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs


def test_render_phase_tiny():
    res = cs.phase_render(B=20, T=64, interpret=True, reps=1)
    assert set(res) == {"toms", "neural_2x16", "tube_screamer"}
    for r in res.values():
        assert r["kernel_err"] <= r["bound"]


def test_training_phase_tiny(tmp_path):
    res = cs.phase_training(B=16, T=128, epochs=3, chunk=512, max_chunks=4,
                            out_dir=str(tmp_path))
    for r in res.values():
        assert r["grad_rel_err"] <= cs.GRAD_RTOL


def test_serving_phase_tiny():
    res = cs.phase_serving(block=256, n_blocks=4)
    assert res["clipper"]["deer_vs_scan"] <= cs.SERVE_ATOL
    assert res["plugin"]["fallbacks"] == 0


def test_artifact_phase_tiny(tmp_path):
    errs = cs.phase_artifact(block=256, n_blocks=2, out_dir=str(tmp_path))
    assert max(errs.values()) <= 1e-5


def test_four_card_phase_on_virtual_devices(devices8):
    res = cs.phase_four_cards(n_dev=4, seconds=0.05, n_inst=16, T_sweep=128,
                              dp_rows=8, dp_T=128)
    assert res["time_block"]["err"] <= 1e-5 and res["sweep"]["err"] <= 1e-6


def test_failed_check_raises():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")


def test_main_refuses_the_cpu(capsys):
    assert cs.main([]) == 2
    out, err = capsys.readouterr()
    assert "no GPU" in err and '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """In a directory holding only the script, it exits nonzero and prints
    no result line."""
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises((json.JSONDecodeError, KeyError, TypeError)):
            json.loads(line)["ok"]
