"""Infra: checkpoint/resume, metrics JSONL, analysis, CLI smoke tests."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax

from diffwdf.analysis import transconductance_error
from diffwdf.roots.diode import diode_1n4148_1u1d
from diffwdf.roots.neural import mlp_arch, mlp_init
from diffwdf.training.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from diffwdf.training.metrics import MetricsLogger, load_jsonl


def test_checkpoint_roundtrip_with_opt_state(tmp_path):
    sizes, _ = mlp_arch(1, 4)
    params = mlp_init(jax.random.PRNGKey(0), sizes)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    # advance the optimizer so state is nontrivial
    g = jax.tree_util.tree_map(jnp.ones_like, params)
    up, opt_state = opt.update(g, opt_state, params)
    params = optax.apply_updates(params, up)

    path = str(tmp_path / "ckpt" / "step_7")
    save_checkpoint(path, params, opt_state, step=7, extra={"note": "x"})
    p2, s2, step, extra = restore_checkpoint(path, params, opt_state)
    assert step == 7 and extra == {"note": "x"}
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree_util.tree_leaves(opt_state), jax.tree_util.tree_leaves(s2)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    assert latest_checkpoint(str(tmp_path / "ckpt")).endswith("step_7")


def test_resume_training_is_exact(tmp_path):
    """Stop at epoch k, restore, continue: identical to an unbroken run."""
    sizes, acts = mlp_arch(1, 4)
    params = mlp_init(jax.random.PRNGKey(1), sizes)
    opt = optax.adam(1e-2)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32))
    y = jnp.tanh(x[:, :1])

    from diffwdf.roots.neural import mlp_apply

    @jax.jit
    def step(p, s):
        def loss(p):
            return jnp.mean((mlp_apply(p, acts, x) - y) ** 2)

        g = jax.grad(loss)(p)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s

    # unbroken 6 steps
    p, s = params, opt.init(params)
    for _ in range(6):
        p, s = step(p, s)

    # broken at 3 + resume
    p2, s2 = params, opt.init(params)
    for _ in range(3):
        p2, s2 = step(p2, s2)
    save_checkpoint(str(tmp_path / "c"), p2, s2, step=3)
    p3, s3, _, _ = restore_checkpoint(str(tmp_path / "c"), p2, s2)
    for _ in range(3):
        p3, s3 = step(p3, s3)

    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(p3)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_metrics_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    lg = MetricsLogger(path)
    for i in range(5):
        lg.log(i, samples=1000, loss=1.0 / (i + 1), esr=0.1 * i)
    lg.close()
    hist = load_jsonl(path)
    assert len(hist["loss"]) == 5
    assert hist["loss"][0] == 1.0
    assert "samples_per_s" in hist


def test_transconductance_error_metric():
    """A random net has large physics error; the golden pretrained net is
    accurate (if the zoo is mounted)."""
    sizes, acts = mlp_arch(2, 16)
    rand = mlp_init(jax.random.PRNGKey(0), sizes)
    e_rand = transconductance_error(rand, acts, diode_1n4148_1u1d)
    assert e_rand > 0.1

    zoo = (
        "/root/reference/wdf_py/diode_clipper/models/pretrained/"
        "1N4148 (1U-1D)_2x16_pretrained_model.json"
    )
    if os.path.exists(zoo):
        from diffwdf.nn.serialization import load_model_json

        mlp, acts2, _ = load_model_json(zoo)
        e_gold = transconductance_error(mlp, acts2, diode_1n4148_1u1d)
        assert e_gold < 0.1, e_gold


def test_cli_fit_components(capsys):
    from diffwdf.cli import main

    main(["fit-components", "--circuit", "divider", "--epochs", "60"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(out)
    assert rec["loss"] < 0.01


def test_cli_simulate(tmp_path, capsys):
    from diffwdf.cli import main

    out = str(tmp_path / "y.npy")
    main(
        [
            "simulate",
            "--circuit",
            "clipper",
            "--seconds",
            "0.05",
            "--fs",
            "8000",
            "--out",
            out,
        ]
    )
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    y = np.load(out)
    assert len(y) == rec["samples"] == 400
    assert np.all(np.isfinite(y))


def test_cli_pretrain_quick(tmp_path, capsys):
    from diffwdf.cli import main

    out = str(tmp_path / "m.json")
    main(
        [
            "pretrain",
            "--epochs",
            "5",
            "--width",
            "4",
            "--layers",
            "1",
            "--out",
            out,
        ]
    )
    assert os.path.exists(out)
    d = json.load(open(out))
    assert d["in_shape"] == [None, 2]


def test_save_layers_json_full_tag_set(tmp_path):
    """Generic exporter covers the reference's layer-kind tags
    (``model_utils.py:18-55``): gru/lstm/conv1d/td-dense + unknown."""
    import json

    import numpy as np

    from diffwdf.nn.serialization import save_layers_json

    specs = [
        {"type": "input-layer", "shape": [None, 2], "weights": []},
        {"type": "dense", "shape": [None, 8], "activation": "tanh",
         "weights": [np.zeros((2, 8)), np.zeros(8)]},
        {"type": "gru", "shape": [None, None, 4], "activation": "",
         "weights": [np.zeros((2, 12)), np.zeros((4, 12)), np.zeros((2, 12))]},
        {"type": "conv1d", "shape": [None, None, 3], "activation": "relu",
         "weights": [np.zeros((5, 1, 3)), np.zeros(3)],
         "kernel_size": 5, "dilation": 2},
    ]
    out = save_layers_json(specs, tmp_path / "m.json")
    d = json.load(open(tmp_path / "m.json"))
    kinds = [l["type"] for l in d["layers"]]
    assert kinds == ["unknown", "dense", "gru", "conv1d"]
    assert d["layers"][3]["kernel_size"] == [5]
    assert d["layers"][3]["dilation"] == [2]
    # the dense loader skips non-dense entries, reference behavior
    from diffwdf.nn.serialization import load_model_json

    mlp, acts, d_in = load_model_json(tmp_path / "m.json")
    assert len(mlp["layers"]) == 1 and acts == ("tanh",)


def test_load_history_jsonl_and_pickle(tmp_path):
    """History loader accepts the reference's pickles and our JSONL
    (``plot_history.py:9-16`` parity)."""
    import json
    import pickle

    from diffwdf.analysis import load_history

    hist = {"loss": [1.0, 0.5], "val_loss": [2.0, 1.0]}
    with open(tmp_path / "h.pkl", "wb") as f:
        pickle.dump(hist, f)
    assert load_history(tmp_path / "h.pkl") == hist

    with open(tmp_path / "h.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"epoch": i, "loss": hist["loss"][i],
                                "val_loss": hist["val_loss"][i]}) + "\n")
    h2 = load_history(tmp_path / "h.jsonl")
    assert h2["loss"] == hist["loss"] and "epoch" not in h2


def test_interrupted_save_is_not_a_checkpoint(tmp_path):
    """meta.json is the commit marker: a step directory left behind by a
    crash between the arrays write and the meta write must be skipped by
    latest_checkpoint instead of bricking resume (regression)."""
    sizes, _ = mlp_arch(1, 4)
    params = mlp_init(jax.random.PRNGKey(0), sizes)
    base = tmp_path / "ckpt"
    save_checkpoint(str(base / "step_3"), params, step=3)
    # simulate a crash mid-save of step_9: arrays.npz present, no meta.json
    crashed = base / "step_9"
    os.makedirs(crashed)
    np.savez(str(crashed / "arrays.npz"), x=np.zeros(3))
    chosen = latest_checkpoint(str(base))
    assert chosen.endswith("step_3"), chosen
    p2, _, step, _ = restore_checkpoint(chosen, params)
    assert step == 3


def test_overwrite_in_place_retracts_commit_marker(tmp_path, monkeypatch):
    """Overwriting an existing committed step dir must delete meta.json
    BEFORE replacing arrays.npz, so a crash between the two replaces leaves
    the directory uncommitted (stale meta must never describe new arrays)."""
    import diffwdf.training.checkpoint as ckpt_mod

    sizes, _ = mlp_arch(1, 4)
    params = mlp_init(jax.random.PRNGKey(0), sizes)
    d = tmp_path / "ckpt" / "step_3"
    save_checkpoint(str(d), params, step=3)

    class Crash(RuntimeError):
        pass

    real_replace = os.replace

    def crashing_replace(src, dst):
        real_replace(src, dst)
        if dst.endswith("arrays.npz"):  # die right after the arrays land
            raise Crash()

    monkeypatch.setattr(ckpt_mod.os, "replace", crashing_replace)
    import pytest as _pytest

    with _pytest.raises(Crash):
        save_checkpoint(str(d), params, step=9)
    monkeypatch.undo()

    # the interrupted overwrite is uncommitted: no meta.json, skipped
    assert not os.path.exists(d / "meta.json")
    assert latest_checkpoint(str(tmp_path / "ckpt")) is None
