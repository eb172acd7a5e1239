"""Command-line entry points for the framework's workloads.

The reference has no CLI (its scripts are Jupyter-style cell files with
constants edited at the top, ``clipper_pot.py:36-39``); this module gives
every workload a reproducible invocation:

    python -m diffwdf.cli pretrain --diode 1u1d --layers 2 --width 16
    python -m diffwdf.cli train-clipper --synthetic --diode 1u1d ...
    python -m diffwdf.cli simulate --circuit tube_screamer --drive 0.8
    python -m diffwdf.cli fit-components --circuit lpf

``--platform gpu`` insists on a GPU, ``--platform cpu`` runs on the host.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

DIODES = {
    "default": "default_diode",
    "1u1d": "diode_1n4148_1u1d",
    "1u2d": "diode_1n4148_1u2d",
    "1u3d": "diode_1n4148_1u3d",
    "2u2d": "diode_1n4148_2u2d",
    "2u3d": "diode_1n4148_2u3d",
    "3u3d": "diode_1n4148_3u3d",
    "oa1154": "diode_oa1154_1u1d",
}


def _diode(name):
    import diffwdf.roots.diode as d

    return getattr(d, DIODES[name])


def cmd_pretrain(args):
    import jax

    from .analysis import plot_history, plot_transconductance
    from .nn.serialization import save_model_json
    from .training.pretrain import PretrainConfig, evaluate_pretrained, pretrain_diode

    diode = _diode(args.diode)
    print(f"backend: {jax.default_backend()}")
    cfg = PretrainConfig(
        n_layers=args.layers,
        layer_size=args.width,
        epochs=args.epochs,
        learning_rate=args.lr,
        batch_size=args.batch_size,
        seed=args.seed,
        schedule=args.schedule,
        matmul_precision=args.precision,
    )
    params, acts, metrics = pretrain_diode(diode, cfg)
    final = evaluate_pretrained(params, acts, diode, cfg)
    print(json.dumps({"diode": diode.name, "arch": f"{args.layers}x{args.width}",
                      **final}))
    out = args.out or f"{diode.name}_{args.layers}x{args.width}_pretrained_model.json"
    save_model_json(params, acts, out)
    print(f"saved {out}")
    if args.plots_dir:
        os.makedirs(args.plots_dir, exist_ok=True)
        hist = {k: list(np.asarray(v)) for k, v in metrics.items()}
        plot_history(hist, os.path.join(args.plots_dir, "pretrain_history.png"))
        plot_transconductance(
            params, acts, diode,
            os.path.join(args.plots_dir, "transconductance.png"),
        )


def cmd_train_clipper(args):
    import jax

    from .analysis import plot_history
    from .data.dataimport import load_diode_data
    from .data.synthetic import make_synthetic_dataset_dir
    from .models.diode_clipper import make_training_clipper
    from .nn.serialization import load_model_json, save_model_json
    from .roots.neural import NeuralDiodeRoot
    from .training.checkpoint import save_checkpoint
    from .training.circuit_train import (
        CircuitTrainConfig,
        make_clipper_batches,
        train_clipper,
    )
    from .training.metrics import MetricsLogger

    diode = _diode(args.diode)
    if args.synthetic or not args.data_dir:
        data_dir = args.data_dir or "synthetic_dataset"
        family = "1N4148" if "1N4148" in diode.name else diode.name.split()[0]
        sub = os.path.join(
            data_dir, family, f"{diode.N_up}up{diode.N_down}down"
        )
        import glob

        if not glob.glob(os.path.join(sub, "*.csv")):
            print(f"synthesizing dataset under {data_dir} ...")
            make_synthetic_dataset_dir(
                data_dir, diode, fs=args.fs, duration_s=18.0
            )
        base = data_dir
    else:
        base = args.data_dir
    train, val, fs = load_diode_data(diode, base)
    print(f"train {len(train['x'])} samples, val {len(val['x'])}, fs {fs}")
    if len(train["x"]) == 0:
        raise SystemExit(f"no training data found under {base}")

    if args.pretrained:
        mlp, acts, _ = load_model_json(args.pretrained)
        root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    else:
        root = NeuralDiodeRoot(name="dp", n_layers=args.layers, layer_size=args.width)
        frag = root.init_params(jax.random.PRNGKey(args.seed))
    circuit = make_training_clipper(root, fs, cap=args.cap)
    params = {**circuit.init_params(), **frag}

    cfg = CircuitTrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        max_chunks=args.max_chunks,
        engine=args.engine,
        log_every=args.log_every,
    )
    tb = make_clipper_batches(train, cfg.batch_size, cfg.max_chunks)
    vb = (make_clipper_batches(val, cfg.batch_size, cfg.max_chunks)
          if len(val["x"]) else None)

    logger = MetricsLogger(args.log or "train_clipper.jsonl", print_every=args.log_every)

    def only_root(grads):
        import jax.numpy as jnp

        z = jax.tree_util.tree_map(jnp.zeros_like, grads)
        z["dp"] = grads["dp"]
        return z

    def on_epoch(epoch, p, hist):
        logger.log(epoch, samples=int(tb["x"].size),
                   **{k: v[-1] for k, v in hist.items() if v})
        if args.ckpt_dir:
            save_checkpoint(
                os.path.join(args.ckpt_dir, f"step_{epoch}"), p, step=epoch
            )

    params, hist = train_clipper(
        circuit, params, tb, vb, cfg, trainable_filter=only_root, on_epoch=on_epoch
    )
    out = args.out or f"{diode.name}_{args.layers}x{args.width}_circuit_trained.json"
    save_model_json(params["dp"], root.activations, out)
    print(f"saved {out}; final loss {hist['loss'][-1]:.6g}")
    if args.plots_dir:
        os.makedirs(args.plots_dir, exist_ok=True)
        plot_history(hist, os.path.join(args.plots_dir, "clipper_history.png"))


def cmd_simulate(args):
    import jax.numpy as jnp

    import diffwdf as dwdf
    from .models.diode_clipper import make_diode_clipper, make_hpf_diode_clipper
    from .models.tube_screamer import make_tube_screamer
    from .roots.neural import NeuralDiodeRoot

    if args.model_json:
        mlp, acts, _ = dwdf.load_model_json(args.model_json)
        root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    else:
        root = dwdf.DiodePairRoot(
            name="dp", diode=_diode(args.diode), quality=args.quality
        )
        frag = root.init_params()

    fs = args.fs
    if args.circuit == "clipper":
        ckt = make_diode_clipper(root, fs)
        drive_node = "Vs"
    elif args.circuit == "hpf_clipper":
        ckt = make_hpf_diode_clipper(root, fs)
        drive_node = "Vs"
    elif args.circuit == "tube_screamer":
        ckt = make_tube_screamer(root, fs, drive=args.drive)
        drive_node = "Vin"
    else:
        raise SystemExit(f"unknown circuit {args.circuit}")
    params = {**ckt.init_params(), **frag}

    if args.input and args.input.lower().endswith(".wav"):
        from .data.audio import read_wav

        file_fs, x = read_wav(args.input)
        if file_fs != fs:
            # the circuit was built for args.fs; rebuild at the file's rate
            fs = file_fs
            if args.circuit == "clipper":
                ckt = make_diode_clipper(root, fs)
            elif args.circuit == "hpf_clipper":
                ckt = make_hpf_diode_clipper(root, fs)
            else:
                ckt = make_tube_screamer(root, fs, drive=args.drive)
            params = {**ckt.init_params(), **frag}
        x = (args.amp * x).astype(np.float32)
    elif args.input:
        x = np.load(args.input).astype(np.float32)
    else:
        n = np.arange(int(args.seconds * fs))
        x = (args.amp * np.sin(2 * np.pi * args.freq * n / fs)).astype(np.float32)

    if args.engine == "scan":
        out, _ = ckt.process(
            params, ckt.init_state(), {drive_node: {"v": jnp.asarray(x)}}
        )
        out = np.asarray(out)
    elif args.engine == "fused":
        import jax

        from .ops.fused_circuit import fused_circuit_process

        st0 = jax.tree_util.tree_map(
            lambda z: jnp.zeros((1,), jnp.float32), ckt.init_state()
        )
        o, _ = fused_circuit_process(
            ckt, params, jnp.asarray(x)[None], st0, input_node=drive_node
        )
        out = np.asarray(o[0])
    elif args.engine == "pint":
        from .ops.parallel_time import parallel_time_process

        out = np.asarray(
            parallel_time_process(
                ckt, params, {drive_node: {"v": jnp.asarray(x)}}
            )
        )
    elif args.engine == "native":
        from .native.codegen import compile_circuit

        eng = compile_circuit(ckt, params, input_node=drive_node)
        out, _ = eng.process(x)
    else:
        raise SystemExit(f"unknown engine {args.engine}")
    out_path = args.out or "sim_out.npy"
    if out_path.lower().endswith(".wav"):
        from .data.audio import write_wav

        write_wav(out_path, fs, out)
    else:
        np.save(out_path, out)
    print(
        json.dumps(
            {
                "samples": len(out),
                "engine": args.engine,
                "peak": float(np.max(np.abs(out))),
                "rms": float(np.sqrt(np.mean(out**2))),
                "out": out_path,
            }
        )
    )


def cmd_process(args):
    """Plugin-parity serving: stream an audio file through the full plugin
    processor (circuit choice + gain/cutoff/drive parameters, block-wise with
    carried state — the user surface of ``DifferentiableWDFPlugin.h:41-43`` /
    ``DiodeClipper.cpp:20-31``)."""
    from .data.audio import read_wav, write_wav
    from .runtime.stream import make_plugin_processor

    if args.input.lower().endswith(".wav"):
        fs, x = read_wav(args.input)
    else:
        fs = args.fs
        x = np.load(args.input).astype(np.float32)

    # neural zoo entries default to the checked-in pretrained weights
    # (ZOO_MODEL_PATHS); --model-json overrides the selected clipper entry.
    # The full 12-entry zoo stays addressable (DiodeClipperWDF.h:24-36):
    # 0-6 are the clipper group's choices, 7-11 the multi-diode group's
    # (MultiDiodeClipper.cpp:48 offsets by +7 into the same WDF).
    circuit, model = args.circuit, args.model
    if circuit == "clipper" and model is not None and model >= 7:
        circuit, model = "multi_diode_clipper", model - 7
    # the processor takes the GLOBAL zoo index (0-11) and routes weights to
    # whichever group owns that entry; process_block uses the group-local
    # choice computed above
    clipper_zoo = args.model if args.circuit == "clipper" else None
    clipper_json = args.model_json if (clipper_zoo or 0) >= 2 else None
    proc = make_plugin_processor(
        fs, cutoff_hz=args.cutoff, drive=args.drive, mlp_json=args.model_json,
        clipper_zoo=clipper_zoo, clipper_json=clipper_json,
        engine=args.engine,
    )
    if circuit == "tube_screamer":
        knobs = {"drive": args.drive}
    else:
        knobs = {"cutoff_hz": args.cutoff}
    if model is not None:
        knobs["model"] = model

    block = args.block
    warmup_s = 0.0
    if getattr(args, "warmup", False):
        # prepareToPlay parity: compile every block variant of the served
        # circuit (members, engine, fallback) before the stream starts
        winfo = proc.warmup([block], circuits=(circuit,))
        warmup_s = winfo["seconds"]
    pad = (-len(x)) % block
    xp = np.pad(x, (0, pad))
    outs = [
        proc.process_block(xp[i : i + block], circuit,
                           gain_db=args.gain_db, **knobs)
        for i in range(0, len(xp), block)
    ]
    out = np.concatenate(outs)[: len(x)]

    out_path = args.out or "processed.wav"
    if out_path.lower().endswith(".wav"):
        write_wav(out_path, fs, out)
    else:
        np.save(out_path, out)
    print(
        json.dumps(
            {
                "samples": len(out),
                "fs": fs,
                "circuit": circuit,
                "blocks": len(outs),
                "load": round(proc.load, 4),
                "warmup_s": round(warmup_s, 3),
                "peak": float(np.max(np.abs(out))),
                "out": out_path,
            }
        )
    )


def cmd_params(args):
    """Reflect the parameter schema of every circuit in a processor set —
    the CLI render of the reference's auto-generated GUI
    (``CircuitModelGUI.cpp:55-66`` builds sliders/comboboxes from each
    circuit's paramTags; this prints the same information as JSON)."""
    from .runtime.stream import (
        make_clipper_processor,
        make_hpf_processor,
        make_plugin_processor,
    )

    fs = args.fs
    if args.set == "plugin":
        proc = make_plugin_processor(fs)
    elif args.set == "clipper":
        proc = make_clipper_processor(fs)
    else:
        proc = make_hpf_processor(fs)
    schema = {
        name: [s.to_dict() for s in proc.param_specs(name)]
        for name in proc.surfaces()
    }
    print(json.dumps({"set": args.set, "fs": fs, "circuits": schema},
                     indent=2 if args.pretty else None))


def cmd_export_artifact(args):
    """Compile a circuit (weights baked in) to a self-contained StableHLO
    serving artifact — the analog of the reference's train→JSON→
    plugin-binary deploy pipeline (``plugin/src/CMakeLists.txt:16-34``)."""
    import jax.numpy as jnp

    from .models.diode_clipper import (
        ZOO, cutoff_to_resistance, make_diode_clipper, make_root_from_zoo,
    )
    from .runtime.artifact import load_artifact, save_artifact

    fs = args.fs
    if args.circuit == "clipper":
        json_path = args.model_json
        if json_path is None and args.model >= 2 and os.path.exists("models/pretrained"):
            _, (n_layers, width) = ZOO[args.model]
            cfgs = ("1U-1D",) * 5 + ("1U-2D", "2U-2D", "1U-3D", "2U-3D", "3U-3D")
            cand = (f"models/pretrained/1N4148 ({cfgs[args.model - 2]})_"
                    f"{n_layers}x{width}_pretrained_model.json")
            json_path = cand if os.path.exists(cand) else None
        root, frag = make_root_from_zoo(args.model, json_path=json_path)
        cap = 2.2e-9
        ckt = make_diode_clipper(
            root, fs, r_source=cutoff_to_resistance(args.cutoff, cap), cap=cap)
        params = {**ckt.init_params(), **frag}
        input_node = "Vs"
    elif args.circuit == "tube_screamer":
        from .models.tube_screamer import make_tube_screamer
        from .roots.diode import DiodePairRoot
        from .roots.neural import NeuralDiodeRoot

        if args.model_json:
            from .nn.serialization import load_model_json

            mlp, acts, _ = load_model_json(args.model_json)
            root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
        else:
            root = DiodePairRoot(name="dp")
            frag = root.init_params()
        ckt = make_tube_screamer(root, fs, drive=args.drive)
        params = {**ckt.init_params(), **frag}
        input_node = "Vin"
    else:
        raise SystemExit(f"unknown circuit {args.circuit}")

    out_path = args.out or f"{args.circuit}_artifact.npz"
    meta = save_artifact(out_path, ckt, params, input_node=input_node,
                         block_len=args.block, fs=fs)
    result = {"out": out_path, **meta,
              "bytes": os.path.getsize(out_path)}
    if args.check:
        art = load_artifact(out_path)
        n = np.arange(4 * args.block)
        x = (2.0 * np.sin(2 * np.pi * 220.0 * n / fs)).astype(np.float32)
        y = art.run(x)
        ref, _ = ckt.process(params, ckt.init_state(),
                             {input_node: {"v": jnp.asarray(x)}})
        result["check_max_abs_err"] = float(np.max(np.abs(y - np.asarray(ref))))
    print(json.dumps(result))


def cmd_plot(args):
    """Analysis plots — CLI parity with the reference's two standalone
    plotting scripts (``plot_history.py``, ``plot_transconductance.py``)."""
    from . import analysis

    if args.what == "history":
        hist = analysis.load_history(args.history)
        out = args.out or "history.png"
        analysis.plot_history(hist, out, title=args.title or "Training history")
        rec = {"plot": "history", "epochs": len(hist.get("loss", [])), "out": out}
    else:  # transconductance
        from .nn.serialization import load_model_json

        mlp, acts, _ = load_model_json(args.model_json)
        diode = _diode(args.diode)
        out = args.out or "transconductance.png"
        analysis.plot_transconductance(mlp, acts, diode, out, r=args.r)
        err = analysis.transconductance_error(mlp, acts, diode)
        rec = {"plot": "transconductance", "diode": diode.name,
               "physics_rms_rel_err": err, "out": out}
    print(json.dumps(rec))


def cmd_run_artifact(args):
    """Serve audio from a compiled artifact alone — no circuit definition,
    params, or training stack (the deployment half of ``export-artifact``,
    playing the plugin's role at serve time)."""
    from .data.audio import read_wav, write_wav
    from .runtime.artifact import load_artifact

    art = load_artifact(args.artifact)
    if args.input.lower().endswith(".wav"):
        fs, x = read_wav(args.input)
    else:
        fs = art.meta.get("fs") or 48000.0
        x = np.load(args.input).astype(np.float32)
    y = art.run(x)
    out_path = args.out or "artifact_out.wav"
    if out_path.lower().endswith(".wav"):
        write_wav(out_path, fs, y)
    else:
        np.save(out_path, y)
    print(json.dumps({
        "samples": len(y),
        "fs": fs,
        "block_len": art.block_len,
        "peak": float(np.max(np.abs(y))),
        "out": out_path,
    }))


def cmd_fit_components(args):
    import jax.numpy as jnp
    import scipy.signal as sig

    import diffwdf as dwdf
    from .training.circuit_train import fit_components

    fs = args.fs
    if args.circuit == "divider":
        R1 = dwdf.Resistor("R1", 2.0e3, trainable=True)
        R2 = dwdf.Resistor("R2", 100.0, trainable=True)
        tree = dwdf.Inverter("I1", dwdf.Series("S1", R1, R2))
        ckt = dwdf.Circuit(tree=tree, root=dwdf.IdealVoltageSourceRoot("Vs"),
                           fs=fs, outputs=("R1",))
        n = np.arange(512)
        vin = np.sin(2 * np.pi * 100 * n / fs).astype(np.float32)
        target = 0.5 * vin
        lrs = {"R1.R": 25.0, "R2.R": 25.0}
    elif args.circuit == "lpf":
        R1 = dwdf.Resistor("R1", 1000.0, trainable=True)
        C1 = dwdf.Capacitor("C1", 1.0e-6, trainable=True)
        tree = dwdf.Inverter("I1", dwdf.Series("S1", R1, C1))
        ckt = dwdf.Circuit(tree=tree, root=dwdf.IdealVoltageSourceRoot("Vs"),
                           fs=fs, outputs=("C1",))
        T = 1280
        t = np.arange(T) / fs
        k = T / fs / np.log(100.0)
        sweep = np.sin(2 * np.pi * 100.0 * k * (np.exp(t / k) - 1)).astype(np.float32)
        rc = 1.0 / (2 * np.pi * 720.0)
        b, a = sig.bilinear([1.0], [rc, 1.0], fs=fs)
        vin = sweep
        target = sig.lfilter(b, a, sweep).astype(np.float32)
        lrs = {"R1.R": 25.0, "C1.C": 10.0e-9}
    else:
        raise SystemExit(f"unknown circuit {args.circuit}")

    params, hist = fit_components(
        ckt, ckt.init_params(), {"Vs": {"v": jnp.asarray(vin)}},
        jnp.asarray(target), lrs, epochs=args.epochs
    )
    result = {"loss": hist["loss"][-1], "params": hist["params"][-1]}
    print(json.dumps(result, default=float))


def main(argv=None):
    p = argparse.ArgumentParser(prog="diffwdf")
    p.add_argument("--platform", choices=("gpu", "cpu"),
                   help="JAX backend to run on (gpu fails when no GPU is "
                        "found; default: JAX's own choice)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("pretrain", help="synthetic diode pretraining")
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--layers", type=int, default=2)
    sp.add_argument("--width", type=int, default=16)
    sp.add_argument("--epochs", type=int, default=2000)
    sp.add_argument("--lr", type=float, default=2e-5)
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--schedule", default="const", choices=("const", "cosine"))
    sp.add_argument("--precision", default="default",
                    choices=("default", "high", "highest"),
                    help="matmul precision; 'highest' keeps the tiny-MLP "
                         "products in full float32")
    sp.add_argument("--out")
    sp.add_argument("--plots-dir")
    sp.set_defaults(fn=cmd_pretrain)

    sp = sub.add_parser("train-clipper", help="circuit-in-the-loop training")
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--data-dir")
    sp.add_argument("--synthetic", action="store_true")
    sp.add_argument("--pretrained")
    sp.add_argument("--layers", type=int, default=2)
    sp.add_argument("--width", type=int, default=16)
    sp.add_argument("--epochs", type=int, default=501)
    sp.add_argument("--lr", type=float, default=1e-4)
    sp.add_argument("--batch-size", type=int, default=2048)
    sp.add_argument("--max-chunks", type=int)
    sp.add_argument("--engine", default="scan",
                    choices=("scan", "fused_generic"),
                    help="fused_generic = fused-kernel forward + parallel "
                         "backward for any circuit (per-row and per-sample "
                         "pot streams, exact component/physics cotangents)")
    sp.add_argument("--cap", type=float, default=4.7e-9)
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--out")
    sp.add_argument("--log")
    sp.add_argument("--log-every", type=int, default=5)
    sp.add_argument("--ckpt-dir")
    sp.add_argument("--plots-dir")
    sp.set_defaults(fn=cmd_train_clipper)

    sp = sub.add_parser("simulate", help="run a circuit on a signal")
    sp.add_argument("--circuit", default="clipper",
                    choices=("clipper", "hpf_clipper", "tube_screamer"))
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--quality", default="best", choices=("best", "good", "low"))
    sp.add_argument("--model-json")
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--freq", type=float, default=220.0)
    sp.add_argument("--amp", type=float, default=1.0)
    sp.add_argument("--seconds", type=float, default=1.0)
    sp.add_argument("--drive", type=float, default=0.5)
    sp.add_argument("--input", help=".npy or .wav input signal (WAV is "
                    "mono-summed; its sample rate overrides --fs)")
    sp.add_argument("--engine", default="scan",
                    choices=("scan", "fused", "pint", "native"),
                    help="execution engine: lax.scan, fused Pallas kernel "
                         "(Triton on a GPU), parallel-in-time Newton solver, "
                         "or generated native C (codegen)")
    sp.add_argument("--out", help="output path (.npy, or .wav for mono "
                    "float32 audio)")
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser(
        "process",
        help="stream audio through the plugin processor (gain/cutoff/drive)",
    )
    sp.add_argument("--input", required=True, help=".wav or .npy audio")
    sp.add_argument("--circuit", default="clipper",
                    choices=("clipper", "multi_diode_clipper", "tube_screamer"))
    sp.add_argument("--gain-db", type=float, default=0.0)
    sp.add_argument("--cutoff", type=float, default=4000.0,
                    help="clipper cutoff Hz (200-20k, sets source R)")
    sp.add_argument("--drive", type=float, default=0.5,
                    help="tube screamer drive pot (0-1)")
    sp.add_argument("--model", type=int, choices=range(12), metavar="0-11",
                    help="clipper root from the 12-entry model zoo "
                         "(0 TOMS, 1 approx, 2-6 neural 1U-1D sizes, "
                         "7-11 multi-diode 2x16); neural entries load the "
                         "pretrained zoo weights when present")
    sp.add_argument("--model-json",
                    help="neural-root weights (tube screamer, or clipper "
                         "with --model >= 2)")
    sp.add_argument("--block", type=int, default=2048)
    sp.add_argument("--fs", type=float, default=48000.0,
                    help="sample rate for .npy inputs")
    sp.add_argument("--engine", default="scan", choices=("scan", "deer"),
                    help="deer = parallel-in-time (Newton over the block) "
                         "serving, with the scan as residual-triggered "
                         "fallback")
    sp.add_argument("--warmup", action="store_true",
                    help="pre-compile every block variant of the served "
                         "circuit before streaming (prepareToPlay parity; "
                         "first block then runs at steady-state latency)")
    sp.add_argument("--out", help="output path (.wav or .npy)")
    sp.set_defaults(fn=cmd_process)

    sp = sub.add_parser(
        "params",
        help="print the per-circuit parameter schema (GUI reflection)",
    )
    sp.add_argument("--set", default="plugin",
                    choices=("plugin", "clipper", "hpf"))
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--pretty", action="store_true")
    sp.set_defaults(fn=cmd_params)

    sp = sub.add_parser(
        "export-artifact",
        help="compile a circuit to a self-contained StableHLO serving artifact",
    )
    sp.add_argument("--circuit", default="clipper",
                    choices=("clipper", "tube_screamer"))
    sp.add_argument("--model", type=int, default=0, choices=range(12),
                    metavar="0-11", help="clipper root from the model zoo")
    sp.add_argument("--model-json", help="neural-root weights JSON")
    sp.add_argument("--cutoff", type=float, default=4000.0)
    sp.add_argument("--drive", type=float, default=0.5)
    sp.add_argument("--block", type=int, default=2048)
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.add_argument("--out", help="output .npz path")
    sp.add_argument("--check", action="store_true",
                    help="reload the artifact and cross-check against the "
                         "live scan engine")
    sp.set_defaults(fn=cmd_export_artifact)

    sp = sub.add_parser(
        "plot",
        help="analysis plots (history / transconductance, reference plot_* scripts)",
    )
    sp.add_argument("what", choices=("history", "transconductance"))
    sp.add_argument("--history", help="history .pkl or metrics .jsonl")
    sp.add_argument("--model-json", help="neural-root weights JSON")
    sp.add_argument("--diode", default="1u1d", choices=DIODES)
    sp.add_argument("--r", type=float, default=100.0,
                    help="port resistance for transconductance extraction")
    sp.add_argument("--title", help="history plot title")
    sp.add_argument("--out", help="output .png path")
    sp.set_defaults(fn=cmd_plot)

    sp = sub.add_parser(
        "run-artifact",
        help="serve audio from a compiled artifact (no circuit code needed)",
    )
    sp.add_argument("--artifact", required=True, help="artifact .npz path")
    sp.add_argument("--input", required=True, help=".wav or .npy audio")
    sp.add_argument("--out", help="output path (.wav or .npy)")
    sp.set_defaults(fn=cmd_run_artifact)

    sp = sub.add_parser("fit-components", help="learn R/C values (sanity workloads)")
    sp.add_argument("--circuit", default="divider", choices=("divider", "lpf"))
    sp.add_argument("--epochs", type=int, default=100)
    sp.add_argument("--fs", type=float, default=48000.0)
    sp.set_defaults(fn=cmd_fit_components)

    args = p.parse_args(argv)
    import jax

    from .device import enable_compile_cache

    if args.platform:
        # "gpu" makes JAX fail at start-up when no GPU is found
        jax.config.update("jax_platforms",
                          "cuda" if args.platform == "gpu" else "cpu")
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
