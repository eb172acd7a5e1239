"""Smoke test of diffwdf on the GPU: the main paths, end to end, at full
width, each checked against the plain reference on the card.

    python3 chip_smoke.py                # one GPU
    python3 chip_smoke.py --four-cards   # only the multi-device paths

The plain reference is the ``lax.scan`` engine in float32 under
``jax.default_matmul_precision("highest")``.  Phases (one GPU):

1. device    platform, device kind, ``nvidia-smi`` name and power limit;
2. render    batch rendering at the reference plugin's bench setup
             (96 kHz, B=8192 streams x T=2048 samples) for the TOMS
             clipper, the neural 2x16 clipper and the Tube Screamer,
             through the fused kernel (Triton) and through the scan, with
             the time of each;
3. training  ``train-clipper --synthetic`` on the scan engine, and one
             ``fused_generic`` loss+gradient (Tube Screamer, clipper, per-row
             pot) against scan BPTT;
4. serving   clipper and plugin processors, scan and deer engines, 8 blocks
             with one model hot-swap;
5. artifact  export for ("cpu", "cuda"), run on the card, compare with the
             scan.

``--four-cards`` runs only data-parallel training, time-block rendering and
the instance sweep over four GPUs, each against one device.

Every phase is a function that takes its sizes, so it also runs on the CPU
at tiny sizes (Pallas in interpret mode).  ``main`` alone insists on the GPU.
The last line printed is one JSON object, ``{"ok": true, "device": {...}}``,
printed only when every phase passed; a failed phase exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FS = 96000.0
CAP = 2.2e-9
CUTOFF_HZ = 4000.0  # the plugin's default cutoff
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chip_smoke_out")

# max |kernel - reference| bounds.  Analytic roots: the CPU engine-parity
# bound (tests/test_cli.py).  Neural: the FMA-ordered float32 MLP differs
# from the reference's dot products in the last bits, amplified by the
# recursion.
RENDER_BOUNDS = {"toms": 5e-5, "tube_screamer": 5e-5, "neural_2x16": 2e-4}
GRAD_RTOL = 1e-3  # fused_generic vs scan BPTT (tests/test_parallel_bptt.py)
SERVE_ATOL = 2e-4  # deer vs scan serving (tests/test_deer_circuit.py)


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def report(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def _timed(f, *args, reps: int):
    """Median wall time of ``f(*args)`` over ``reps`` calls, each ended by
    ``block_until_ready``, after one untimed call (compile + warm-up)."""
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _render_circuit(name: str, fs: float):
    """(circuit, params, drive node, drive amplitude) of one render case."""
    import jax

    import diffwdf as dwdf
    from diffwdf.models.diode_clipper import cutoff_to_resistance, make_diode_clipper
    from diffwdf.models.tube_screamer import make_tube_screamer
    from diffwdf.roots.neural import NeuralDiodeRoot

    r_src = cutoff_to_resistance(CUTOFF_HZ, CAP)
    if name == "toms":
        root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                                  quality="best")
        ckt = make_diode_clipper(root, fs, r_source=r_src, cap=CAP)
        return ckt, {**ckt.init_params(), **root.init_params()}, "Vs", 2.0
    if name == "neural_2x16":
        root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
        ckt = make_diode_clipper(root, fs, r_source=r_src, cap=CAP)
        frag = root.init_params(jax.random.PRNGKey(0))
        return ckt, {**ckt.init_params(), **frag}, "Vs", 2.0
    # the plugin's Tube Screamer: approximate analytic diode pair
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d,
                              quality="low")
    ckt = make_tube_screamer(root, fs, drive=0.5)
    return ckt, {**ckt.init_params(), **root.init_params()}, "Vin", 0.3


def _drive(B: int, T: int, fs: float, amp: float, seed: int):
    """Sines of random pitch and phase plus a little noise, (B, T) f32."""
    rng = np.random.default_rng(seed)
    n = np.arange(T)
    f0 = rng.uniform(50.0, 2000.0, (B, 1))
    ph = rng.uniform(0.0, 2 * np.pi, (B, 1))
    x = amp * np.sin(2 * np.pi * f0 * n / fs + ph)
    return (x + 0.05 * amp * rng.standard_normal((B, T))).astype(np.float32)


def phase_render(B=8192, T=2048, fs=FS, interpret=None, reps=5, seed=0):
    """Batch rendering: fused kernel and scan engine vs the reference."""
    import jax
    import jax.numpy as jnp

    from diffwdf.device import kernel_route
    from diffwdf.ops.fused_circuit import fused_circuit_process

    route = "interpret" if interpret else kernel_route()
    results = {}
    for i, name in enumerate(("toms", "neural_2x16", "tube_screamer")):
        ckt, params, node, amp = _render_circuit(name, fs)
        vin = jnp.asarray(_drive(B, T, fs, amp, seed + i))
        s0 = ckt.init_state()
        zeros = jax.tree_util.tree_map(lambda _: jnp.zeros((B,), jnp.float32), s0)

        def scan(v, ckt=ckt, params=params, node=node, s0=s0):
            return jax.vmap(
                lambda x: ckt.process(params, s0, {node: {"v": x}})[0]
            )(v)

        fused = jax.jit(
            lambda v, ckt=ckt, params=params, node=node, zeros=zeros:
            fused_circuit_process(ckt, params, v, zeros, input_node=node,
                                  interpret=interpret)[0]
        )
        scan_jit = jax.jit(scan)
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(scan)(vin)
        out_fused = fused(vin)
        out_scan = scan_jit(vin)
        for out in (out_fused, out_scan):
            check(out.shape == (B, T), f"{name}: output shape {out.shape}")
            check(bool(jnp.all(jnp.isfinite(out))), f"{name}: non-finite")
        err = float(jnp.max(jnp.abs(out_fused - ref)))
        err_scan = float(jnp.max(jnp.abs(out_scan - ref)))
        bound = RENDER_BOUNDS[name]
        t_fused = _timed(fused, vin, reps=reps)
        t_scan = _timed(scan_jit, vin, reps=reps)
        results[name] = dict(
            kernel_err=err, bound=bound, scan_err=err_scan,
            kernel_s=t_fused, scan_s=t_scan,
        )
        report("render", circuit=name, B=B, T=T, fs=fs, route=route,
               **results[name])
        check(err <= bound, f"{name}: kernel error {err} > bound {bound}")
    return results


def _rel_err(a, b):
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(a - b)) / (jnp.max(jnp.abs(b)) + 1e-30))


def phase_training(B=1024, T=2048, epochs=3, chunk=2048, max_chunks=None,
                   seed=0, out_dir=OUT_DIR):
    """``train-clipper --synthetic`` on the scan engine (loss finite and
    falling) and one fused_generic loss+gradient vs scan BPTT."""
    import jax
    import jax.numpy as jnp

    from diffwdf import cli
    from diffwdf.models.diode_clipper import make_training_clipper
    from diffwdf.models.tube_screamer import drive_to_r6, make_tube_screamer
    from diffwdf.roots.neural import NeuralDiodeRoot
    from diffwdf.training.circuit_train import CircuitTrainConfig, make_loss_fn
    from diffwdf.training.metrics import load_jsonl

    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "train_clipper.jsonl")
    if os.path.exists(log):
        os.remove(log)
    argv = ["train-clipper", "--synthetic", "--layers", "2", "--width", "16",
            "--batch-size", str(chunk), "--epochs", str(epochs),
            "--log-every", "1", "--log", log,
            "--out", os.path.join(out_dir, "clipper_2x16.json")]
    if max_chunks:
        argv += ["--max-chunks", str(max_chunks)]
    t0 = time.perf_counter()
    cli.main(argv)
    losses = load_jsonl(log)["loss"]
    report("training", run="train-clipper --synthetic", engine="scan",
           epochs=epochs, losses=losses, seconds=time.perf_counter() - t0)
    check(len(losses) == epochs and bool(np.all(np.isfinite(losses))),
          f"train-clipper losses {losses}")
    check(losses[-1] < losses[0], f"train-clipper loss did not fall: {losses}")

    rng = np.random.default_rng(seed)
    results = {}
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    frag = root.init_params(jax.random.PRNGKey(seed))
    cases = (
        ("tube_screamer", make_tube_screamer(root, 48000.0), "R6", 0.5,
         drive_to_r6(rng.uniform(0.0, 1.0, B))),
        ("clipper", make_training_clipper(root, 48000.0), "Vs", 1.0,
         np.exp(rng.uniform(np.log(36e3), np.log(73e3), B))),
    )
    for name, ckt, pot, amp, r0 in cases:
        params = {**ckt.init_params(), **frag}
        x = _drive(B, T, 48000.0, amp, seed + 1)
        batches = {
            "x": jnp.asarray(x),
            "y": jnp.asarray(np.tanh(x)),
            "r0": jnp.asarray(r0.astype(np.float32)),
        }
        grads = {}
        with jax.default_matmul_precision("highest"):
            for engine in ("scan", "fused_generic"):
                cfg = CircuitTrainConfig(batch_size=T, engine=engine,
                                         pot_node=pot)
                f = jax.jit(jax.value_and_grad(make_loss_fn(ckt, cfg),
                                               has_aux=True))
                (loss, _), g = f(params, batches)
                grads[engine] = (float(loss), g)
        (l_s, g_s), (l_f, g_f) = grads["scan"], grads["fused_generic"]
        errs = jax.tree_util.tree_map(_rel_err, g_f, g_s)
        worst = max(jax.tree_util.tree_leaves(errs))
        loss_err = abs(l_f - l_s) / abs(l_s)
        results[name] = dict(loss=l_f, loss_rel_err=loss_err,
                             grad_rel_err=worst, bound=GRAD_RTOL)
        report("training", run="fused_generic step", circuit=name, B=B, T=T,
               pot=pot, **results[name])
        check(np.isfinite(l_f) and loss_err <= GRAD_RTOL,
              f"{name}: loss {l_f} vs scan {l_s}")
        check(worst <= GRAD_RTOL, f"{name}: gradient rel err {errs}")
    return results


def phase_serving(block=2048, n_blocks=8, fs=FS, seed=0):
    """Clipper and plugin processors: deer vs scan over ``n_blocks`` blocks
    with one model hot-swap halfway; fallbacks counted."""
    from diffwdf.runtime.stream import make_clipper_processor, make_plugin_processor

    rng = np.random.default_rng(seed)
    n = np.arange(block * n_blocks)
    results = {}
    cases = (
        ("clipper", make_clipper_processor, "clipper", ("toms", "neural_2x16"),
         2.0, {"cutoff_hz": CUTOFF_HZ}),
        ("plugin", make_plugin_processor, "tube_screamer", (0, 1), 0.3,
         {"drive": 0.5}),
    )
    for name, factory, surface, models, amp, knobs in cases:
        x = (amp * np.sin(2 * np.pi * 220.0 * n / fs)
             + 0.05 * amp * rng.standard_normal(n.size)).astype(np.float32)
        outs, procs = {}, {}
        for engine in ("scan", "deer"):
            proc = factory(fs, engine=engine)
            blocks = []
            for k in range(n_blocks):
                model = models[0] if k < n_blocks // 2 else models[1]
                blocks.append(proc.process_block(
                    x[k * block:(k + 1) * block], surface, model=model, **knobs))
            outs[engine], procs[engine] = np.concatenate(blocks), proc
        err = float(np.max(np.abs(outs["deer"] - outs["scan"])))
        fallbacks = sum(procs["deer"].fallbacks.get(m, 0)
                        for m in procs["deer"].groups[surface])
        results[name] = dict(deer_vs_scan=err, bound=SERVE_ATOL,
                             fallbacks=fallbacks, blocks=n_blocks)
        report("serving", processor=name, surface=surface, block=block,
               **results[name])
        check(bool(np.all(np.isfinite(outs["deer"]))), f"{name}: non-finite")
        check(err <= SERVE_ATOL, f"{name}: deer vs scan {err} > {SERVE_ATOL}")
    return results


def phase_artifact(block=2048, n_blocks=4, fs=FS, platforms=("cpu", "cuda"),
                   out_dir=OUT_DIR):
    """Export the Tube Screamer for ``platforms``, run the exported program,
    compare with the scan.  The file round trip (save + load) runs where
    the ``flatbuffers`` package, which serialization needs, is installed."""
    import importlib.util

    import jax.numpy as jnp

    from diffwdf.runtime.artifact import export_circuit, load_artifact, save_artifact

    ckt, params, node, amp = _render_circuit("tube_screamer", fs)
    kw = dict(input_node=node, block_len=block, fs=fs, platforms=platforms)
    arts = {"in_memory": export_circuit(ckt, params, **kw)}
    if importlib.util.find_spec("flatbuffers") is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "tube_screamer_artifact.npz")
        save_artifact(path, ckt, params, **kw)
        arts["file"] = load_artifact(path)
    x = _drive(1, block * n_blocks, fs, amp, 7)[0]
    ref, _ = ckt.process(params, ckt.init_state(), {node: {"v": jnp.asarray(x)}})
    errs = {k: float(np.max(np.abs(a.run(x) - np.asarray(ref))))
            for k, a in arts.items()}
    report("artifact", platforms=list(platforms), errs=errs, bound=1e-5,
           file_round_trip="file" in arts)
    check(max(errs.values()) <= 1e-5, f"artifact vs scan {errs}")
    return errs


def phase_four_cards(n_dev=4, seconds=10.0, fs=FS, n_inst=1024, T_sweep=2048,
                     dp_rows=256, dp_T=2048, seed=0):
    """The multi-device paths over ``n_dev`` devices, each against one."""
    import jax
    import jax.numpy as jnp

    import diffwdf as dwdf
    from diffwdf.models.diode_clipper import make_diode_clipper, make_training_clipper
    from diffwdf.parallel.data_parallel import make_dp_train_step
    from diffwdf.parallel.mesh import make_mesh
    from diffwdf.parallel.sweep import sweep_process
    from diffwdf.parallel.time_block import time_block_process, warmup_for_tolerance
    from diffwdf.roots.neural import NeuralDiodeRoot
    from diffwdf.training.circuit_train import CircuitTrainConfig, make_loss_fn

    devices = jax.devices()[:n_dev]
    check(len(devices) == n_dev, f"need {n_dev} devices, have {jax.devices()}")
    rng = np.random.default_rng(seed)
    results = {}

    # data-parallel training over (n_dev, 1), scan and fused_generic engines
    mesh = make_mesh((n_dev, 1), ("data", "time"), devices=devices)
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    ckt = make_training_clipper(root, 48000.0)
    params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(seed))}
    x = _drive(dp_rows, dp_T, 48000.0, 1.0, seed)
    batches = {
        "x": jnp.asarray(x), "y": jnp.asarray(np.tanh(x)),
        "r0": jnp.asarray(np.exp(rng.uniform(np.log(36e3), np.log(73e3),
                                             dp_rows)).astype(np.float32)),
    }
    with jax.default_matmul_precision("highest"):
        for engine in ("scan", "fused_generic"):
            cfg = CircuitTrainConfig(batch_size=dp_T, engine=engine)
            (l1, _), g1 = jax.jit(jax.value_and_grad(
                make_loss_fn(ckt, cfg), has_aux=True))(params, batches)
            opt, dp_step, _, prepare = make_dp_train_step(ckt, cfg, mesh)
            p_sh, s_sh, b_sh = prepare(params, opt.init(params), batches)
            if hasattr(dp_step, "grads_fn"):
                l_dp, _, g_dp = dp_step.grads_fn(p_sh, b_sh)
            else:  # plain-jit step: gradients of the same loss, sharded batch
                (l_dp, _), g_dp = jax.jit(jax.value_and_grad(
                    make_loss_fn(ckt, cfg), has_aux=True))(p_sh, b_sh)
            g_err = max(jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(_rel_err, g_dp, g1)))
            l_err = abs(float(l_dp) - float(l1)) / abs(float(l1))
            _, _, m = dp_step(p_sh, s_sh, b_sh)
            results[f"dp_{engine}"] = dict(loss_rel_err=l_err, grad_rel_err=g_err)
            report("four_cards", path="make_dp_train_step", engine=engine,
                   mesh=[n_dev, 1], rows=dp_rows, T=dp_T, **results[f"dp_{engine}"])
            check(np.isfinite(float(m["loss"])), f"dp {engine}: loss not finite")
            check(l_err <= 1e-5 and g_err <= 1e-4,
                  f"dp {engine}: loss err {l_err}, grad err {g_err}")

    # time-block rendering over (1, n_dev) of a long signal vs one device
    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    clip = make_diode_clipper(aroot, fs)
    ap = {**clip.init_params(), **aroot.init_params()}
    T = int(seconds * fs) // n_dev * n_dev
    v = jnp.asarray(_drive(1, T, fs, 2.0, seed + 3)[0])
    tmesh = make_mesh((1, n_dev), ("data", "time"), devices=devices)
    warm = warmup_for_tolerance(787.0, fs, tol=1e-6)  # clipper corner ~787 Hz
    par = time_block_process(clip, ap, {"Vs": {"v": v}}, tmesh, warmup=warm)
    serial, _ = jax.jit(clip.process)(ap, clip.init_state(), {"Vs": {"v": v}})
    err = float(jnp.max(jnp.abs(par - serial)))
    results["time_block"] = dict(samples=T, warmup=warm, err=err, bound=1e-5)
    report("four_cards", path="time_block_process", mesh=[1, n_dev],
           **results["time_block"])
    check(err <= 1e-5, f"time_block err {err}")

    # instance sweep sharded over the devices vs one device
    r_vals = jnp.asarray(np.linspace(1e3, 100e3, n_inst).astype(np.float32))
    vs = jnp.asarray(_drive(1, T_sweep, fs, 2.0, seed + 4)[0])
    outs = sweep_process(clip, ap, {"Vs.R": r_vals}, {"Vs": {"v": vs}},
                         mesh=mesh)
    one = sweep_process(clip, ap, {"Vs.R": r_vals}, {"Vs": {"v": vs}})
    err = float(jnp.max(jnp.abs(outs - one)))
    results["sweep"] = dict(instances=n_inst, T=T_sweep, err=err, bound=1e-6)
    report("four_cards", path="sweep_process", mesh=[n_dev, 1],
           **results["sweep"])
    check(err <= 1e-6, f"sweep err {err}")
    return results


def nvidia_smi() -> str:
    """``name, power.limit`` of the cards, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (devices: {devices})", file=sys.stderr)
        return 2
    n_need = 4 if args.four_cards else 1
    if len(devices) < n_need:
        print(f"chip_smoke: needs {n_need} GPUs, found {devices}",
              file=sys.stderr)
        return 2

    from diffwdf.device import enable_compile_cache, kernel_route

    cache = enable_compile_cache()
    print(f"devices: {devices}", flush=True)
    print(f"device_kind: {devices[0].device_kind}", flush=True)
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    route = kernel_route()
    report("device", platform=devices[0].platform,
           kind=devices[0].device_kind, count=len(devices), route=route,
           compile_cache=cache, jax=jax.__version__)
    check(route == "triton", f"kernel route on the GPU is {route!r}")

    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_render(interpret=False)
        phase_training()
        phase_serving()
        phase_artifact()
    report("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
