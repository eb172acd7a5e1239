"""Golden ESR table for the reference's circuit-trained model zoo.

Every circuit-trained JSON under the reference's
``wdf_py/diode_clipper/models`` (the *measured-data* training outputs, not
just the synthetic-pretrained nets) is loaded into the matching training
topology (LPF clipper ``clipper_pot.py:94-127``; the ``*_hpf`` model into the
HPF topology ``HPFDiodeClipper.h:26-32``) and compared against the analytic
oracle root with the same diode configuration on a standard stimulus.

The resulting ESR-vs-analytic numbers are a REGRESSION artifact
(GOLDEN_ESR.json): they pin the JSON loader, MLP root, sign/log-R conventions
and both circuit topologies to fixed values.  Circuit-trained nets were fit
to *measurements*, so their distance from the ideal-Shockley oracle is a
characterization, not an error — intermediate checkpoints can be far away;
what matters is that the numbers never drift.

    python scripts/golden_esr_table.py [--out GOLDEN_ESR.json]
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_MODELS = "/root/reference/wdf_py/diode_clipper/models"


def eval_model(path, fs=48000.0, r_source=45e3, n_samples=4096):
    """ESR of the neural-rooted circuit vs the analytic-rooted circuit."""
    import jax.numpy as jnp
    import numpy as np

    import diffwdf as dwdf
    from diffwdf.models.diode_clipper import (
        make_diode_clipper,
        make_hpf_diode_clipper,
    )
    from diffwdf.roots.diode import ALL_1N4148, diode_1n4148_1u1d
    from diffwdf.roots.neural import NeuralDiodeRoot

    fname = os.path.basename(path)
    m = re.search(r"\((\d)U-(\d)D\)", fname)
    diode_key = f"1N4148 ({m.group(1)}U-{m.group(2)}D)" if m else None
    diode = ALL_1N4148.get(diode_key, diode_1n4148_1u1d)
    is_hpf = "_hpf" in fname

    mlp, acts, _ = dwdf.load_model_json(path)
    nroot, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    aroot = dwdf.DiodePairRoot(name="dp", diode=diode, quality="best")

    make = make_hpf_diode_clipper if is_hpf else make_diode_clipper
    kw = {"r_load": r_source} if is_hpf else {"r_source": r_source}
    ckt_n = make(nroot, fs, **kw)
    ckt_a = make(aroot, fs, **kw)
    pn = {**ckt_n.init_params(), **frag}
    pa = {**ckt_a.init_params(), **aroot.init_params()}

    n = np.arange(n_samples)
    vin = (2.0 * np.sin(2 * np.pi * 220.0 * n / fs)).astype(np.float32)
    inputs = {"Vs": {"v": jnp.asarray(vin)}}
    yn, _ = ckt_n.process(pn, ckt_n.init_state(), inputs)
    ya, _ = ckt_a.process(pa, ckt_a.init_state(), inputs)
    yn, ya = np.asarray(yn)[50:], np.asarray(ya)[50:]
    esr = float(np.sum((ya - yn) ** 2) / (np.sum(ya**2) + 1e-12))
    arch = "x".join(str(l["kernel"].shape[0]) for l in mlp["layers"][1:])
    return {
        "model": fname,
        "diode": diode.name if hasattr(diode, "name") else str(diode_key),
        "n_up": diode.N_up, "n_down": diode.N_down,
        "arch": f"{len(mlp['layers']) - 2}x{mlp['layers'][0]['kernel'].shape[1]}",
        "topology": "hpf" if is_hpf else "lpf",
        "esr_vs_analytic": esr,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="GOLDEN_ESR.json")
    ap.add_argument("--models", default=REF_MODELS)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # deterministic f32 oracle

    files = sorted(
        f for f in os.listdir(args.models)
        if f.endswith(".json") and os.path.isfile(os.path.join(args.models, f))
    )
    table = []
    for f in files:
        try:
            rec = eval_model(os.path.join(args.models, f))
        except Exception as e:  # malformed/legacy entries recorded, not fatal
            rec = {"model": f, "error": str(e)[:200]}
        table.append(rec)
        print(json.dumps(rec), flush=True)
    out = {
        "stimulus": {"fs": 48000.0, "r": 45e3, "signal": "2V 220Hz sine",
                     "n": 4096, "skip": 50, "platform": "cpu-f32"},
        "n_models": len(table),
        "table": table,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    ok = [t for t in table if "esr_vs_analytic" in t]
    print(json.dumps({"out": args.out, "evaluated": len(ok),
                      "errors": len(table) - len(ok)}))


if __name__ == "__main__":
    main()
