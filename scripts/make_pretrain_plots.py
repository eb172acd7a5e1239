"""Generate the pretraining plot artifacts (parity with the reference's
checked-in ``wdf_py/diode_clipper/plots/pretraining/*.png``): for every
model in models/pretrained/, a target-vs-prediction curve set over the R
grid and a transconductance-vs-Shockley plot.  CPU-only (analysis path).

usage: python scripts/make_pretrain_plots.py [outdir]
"""
import os, re, sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import numpy as np

from diffwdf.analysis import plot_target_pred, plot_transconductance
from diffwdf.data.synthetic import pretraining_grid
from diffwdf.nn.serialization import load_model_json
from diffwdf.roots.diode import ALL_1N4148, default_diode, diode_oa1154_1u1d
from diffwdf.roots.neural import mlp_apply

OUT = sys.argv[1] if len(sys.argv) > 1 else "runs/pretraining_plots"
os.makedirs(OUT, exist_ok=True)

for fname in sorted(os.listdir("models/pretrained")):
    if not fname.endswith(".json"):
        continue
    diode_name = fname.split("_")[0]
    # every diode family the zoo ships, not only the 1N4148s (an OA1154
    # model evaluated against the wrong physics showed a bogus 0.12 MSE)
    by_name = {**ALL_1N4148, diode_oa1154_1u1d.name: diode_oa1154_1u1d,
               default_diode.name: default_diode}
    diode = by_name.get(diode_name, default_diode)
    mlp, acts, _ = load_model_json(os.path.join("models/pretrained", fname))
    x, y = pretraining_grid(diode)
    pred = np.asarray(mlp_apply(mlp, acts, x))[:, 0]
    stem = re.sub(r"\.json$", "", fname).replace(" ", "_")
    plot_target_pred(y, pred, os.path.join(OUT, f"{stem}_fit.png"),
                     title=fname.replace("_pretrained_model.json", ""))
    plot_transconductance(mlp, acts, diode,
                          os.path.join(OUT, f"{stem}_transconductance.png"))
    err = float(np.mean((pred - y) ** 2))
    print(f"{fname}: grid MSE {err:.3e}", flush=True)
print(f"plots in {OUT}", flush=True)
