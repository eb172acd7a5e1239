"""Pretrain the zoo entries the reference ships but we haven't trained yet:
the 2x8 variants of every multi-diode 1N4148 config plus the DefaultDiode
model (reference zoo inventory: wdf_py/diode_clipper/models/pretrained/ has
16 JSONs; see SURVEY.md §2.3).  The reference publishes no accuracy numbers
for these, so we record ours in PRETRAIN_RESULTS.json with mode="zoo".
"""
import json, os, sys, time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from diffwdf.nn.serialization import save_model_json
from diffwdf.roots.diode import ALL_1N4148, default_diode
from diffwdf.training.pretrain import (
    PretrainConfig,
    evaluate_pretrained,
    pretrain_diode,
)

# (diode, n_layers, width, output name)  — names mirror the reference zoo
JOBS = [
    (ALL_1N4148["1N4148 (1U-2D)"], 2, 8, "1N4148 (1U-2D)_2x8_pretrained_model.json"),
    (ALL_1N4148["1N4148 (1U-3D)"], 2, 8, "1N4148 (1U-3D)_2x8_pretrained_model.json"),
    (ALL_1N4148["1N4148 (2U-2D)"], 2, 8, "1N4148 (2U-2D)_2x8_pretrained_model.json"),
    (ALL_1N4148["1N4148 (2U-3D)"], 2, 8, "1N4148 (2U-3D)_2x8_pretrained_model.json"),
    (ALL_1N4148["1N4148 (3U-3D)"], 2, 8, "1N4148 (3U-3D)_2x8_pretrained_model.json"),
    (default_diode, 2, 16, "DefaultDiode_pretrained_model.json"),
]

results = json.load(open("PRETRAIN_RESULTS.json")) if os.path.exists("PRETRAIN_RESULTS.json") else []
results = [r for r in results if r.get("mode") != "zoo"]
os.makedirs("models/pretrained", exist_ok=True)

for diode, layers, width, name in JOBS:
    best = None
    for seed in (0, 1):
        cfg = PretrainConfig(n_layers=layers, layer_size=width, epochs=4000,
                             learning_rate=2e-3, schedule="cosine", seed=seed)
        t0 = time.time()
        params, acts, _ = pretrain_diode(diode, cfg)
        final = evaluate_pretrained(params, acts, diode, cfg)
        final.update(seed=seed, s=round(time.time() - t0, 1))
        if best is None or final["mse"] < best[0]["mse"]:
            best = (final, params, acts)
    final, params, acts = best
    rec = {"mode": "zoo", "diode": diode.name, "arch": f"{layers}x{width}", **final}
    print(json.dumps(rec), flush=True)
    results.append(rec)
    save_model_json(params, acts, os.path.join("models/pretrained", name))
    json.dump(results, open("PRETRAIN_RESULTS.json", "w"), indent=2)
print("zoo done", flush=True)
