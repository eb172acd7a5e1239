import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from diffwdf.roots.diode import diode_1n4148_1u1d
from diffwdf.training.pretrain import PretrainConfig, evaluate_pretrained, pretrain_diode

results = []
for (lr, bs, epochs, seed) in [
    (2e-3, 32, 6000, 0),
    (2e-3, 64, 6000, 0),
    (4e-3, 128, 8000, 0),
    (2e-3, 32, 2000, 1),
    (2e-3, 32, 2000, 2),
    (1e-3, 32, 6000, 0),
]:
    cfg = PretrainConfig(n_layers=2, layer_size=16, epochs=epochs, batch_size=bs,
                         learning_rate=lr, schedule="cosine", seed=seed)
    t0 = time.time()
    params, acts, _ = pretrain_diode(diode_1n4148_1u1d, cfg)
    final = evaluate_pretrained(params, acts, diode_1n4148_1u1d, cfg)
    rec = {"lr": lr, "bs": bs, "epochs": epochs, "seed": seed,
           "mse": final["mse"], "esr": final["esr"], "s": round(time.time()-t0,1)}
    print(json.dumps(rec), flush=True)
    results.append(rec)
json.dump(results, open("runs/logs/pretrain_sweep2.json","w"), indent=2)
