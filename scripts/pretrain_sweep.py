import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from diffwdf.roots.diode import diode_1n4148_1u1d
from diffwdf.training.pretrain import PretrainConfig, evaluate_pretrained, pretrain_diode

results = []
for (lr, sched, epochs, seed) in [
    (2e-5, "const", 2000, 1),
    (2e-5, "const", 2000, 2),
    (1e-4, "cosine", 2000, 0),
    (5e-4, "cosine", 2000, 0),
    (2e-3, "cosine", 2000, 0),
    (1e-4, "cosine", 4000, 0),
    (5e-4, "cosine", 4000, 0),
]:
    cfg = PretrainConfig(n_layers=2, layer_size=16, epochs=epochs,
                         learning_rate=lr, schedule=sched, seed=seed)
    t0 = time.time()
    params, acts, _ = pretrain_diode(diode_1n4148_1u1d, cfg)
    final = evaluate_pretrained(params, acts, diode_1n4148_1u1d, cfg)
    rec = {"lr": lr, "sched": sched, "epochs": epochs, "seed": seed,
           "mse": final["mse"], "esr": final["esr"], "s": round(time.time()-t0,1)}
    print(json.dumps(rec), flush=True)
    results.append(rec)
json.dump(results, open("runs/logs/pretrain_sweep.json","w"), indent=2)
