"""Record scaling-efficiency curves to a JSON file.

Runs the DP-training and time-block weak-scaling curves from
``diffwdf.parallel.scaling_bench`` in this one process, on whatever mesh is
available: the attached GPUs with ``--virtual 0``, else an
8-virtual-device CPU mesh (the standard JAX single-host multi-device rig).

    python scripts/measure_scaling.py [--out chiprun_out/scaling.json] [--iters 5]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/scaling.json")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--virtual", type=int, default=8,
                    help="force an N-virtual-device CPU mesh (0 = use the "
                         "real attached devices)")
    args = ap.parse_args(argv)

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from diffwdf.parallel.scaling_bench import run_scaling_suite

    res = run_scaling_suite(iters=args.iters)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({
        "out": args.out,
        "n_devices": res["env"]["n_devices"],
        "dp_eff_at_max": res["dp_training"][max(res["dp_training"])]["efficiency"],
        "dp_control_eff_at_max":
            res["dp_control"][max(res["dp_control"])]["efficiency"],
        "tb_eff_at_max": res["time_block"][max(res["time_block"])]["efficiency"],
        "tb_control_eff_at_max":
            res["time_block_control"][max(res["time_block_control"])]["efficiency"],
    }))


if __name__ == "__main__":
    main()
