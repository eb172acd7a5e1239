"""Multi-host initialization and scaling measurement.

The reference has no distributed backend at all (SURVEY.md §2.4); here the
multi-host story is the standard JAX one: ``jax.distributed.initialize`` on
every host, one global ``Mesh`` spanning all devices, and the same
sharding-annotated functions from ``data_parallel`` / ``time_block`` — XLA
lays the gradient all-reduces on ICI within a slice and DCN across slices.
No custom transport is needed (or built).

``measure_scaling`` provides the scaling-efficiency harness (BASELINE.json:
samples/s at 1 chip / 1 host / N hosts, efficiency = T_1 * n / T_n).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize multi-host JAX.  No-ops gracefully on a single host.

    In managed cluster environments the arguments come from the
    environment and can be omitted.
    """
    if num_processes is not None and num_processes <= 1:
        return False
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except (RuntimeError, ValueError):
        return False  # already initialized or single-process


def measure_scaling(
    make_step: Callable[[object], Callable],
    device_counts: Sequence[int],
    iters: int = 10,
    items_per_call: Optional[int] = None,
) -> Dict[int, Dict[str, float]]:
    """Run ``make_step(mesh)() -> outputs`` on meshes of increasing size and
    report throughput + efficiency vs the smallest mesh.

    make_step receives a Mesh over the first n devices and must return a
    zero-arg callable performing one (sharded) step; the workload should be
    weak-scaled (per-call items = items_per_call * n), so perfect scaling
    keeps the step time flat and efficiency = t_base / t_n.
    """
    from .mesh import make_mesh

    results: Dict[int, Dict[str, float]] = {}
    base = None
    for n in device_counts:
        if n > len(jax.devices()):
            continue
        mesh = make_mesh((n, 1), ("data", "time"), devices=jax.devices()[:n])
        step = make_step(mesh)
        # compile AND drain the warm-up execution before starting the clock,
        # else the first timed iteration queues behind it and inflates mean_s
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), step())
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        jax.tree_util.tree_map(lambda x: x.block_until_ready(), out)
        dt = (time.perf_counter() - t0) / iters
        rec = {"mean_s": dt}
        if items_per_call:
            rec["items_per_s"] = items_per_call * n / dt
        if base is None:
            base = (n, dt)
        rec["efficiency"] = base[1] / dt if dt > 0 else 0.0
        results[n] = rec
    return results
