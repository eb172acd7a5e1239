"""Profiling/observability harness (SURVEY §5 tracing row).

The reference's observability is an AudioProcessLoadMeasurer + a
google-benchmark binary; ours is ``runtime/profiler.py``.  These tests pin
the harness contract: timing returns sane positive numbers, traces produce
on-disk artifacts, and the NaN guard actually trips on solver divergence.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from diffwdf.runtime import profiler


def test_timer_times_jitted_fn():
    f = jax.jit(lambda x: jnp.tanh(x) @ x)
    args = [(jnp.ones((64, 64)) * i,) for i in range(3)]
    r = profiler.Timer(warmup=1, iters=5).time(f, args)
    assert r["mean_s"] > 0 and r["mean_ms"] == pytest.approx(r["mean_s"] * 1e3)


def test_timer_throughput_items_per_s():
    f = jax.jit(lambda x: x * 2.0)
    r = profiler.Timer(warmup=1, iters=3).throughput(
        f, [(jnp.ones((128,)),)], items_per_call=128
    )
    assert r["items_per_s"] > 0


def test_trace_writes_artifacts(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiler.trace(log_dir) as d:
        jax.jit(lambda x: x + 1)(jnp.ones((8,))).block_until_ready()
    found = [
        os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs
    ]
    assert found, "profiler trace produced no files"


def test_nan_guard_trips_and_resets():
    bad = jax.jit(lambda x: jnp.log(x))  # log(-1) -> NaN
    profiler.enable_nan_checks(True)
    try:
        with pytest.raises(Exception):
            np.asarray(bad(jnp.float32(-1.0)))
    finally:
        profiler.enable_nan_checks(False)
    # guard off: NaN flows through silently again
    assert np.isnan(np.asarray(bad(jnp.float32(-1.0))))


def test_device_memory_stats_shape():
    stats = profiler.device_memory_stats()
    assert stats is None or isinstance(stats, dict)
