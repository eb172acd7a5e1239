"""Structured training metrics: JSONL log + throughput counters.

Replaces the reference's print statements + pickled history dicts
(``clipper_pot.py:233-284``) with an append-only JSONL stream (one record per
step/epoch: loss terms, samples/s, step time) that survives crashes and is
trivially plottable; histories remain loadable as dicts for the analysis
tools (see diffwdf.analysis).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, print_every: int = 0):
        self.path = path
        self.print_every = print_every
        if path and os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a") if path else None
        self._t_last = time.time()
        self.history: Dict[str, List[float]] = {}

    def log(self, step: int, samples: Optional[int] = None, **metrics):
        now = time.time()
        dt = now - self._t_last
        self._t_last = now
        rec: Dict[str, Any] = {"step": step, "step_time_s": round(dt, 6)}
        if samples:
            rec["samples_per_s"] = round(samples / max(dt, 1e-9), 1)
        for k, v in metrics.items():
            rec[k] = float(v)
            self.history.setdefault(k, []).append(float(v))
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.print_every and step % self.print_every == 0:
            msg = " ".join(f"{k}={float(v):.6g}" for k, v in metrics.items())
            print(f"[step {step}] {msg}", flush=True)
        return rec

    def close(self):
        if self._f:
            self._f.close()


def load_jsonl(path: str) -> Dict[str, List[float]]:
    """Load a JSONL metrics file into a history dict keyed by metric name."""
    hist: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if isinstance(v, (int, float)):
                    hist.setdefault(k, []).append(float(v))
    return hist
