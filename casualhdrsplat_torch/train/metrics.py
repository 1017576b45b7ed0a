"""Metrics logging.  Counterpart of casualhdrsplat_tpu/train/metrics.py
(`MetricsLogger`, `Timer`): console + JSONL scalars (loss, PSNR,
throughput in Mpix/s).  The pose-recovery metrics and the HDR/PNG writers
are not ported yet (ROADMAP.md, queue A, "The rest of training")."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, out_dir: str, filename: str = "metrics.jsonl", echo: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a")
        self.echo = echo
        self._t0 = time.time()

    def log(self, step: int, **scalars: Any) -> None:
        rec: Dict[str, Any] = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("t",)
            )
            print(f"[{rec['t']:9.1f}s] {parts}", flush=True)

    def close(self) -> None:
        self._f.close()


class Timer:
    """Host-clock laps for the Mpix/s metric.  The caller ends the timed
    work with a device synchronisation (the trainer's per-step host read of
    its scalars is one)."""

    def __init__(self):
        self.t = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt
