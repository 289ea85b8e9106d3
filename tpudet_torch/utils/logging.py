"""Metrics logging (``tpudet.utils.logging``).

The train step returns a metrics dict of device scalars; they reach the
host once per log interval, here. Sinks: stdout and ``metrics.csv`` in
``logdir``, with the JAX package's columns. The JAX package also writes
TensorBoard event files through TensorFlow; the port writes no event files,
and ``log_image`` saves each image as a ``.npy`` array instead.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None):
        self.logdir = logdir
        self._csv_path = None
        self._csv_fields: list = []
        self._csv_rows: list = []
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._csv_path = os.path.join(logdir, "metrics.csv")
            # Resume: absorb an existing file, so that a changed column set
            # rewrites it cleanly instead of appending misaligned rows.
            if os.path.exists(self._csv_path):
                with open(self._csv_path, newline="") as f:
                    reader = csv.DictReader(f)
                    self._csv_rows = [dict(r) for r in reader]
                    self._csv_fields = list(reader.fieldnames or [])
        self._last: Dict[str, tuple] = {}  # prefix -> (step, time)

    def _write_csv(self, row: Dict[str, object]) -> None:
        """Append a row; a new key extends the header and rewrites the
        file (``steps_per_sec`` appears on the second call, ``eval/``
        columns at the first eval)."""
        new = [k for k in row if k not in self._csv_fields]
        self._csv_rows.append(row)
        if new:
            fields = set(self._csv_fields) | set(row)
            self._csv_fields = ((["step"] if "step" in fields else [])
                                + sorted(fields - {"step"}))
            with open(self._csv_path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._csv_fields, restval="")
                w.writeheader()
                w.writerows(self._csv_rows)
        else:
            with open(self._csv_path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._csv_fields,
                               restval="").writerow(row)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "train"):
        metrics = {k: float(v) for k, v in metrics.items()}
        now = time.time()
        last = self._last.get(prefix)
        if last is not None and step > last[0]:
            dt = (now - last[1]) / (step - last[0])
            metrics["steps_per_sec"] = 1.0 / dt if dt > 0 else 0.0
        self._last[prefix] = (step, now)
        parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(metrics.items()))
        print(f"[{prefix} step {step}] {parts}", flush=True)
        if self._csv_path:
            # Other prefixes get prefixed columns, so that an eval row is
            # told from a train row of the same step.
            key = (lambda k: k) if prefix == "train" else (
                lambda k: f"{prefix}/{k}")
            self._write_csv({"step": step,
                             **{key(k): v for k, v in metrics.items()}})

    def log_image(self, step: int, name: str, image) -> None:
        """``image`` [h, w, 3] uint8 -> ``logdir/images/{name}_{step}.npy``
        (``/`` in ``name`` becomes ``_``)."""
        if not self.logdir:
            return
        folder = os.path.join(self.logdir, "images")
        os.makedirs(folder, exist_ok=True)
        np.save(os.path.join(folder, f"{name.replace('/', '_')}_{step}.npy"),
                np.asarray(image))

    def close(self):
        pass  # CSV rows are written as they come
