"""Structured training-metrics logging (counterpart of
`renderih_tpu/utils/metrics_writer.py`): every record is one JSON line in
`{dir}/metrics.jsonl` (step, wall time, each scalar). Replaces the
reference's plain-text rank-0 log lines (`core/lijun_trainer.py:318-340`).
Image output (`write_image`, eval overlays) waits for in-training eval.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, out_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._file = open(self.path, "a", buffering=1)

    def write(self, step: int, metrics: dict, prefix: str = "") -> None:
        """One record; values that are not numbers are left out."""
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._file.write(json.dumps(record) + "\n")

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
