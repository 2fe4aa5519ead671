"""Structured training-metrics logging (counterpart of
`renderih_tpu/utils/metrics_writer.py`): every record is one JSON line in
`{dir}/metrics.jsonl` (step, wall time, each scalar). Replaces the
reference's plain-text rank-0 log lines (`core/lijun_trainer.py:318-340`).
`write_image` saves an image (the in-training eval overlays, the
reference's render-to-TensorBoard visualisation, `utils/tb_utils.py:48-111`)
as a PNG under `{dir}/vis/` (`data/image_io.py:png_bytes`, the standard
library's zlib); a failed write raises.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from renderih_tpu_torch.data.image_io import png_bytes


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

    def write_image(self, step: int, tag: str, img) -> str:
        """Save one (H, W, 3) image, uint8 or float in [0, 1], as
        `{dir}/vis/{tag}_step{step:07d}.png` ('/' in the tag becomes '_');
        returns the path."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        vis_dir = os.path.join(os.path.dirname(self.path), "vis")
        os.makedirs(vis_dir, exist_ok=True)
        path = os.path.join(vis_dir, f"{tag.replace('/', '_')}_step{int(step):07d}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(img))
        return path

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
