"""Run logging, a mirror of ``sdformerflow_tpu/utils/logging.py``: metrics as
JSON lines under a run directory (``metrics.jsonl``), the config and other
artifacts as JSON files. The JAX package's optional MLflow mirror is not
ported. A logger built with ``enabled=False`` (every rank of a
data-parallel run but rank 0, as JAX's ``enabled=jax.process_index() ==
0``) writes nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLogger:
    def __init__(self, run_dir: str, config: Optional[dict] = None, *,
                 enabled: bool = True):
        self.run_dir, self.enabled = run_dir, enabled
        if not enabled:
            return
        os.makedirs(run_dir, exist_ok=True)
        self._metrics_f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if config is not None:
            self.log_artifact_dict("config.json", config)

    def log_metric(self, name: str, value: float, step: int):
        if not self.enabled:
            return
        rec = {"ts": time.time(), "name": name, "value": float(value),
               "step": int(step)}
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()

    def log_artifact_dict(self, name: str, payload: dict):
        if not self.enabled:
            return
        with open(os.path.join(self.run_dir, name), "w") as f:
            json.dump(payload, f, indent=2, default=str)

    def close(self):
        if self.enabled:
            self._metrics_f.close()


def count_parameters(model) -> int:
    return sum(p.numel() for p in model.parameters())


def print_parameters(model, prefix=""):
    """One line a parameter of ``model``: ``<name>: <shape> = <size>``
    (JAX ``utils/logging.py:print_parameters``, over flax's leaves)."""
    for name, p in model.named_parameters():
        print(f"{prefix}{name}: {tuple(p.shape)} = {p.numel()}")
