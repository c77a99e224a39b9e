"""What both drivers take from a cell: the program's config, a weightless
model to name the weights, the reckoning module, the trace's path, TF32."""

from __future__ import annotations

import contextlib
import importlib
import json
import os

import torch

from ..harness import OUT


def program_config(cell) -> dict:
    """The configuration file's ``program`` section, read by the program's
    own loader (its defaults under it), as a training or serving run of the
    program reads its YAML."""
    from sdformerflow_tpu_torch.training.config import load_config
    path = os.path.join(OUT, "configs", cell.config_name + ".yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cell.config["program"], f)   # JSON is YAML
    return load_config(path)


def chunk_bins(program: dict) -> int:
    data = program.get("data", {})
    return int(data.get("num_frames", 10)) * int(data.get("num_chunks", 1))


def skeleton(program: dict):
    """The program's model of ``program`` on the meta device: the names
    and shapes of its weights, no storage."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    model_cfg, swin, spiking = build_configs(program)
    with torch.device("meta"):
        return get_model(program["model"]["name"], model_cfg, swin, spiking,
                         input_bins=chunk_bins(program))


def reckoning(cell):
    return importlib.import_module("portbench.configs." + cell.config_name)


def trace_path(cell) -> str:
    return os.path.join(OUT, "trace", cell.workload + ".json")


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on or off inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
