"""The reference model of a configuration file's program section, found by
the model's name: ``reference/models/<name>.py``."""

from __future__ import annotations

import importlib


def build(program: dict):
    """The plain model of ``program`` (a config in the program's schema),
    on the CPU, in float32, in eval mode."""
    name = program["model"]["name"]
    try:
        mod = importlib.import_module("portbench.reference.models." + name)
    except ModuleNotFoundError as e:
        raise KeyError(f"no plain reference for {name!r} "
                       "(portbench/reference/models/<name>.py)") from e
    return mod.build(program).eval()
