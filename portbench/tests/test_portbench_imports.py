"""No JAX on the chip: the harness imports neither JAX nor the JAX package,
and the plain reference imports neither, nor the program. Module names are
compared by their top-level part (before the first dot), taken whole:
``sdformerflow_tpu_torch`` begins with ``sdformerflow_tpu``."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

from portbench.harness import forbidden_modules

BENCH_DIR = os.path.join(ROOT, "portbench")
JAX = {"jax", "jaxlib", "flax", "sdformerflow_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(sub, skip=("tests",)):
    for dirpath, dirs, files in os.walk(os.path.join(BENCH_DIR, sub)):
        dirs[:] = [d for d in dirs if d not in skip and d != "_out"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_harness_imports_no_jax():
    for path in _files(""):
        assert not _imports(path) & JAX, path


def test_reference_imports_neither_jax_nor_the_program():
    banned = JAX | {"sdformerflow_tpu_torch"}
    for path in _files("reference"):
        assert not _imports(path) & banned, path


def test_whole_top_level_names():
    assert forbidden_modules(["sdformerflow_tpu_torch",
                              "sdformerflow_tpu_torch.serving",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["sdformerflow_tpu.models", "jax.numpy",
                              "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "sdformerflow_tpu"]


def test_a_run_loads_no_jax():
    """Everything a run imports, the program's modules with it, in a fresh
    interpreter: no JAX, no JAX package."""
    code = ("import portbench.run, portbench.drivers.serve, "
            "portbench.drivers.train, portbench.calibrate, portbench.sweep\n"
            "import sdformerflow_tpu_torch.serving, "
            "sdformerflow_tpu_torch.training.train_loop\n"
            "from portbench.harness import forbidden_modules\n"
            "print(forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
