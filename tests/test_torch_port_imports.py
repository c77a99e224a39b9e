"""The port imports torch and never jax: every module of
``sdformerflow_tpu_torch`` imports in a fresh interpreter with no jax, flax
or JAX-package module in ``sys.modules``, and importing starts no kernel
build (triton and nvcc are needed only when a kernel launches)."""

import subprocess
import sys
import textwrap

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import sdformerflow_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton",
                                        "sdformerflow_tpu"))
    print(len(names), bad)
""")


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 15, out
    assert out[1:] == ["[]"], out
