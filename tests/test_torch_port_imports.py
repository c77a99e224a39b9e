"""The port imports torch and never jax: every module of
``sdformerflow_tpu_torch`` imports in a fresh interpreter with no jax, flax
or JAX-package module in ``sys.modules``, and none of cv2, h5py, pandas or
PyTables, which the card's host lacks; importing starts no kernel build
(nvcc and g++ are needed only when a kernel or the event packer is first
called). The SNN zoo's registry names (with a recurrent neuron and a
non-BN norm) build and run a forward there, importing no JAX either. The
ranks of a data-parallel group (two processes over gloo) import every
module and run a batch-statistics norm in the group, importing no JAX."""

import subprocess
import sys
import textwrap

import torch

import torch_port_dp_ranks as R

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import sdformerflow_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import torch
    from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu_torch.models.registry import get_model
    swin = SwinConfig(input_size=(16, 16), depths=(1, 1, 1),
                      num_heads=(2, 2, 2), out_indices=(0, 1, 2),
                      window_size=(2, 2, 2),
                      patch_embed_type="Spiking_PatchEmbed_Conv_sfn")
    cfg = SpikingConfig(num_steps=4, neuron_type="glif", spike_norm="GN")
    for zoo in ("SpikingformerFlowNet", "MS_SpikingformerFlowNet",
                "SpikingMultiResUNet"):
        get_model(zoo, {"num_bins": 4, "base_num_channels": 16}, swin,
                  cfg)(torch.rand(1, 4, 2, 16, 16))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "triton",
                                        "sdformerflow_tpu"))
    from sdformerflow_tpu_torch import kernel_build, native
    from sdformerflow_tpu_torch.ops import (hopper_attn, hopper_embed,
                                            hopper_psn, hopper_voxel)
    built = sum(f.cache_info().currsize for f in (
        kernel_build.load_cuda_library, kernel_build.load_host_library,
        native._lib, hopper_attn._kernel_fn, hopper_voxel._lib,
        hopper_psn._lib, hopper_embed._conv_fn))
    host = sorted(m for m in sys.modules
                  if m.split(".")[0] in ("cv2", "h5py", "pandas", "tables"))
    print(len(names), built, bad, host, " ".join(names))
""")


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 70, out
    # nothing built, nothing of jax, none of cv2 / h5py / pandas / tables
    assert out[1:4] == ["0", "[]", "[]"], out
    for name in ("native", "ops.voxel", "ops.hopper_voxel", "serving",
                 "training.train_step", "training.optim",
                 "training.train_loop", "training.checkpoints", "losses",
                 "data.dsec", "data.augmentation", "utils.logging",
                 "train_dsec", "ops.hopper_embed", "ops.s2d",
                 "training.s2d_embed", "training.evaluate",
                 "training.torch_interop", "utils.visualization",
                 "eval_dsec", "data.hdf5", "data.loader_utils", "data.mdr",
                 "data.mvsec", "data.adapters", "train_mdr", "eval_mvsec",
                 "training.export", "export_model", "serve", "flow_client",
                 "bench_serving", "training.bn_folding", "parallel",
                 "parallel.mesh", "ops.neurons", "ops.surrogate",
                 "models.spiking_layers", "models.spiking_swin",
                 "models.spiking_patch_embed", "models.snn_flownet",
                 "models.registry", "training.from_jax", "utils.flops",
                 "utils.energy", "utils.gradients", "energy_sensitivity",
                 "parallel.multihost", "preprocess_dsec", "encode_mvsec",
                 "parallel.sharding_rules", "training.remat"):
        assert f"sdformerflow_tpu_torch.{name}" in out[4:], name


def test_data_parallel_ranks_import_no_jax(tmp_path):
    procs = R.spawn("import_probe", 2, str(tmp_path))
    ranks = R.join(procs, str(tmp_path), timeout=120)
    assert [r["foreign_modules"] for r in ranks] == [[], []]
    assert ranks[0]["modules"] >= 68
    # the ranks' rows (offset by the rank) make one batch: equal statistics
    assert torch.equal(ranks[0]["running_mean"], ranks[1]["running_mean"])
    want = 0.1 * (torch.arange(12.0).reshape(4, 3).mean(0) + 0.5)
    torch.testing.assert_close(ranks[0]["running_mean"], want)
    assert [r["mean_of_ranks"] for r in ranks] == [0.5, 0.5]
    assert all(torch.equal(r["broadcast"], torch.ones(3)) for r in ranks)
