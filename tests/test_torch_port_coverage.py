"""The port's surface against the JAX package's, read from the sources
(``ast``, no import): every public top-level name (function, class,
assignment) of a JAX module that its port module lacks, and every script
of ``scripts/`` (and driver at the repository root) with no driver module
in the port, must be one of :data:`NOT_PORTED`, each with its reason. The
list mirrors ROADMAP.md's "Not ported, on purpose", plus the benchmark's
drivers, which the port's first benchmark PR takes.

A JAX module's port is the module of the same path in
``sdformerflow_tpu_torch/``, but for :data:`PORT_FILES`; a JAX name the
port holds under another name is in :data:`RENAMED`.
"""

import ast
import os

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
JAX, PORT = "sdformerflow_tpu", "sdformerflow_tpu_torch"

# JAX module -> its port modules, where the path differs
PORT_FILES = {
    "ops/pallas_attn.py": ("ops/hopper_attn.py",),
    "ops/pallas_psn.py": ("ops/hopper_psn.py",),
    "ops/pallas_embed.py": ("ops/hopper_embed.py",),
    "ops/pallas_voxel.py": ("ops/hopper_voxel.py",),
    "native/__init__.py": ("native.py",),
    "models/__init__.py": ("models/__init__.py", "models/registry.py"),
}

# (JAX module, name) -> the port's name for it, in the same port module
RENAMED = {
    ("ops/pallas_voxel.py", "voxel_grid_signed_pallas"):
        "voxel_grid_signed_k3",
    ("ops/pallas_voxel.py", "voxel_grid_polarities_pallas"):
        "voxel_grid_polarities_k3",
    ("ops/pallas_voxel.py", "events_to_voxel_grid_v2_pallas"):
        "events_to_voxel_grid_v2_k3",
    ("ops/pallas_voxel.py", "events_to_frames_pallas"): "events_to_frames_k3",
    ("data/augmentation.py", "random_crop"): "crop_at",
    ("data/augmentation.py", "random_hflip"): "hflip",
    ("data/augmentation.py", "random_vflip"): "vflip",
    ("data/augmentation.py", "random_event_drop"): "event_drop",
    ("data/augmentation.py", "rotation_flip"): "rotate_flip",
}

FUNCTIONAL = ("a form of flax's functional API (a variables tree or a "
              "TrainState): the port's module form takes an nn.Module")
TPU_BENCH = "probes the TPU's lane padding or MXU (PERF_NOTES)"
BENCHMARK = "a timing driver: the port's first benchmark PR takes it"
FLAX_INIT = "a flax initializer: the port's modules initialize as torch's"

# "<JAX module>:<name>", "<JAX module>" (a whole module) or "scripts/<file>"
NOT_PORTED = {
    # ROADMAP "Not ported, on purpose"
    "utils/cache.py": "the XLA compile cache: the kernels build into a "
                      "hash-keyed _build/",
    "utils/visualization.py:LiveViewer": "the card's host has no GUI and "
                                         "no cv2 (eval_dsec --show raises)",
    "training/pretrained.py:torch_tensor_layout_to_flax":
        "produces flax layouts, which the port does not have",
    "parallel/sharding_rules.py:constrain_data_parallel":
        "the column-parallel layers gather their channels, so the "
        "attention's input is already batch-only",
    "__graft_entry__.py": "the TPU compile-check hook (CLAUDE.md)",
    "scripts/bench_conv_band.py": TPU_BENCH,
    "scripts/bench_conv_grouped.py": TPU_BENCH,
    "scripts/bench_int8_conv.py": TPU_BENCH,
    "scripts/bench_psn_layouts.py": TPU_BENCH,
    "scripts/bench_s2d_embed.py": TPU_BENCH,
    "scripts/bench_s2d_resblocks.py": TPU_BENCH,
    "scripts/bench_s2d_preds.py": TPU_BENCH,
    # the functional API's forms, whose module forms the port has
    "training/train_step.py:TrainState": FUNCTIONAL,
    "training/train_step.py:create_train_state": FUNCTIONAL,
    "training/bn_folding.py:fold_bn_variables": FUNCTIONAL
    + " (fold_model)",
    "training/bn_folding.py:fold_model_and_variables": FUNCTIONAL
    + " (fold_model)",
    "training/s2d_embed.py:s2d_embed_variables": FUNCTIONAL
    + " (s2d_embed_state_dict)",
    "training/s2d_embed.py:s2d_model_and_variables": FUNCTIONAL,
    "training/s2d_embed.py:s2d_state": FUNCTIONAL,
    "training/optim.py:SkipNonFiniteState": "an optax state: the port's "
                                            "FlatOptimizer holds its count",
    "training/optim.py:GradNormGuardState": "an optax state: the port's "
                                            "FlatOptimizer holds its count",
    "training/optim.py:clip_and_skip_by_global_norm": "an optax wrapper: "
                                                      "FlatOptimizer.step "
                                                      "clips and skips",
    "training/optim.py:skip_nonfinite_updates": "an optax wrapper: "
                                                "FlatOptimizer.step skips",
    "parallel/sharding_rules.py:shard_params": FUNCTIONAL + " (shard_model)",
    "parallel/sharding_rules.py:shard_state": FUNCTIONAL + " (shard_model)",
    "parallel/mesh.py:batch_sharding": "a jax NamedSharding: the port's "
                                       "ranks hold their rows (shard_batch)",
    "parallel/mesh.py:replicated": "a jax NamedSharding: the port "
                                   "replicates by broadcast (replicate)",
    "parallel/multihost.py:global_batch": "assembles a jax.Array from the "
                                          "processes' rows: a rank keeps "
                                          "its rows (gather_rows where "
                                          "whole)",
    "parallel/multihost.py:replicate_global": "a jax.Array over hosts: "
                                              "broadcast_state",
    "models/common.py:kaiming_normal_fan_out": FLAX_INIT,
    "models/common.py:xavier_uniform": FLAX_INIT,
    "models/common.py:trunc_normal_02": FLAX_INIT,
    "models/common.py:zeros": FLAX_INIT,
    "models/common.py:ones": FLAX_INIT,
    "models/common.py:torch_conv_default_init": FLAX_INIT,
    "models/common.py:torch_linear_default_init": FLAX_INIT,
    "models/spiking_layers.py:conv_transpose2d": "a flax factory: "
                                                 "TorchConvTranspose",
    "ops/neurons.py:SurrogateFn": "a jax type alias",
    "ops/pallas_psn.py:BLOCK_N": "the Pallas kernel's block: csrc/psn.cu "
                                 "chooses its own",
    "ops/pallas_voxel.py:EVENT_CHUNK": "the Pallas kernel's chunk: "
                                       "csrc/voxel.cu plans its own",
    "native/__init__.py:available": "the port's packer has no fallback to "
                                    "select: a failed build raises",
    # the benchmark's drivers
    "bench.py": BENCHMARK,
    "scripts/bench_ann.py": BENCHMARK,
    "scripts/bench_breakdown.py": BENCHMARK,
    "scripts/bench_events_path.py": BENCHMARK,
    "scripts/bench_events_train.py": BENCHMARK,
    "scripts/bench_fused_attn.py": BENCHMARK,
    "scripts/bench_s2d_full.py": BENCHMARK,
    "scripts/bench_train_step.py": BENCHMARK,
    "scripts/bench_voxelize.py": BENCHMARK,
    "scripts/profile_parse.py": BENCHMARK,
    # imports both packages, so it lives beside the tests
    "scripts/convergence_ab.py": "tests/torch_port_convergence_ab.py (the "
                                 "port against JAX)",
}


def public_names(path):
    """Public top-level functions, classes and assigned names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def jax_modules():
    base = os.path.join(ROOT, JAX)
    for root, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), base)


def missing():
    """Every JAX name, module and driver without a counterpart."""
    out = set()
    for rel in jax_modules():
        ports = [os.path.join(ROOT, PORT, p)
                 for p in PORT_FILES.get(rel, (rel,))]
        if not all(os.path.exists(p) for p in ports):
            out.add(rel)
            continue
        have = set().union(*(public_names(p) for p in ports))
        for name in public_names(os.path.join(ROOT, JAX, rel)) - have:
            if RENAMED.get((rel, name)) not in have:
                out.add(f"{rel}:{name}")
    for f in sorted(os.listdir(os.path.join(ROOT, "scripts"))):
        if f.endswith(".py") and not os.path.exists(
                os.path.join(ROOT, PORT, f)):
            out.add(f"scripts/{f}")
    for f in ("bench.py", "__graft_entry__.py"):
        if os.path.exists(os.path.join(ROOT, f)):
            out.add(f)
    return out


def test_only_the_listed_names_lack_a_port():
    assert sorted(missing()) == sorted(NOT_PORTED)


def test_every_reason_is_given_and_every_rename_exists():
    assert all(isinstance(r, str) and r for r in NOT_PORTED.values())
    for (rel, _), name in RENAMED.items():
        ports = PORT_FILES.get(rel, (rel,))
        assert any(name in public_names(os.path.join(ROOT, PORT, p))
                   for p in ports), (rel, name)


def test_the_closing_modules_are_ported():
    """What the last bring-up added: no longer in the list."""
    names = missing()
    for name in ("models/spiking_layers.py:MSSepConv",
                 "models/spiking_layers.py:MSSpikingSepConvEncoderBlock",
                 "models/spiking_layers.py:MSSpikingSepTransposeDecoderLayer",
                 "models/spiking_layers.py:MSSpikingSepPredLayer",
                 "data/augmentation.py:downsample_data",
                 "utils/logging.py:print_parameters",
                 "ops/windows.py:window_partition_v2"):
        assert name not in names
