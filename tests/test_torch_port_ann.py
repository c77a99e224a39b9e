"""PyTorch port vs the JAX package: the ANN family (STTFlowNet,
STTFlowNet_4en, MultiResUNet), its modules, checkpoints, remat and entry
points, at tiny sizes on the CPU.

Every comparison feeds both packages the same seeded numpy inputs and the
same randomized float64 variables (crossed with ``from_jax``) and holds the
port to ``rtol=1e-9`` with an absolute floor of 1e-9 of the largest
reference value (sums near zero cancel). Drop-path is off wherever JAX and
torch are compared: their random streams cannot draw the same masks. The
remat step is held against the plain step port against port, drop-path on,
from one generator seed.
"""

import copy
import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.data import dsec as j_dsec
from sdformerflow_tpu.data.augmentation import center_crop as j_center_crop
from sdformerflow_tpu.models import ann_flownet as j_flownet
from sdformerflow_tpu.models import ann_layers as j_layers
from sdformerflow_tpu.models import ann_patch_embed as j_embed
from sdformerflow_tpu.models import ann_swin as j_swin
from sdformerflow_tpu.models.common import SwinConfig as JSwinConfig
from sdformerflow_tpu.ops import interpolate as j_interp
from sdformerflow_tpu.ops import normalization as j_norm
from sdformerflow_tpu.ops import pad as j_pad
from sdformerflow_tpu.ops import windows as j_windows
from sdformerflow_tpu.training import evaluate as j_evaluate
from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu.training import pretrained as j_pretrained
from sdformerflow_tpu.training import torch_interop as j_interop
from sdformerflow_tpu.training import train_step as j_train_step
from sdformerflow_tpu_torch import eval_dsec, train_dsec
from sdformerflow_tpu_torch.data import dsec
from sdformerflow_tpu_torch.models import ann_flownet, ann_layers, ann_swin
from sdformerflow_tpu_torch.models import ann_patch_embed
from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
from sdformerflow_tpu_torch.models.registry import get_model, randomize_
from sdformerflow_tpu_torch.ops import interpolate, normalization, pad
from sdformerflow_tpu_torch.ops import windows
from sdformerflow_tpu_torch.serving import FlowServer
from sdformerflow_tpu_torch.training import optim, pretrained
from sdformerflow_tpu_torch.training import torch_interop
from sdformerflow_tpu_torch.training.checkpoints import latest_epoch
from sdformerflow_tpu_torch.training.config import (build_configs, chunk_bins,
                                                    load_config)
from sdformerflow_tpu_torch.training.from_jax import from_jax
from sdformerflow_tpu_torch.training.train_step import make_train_step

from dsec_tree import BINS, CROP, FRAME, make_tree, write_config
from test_torch_port_train import EPS, OPT, jax_keeps_float64  # noqa: F401
from torch_port_harness import randomize_tree, to_torch
from torch_port_harness import one_torch_thread  # noqa: F401

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
TINY_ANN = os.path.join(CONFIGS, "test_tiny_ann.yaml")
SWIN = dict(arc_type="swinv2", patch_embed_type="PatchEmbedLocal",
            input_size=(16, 24), patch_size=(2, 2, 2), depths=(1, 1, 1),
            num_heads=(2, 2, 4), out_indices=(0, 1, 2),
            window_size=(2, 3, 3), pretrained_window_size=(0, 0, 0),
            mlp_ratio=2.0, qk_scale=None, drop_path_rate=0.0)


@pytest.fixture(autouse=True)
def float64_jax():
    """JAX arrays made from float64 numpy stay float64."""
    with jax.enable_x64(True):
        yield


def close(got, want, rtol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def rand(shape, seed, sparse=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    return x * (rng.random(shape) < 0.4) if sparse else x


def crossed(jmodule, tmodule, args, seed, rngs=None):
    """Randomized float64 JAX variables of ``jmodule`` (shaped by an
    abstract init on ``args``), loaded into ``tmodule`` too; returns the
    variables."""
    dyn = [i for i, a in enumerate(args) if isinstance(a, np.ndarray)]

    def init(*arrays):
        full = list(args)
        for i, a in zip(dyn, arrays):
            full[i] = a
        return jmodule.init(dict({"params": jax.random.PRNGKey(0)},
                                 **(rngs or {})), *full)
    shapes = jax.eval_shape(init, *(args[i] for i in dyn))
    variables = randomize_tree(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes), seed)
    tmodule.double().load_state_dict(from_jax(variables, tmodule))
    return variables


def japply(jmodule, variables, *args, train=False):
    """JAX output (and, in train mode, the mutated batch_stats), jitted
    (eager flax dispatches op by op)."""
    mutable = ["batch_stats"] if train else False
    fn = jax.jit(lambda v, *a: jmodule.apply(v, *a, mutable=mutable),
                 static_argnums=tuple(
                     i + 1 for i, a in enumerate(args)
                     if a is None or isinstance(a, bool)))
    return fn(variables, *args)


# ------------------------------------------------------------ encoding


def test_encode_input_norm_input_true_leaves_the_chunk():
    chunk = rand((2, 20, 6, 8), 1, sparse=True)
    with jax.enable_x64(True):
        want = np.asarray(j_norm.encode_input(
            jnp.asarray(chunk), polarity=False, norm_input=True))
    got = normalization.encode_input(to_torch(chunk), polarity=False,
                                     norm_input=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, chunk)


# ------------------------------------------------------------ ops


@pytest.mark.parametrize("dhw,window,shift", [
    ((2, 6, 9), (2, 3, 3), (1, 1, 1)), ((4, 9, 6), (2, 3, 3), (0, 1, 1)),
    ((2, 8, 8), (2, 8, 8), (0, 4, 4))])
def test_channels_last_windows_match_jax(dhw, window, shift):
    x = rand((2, *dhw, 5), 2)
    got = windows.window_partition(to_torch(x), window)
    want = np.asarray(j_windows.window_partition(jnp.asarray(x), window))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        windows.window_reverse(got, window, 2, *dhw).numpy(), x)
    np.testing.assert_array_equal(
        windows.compute_mask(*dhw, window, shift),
        np.asarray(j_windows.compute_mask(*dhw, window, shift)))
    np.testing.assert_array_equal(windows.relative_position_index(window),
                                  j_windows.relative_position_index(window))
    for pre in ((0, 0, 0), (2, 5, 5)):
        np.testing.assert_array_equal(
            windows.relative_coords_table(window, pre),
            j_windows.relative_coords_table(window, pre))
    y = rand((1, 3, 7, 5, 2), 3)
    got, size = windows.pad_to_windows(to_torch(y), (2, 3, 3))
    want, wsize = j_windows.pad_to_windows(jnp.asarray(y), (2, 3, 3))
    assert size == wsize
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw", [(7, 9), (8, 6)])
def test_pad_helpers_and_bilinear_match_jax(hw):
    x = rand((2, 3, *hw, 4), 4)
    crop, jcrop = (pad.CropSize(hw[1], hw[0], {"h": 4, "w": 4}),
                   j_pad.CropSize(hw[1], hw[0], {"h": 4, "w": 4}))
    padded = crop.pad(to_torch(x))
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jcrop.pad(jnp.asarray(x))))
    np.testing.assert_array_equal(crop.crop(padded).numpy(), x)
    assert pad.optimal_crop_size(13, 4, 1) == j_pad.optimal_crop_size(13, 4, 1)
    y = rand((2, 3, 10, 11, 4), 5)
    np.testing.assert_array_equal(
        pad.skip_sum(to_torch(x), to_torch(y)).numpy(),
        np.asarray(j_pad.skip_sum(jnp.asarray(x), jnp.asarray(y))))
    with jax.enable_x64(True):
        want = np.asarray(j_interp.resize_bilinear(
            jnp.asarray(x), (2 * hw[0], 2 * hw[1])))
    close(interpolate.resize_bilinear(to_torch(x), (2 * hw[0], 2 * hw[1])),
          want, rtol=1e-12)


# ------------------------------------------------------------ modules


@pytest.mark.parametrize("version", ["swinv1", "swinv2"])
@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax_f64(version, masked):
    window, dim, heads = (2, 3, 3), 8, 2
    x = rand((4, 18, dim), 6)
    mask = (windows.compute_mask(2, 6, 3, window, (1, 1, 1))
            if masked else None)
    jm = j_swin.WindowAttention3D(dim, window, heads, version=version,
                                  qk_scale=None)
    tm = ann_swin.WindowAttention3D(dim, window, heads, version=version)
    variables = crossed(jm, tm, (x, mask), seed=7)
    want, _ = japply(jm, variables, jnp.asarray(x),
                     None if mask is None else jnp.asarray(mask))
    got = tm(to_torch(x), None if mask is None else torch.from_numpy(mask))
    close(got.detach(), want)


@pytest.mark.parametrize("version", ["swinv1", "swinv2"])
def test_swin_stage_with_odd_merge_matches_jax_f64(version):
    """Two blocks (the second shifted) and a PatchMerging of an odd
    height."""
    dhw, dim = (2, 9, 6), 8
    x = rand((2, *dhw, dim), 8)
    jm = j_swin.SwinStage(dim, 2, 2, window_size=(2, 3, 3), version=version,
                          mlp_ratio=2.0)
    tm = ann_swin.SwinStage(dim, 2, 2, dhw, window_size=(2, 3, 3),
                            version=version, mlp_ratio=2.0)
    variables = crossed(jm, tm, (x, False), seed=9)
    want = japply(jm, variables, jnp.asarray(x), False)
    got = tm(to_torch(x))
    for g, w in zip(got, want):
        close(g.detach(), w)
    assert got[0].shape == (2, 2, 5, 3, 2 * dim)


def test_block_built_for_another_window_raises():
    tm = ann_swin.SwinStage(8, 1, 2, (2, 9, 9), window_size=(2, 3, 3),
                            version="swinv1").double()
    tm(torch.zeros(1, 2, 9, 9, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="window"):
        tm(torch.zeros(1, 2, 2, 2, 8, dtype=torch.float64))


def test_layernorm_keeps_float32_statistics_under_a_bf16_cast():
    """The bf16 serving cast: LayerNorm's statistics in float32, as flax
    takes them, so inputs far from 0 (bf16 spacing 4 at 1000) keep their
    normalization; the error is that of the bf16 parameters and output."""
    gen = torch.Generator().manual_seed(28)
    x = (1000 + 4 * torch.randn(8, 96, generator=gen)).bfloat16()
    ln = ann_swin.LayerNorm(96)
    randomize_(ln, gen)
    want = torch.nn.functional.layer_norm(
        x.double(), (96,), ln.weight.bfloat16().double(),
        ln.bias.bfloat16().double(), 1e-5)
    got = copy.deepcopy(ln).bfloat16()(x)
    assert got.dtype == torch.bfloat16
    assert float((got.double() - want).abs().max()) \
        <= 2 ** -8 * float(want.abs().max())


@pytest.mark.parametrize("norm", ["BN", "IN"])
@pytest.mark.parametrize("train", [False, True])
def test_residual_block_matches_jax_f64(norm, train):
    x = rand((3, 2, 6, 7, 4), 10)
    jm = j_layers.ResidualBlock(4, 1, "relu", norm)
    tm = ann_layers.ResidualBlock(4, 1, "relu", norm)
    variables = crossed(jm, tm, (x, False), seed=11)
    out = japply(jm, variables, jnp.asarray(x), train, train=train)
    tm.train(train)
    got = tm(to_torch(x)).detach()
    if train and norm == "BN":
        want, mutated = out
        new = from_jax({"params": variables["params"], **mutated}, tm)
        for k, v in new.items():
            close(tm.state_dict()[k], v)
    else:
        want = out[0] if train else out
    close(got, want)


@pytest.mark.parametrize("name", sorted(j_embed.ANN_PATCH_EMBEDS))
@pytest.mark.parametrize("train", [False, True])
def test_patch_embeds_match_jax_f64(name, train):
    T, patch = 3, (2, 2, 2)
    x = rand((T, 2, 12, 10, 2), 12, sparse=True)
    jm = j_embed.ANN_PATCH_EMBEDS[name](img_size=(12, 10), patch_size=patch,
                                        embed_dim=8)
    tm = ann_patch_embed.ANN_PATCH_EMBEDS[name](
        img_size=(12, 10), patch_size=patch, embed_dim=8, num_groups=T)
    variables = crossed(jm, tm, (x, False), seed=13)
    out = japply(jm, variables, jnp.asarray(x), train, train=train)
    want = out[0] if train else out
    got = tm.train(train)(to_torch(x)).detach()
    close(got, want)
    assert got.shape[2:4] == tm.patches_resolution


# ------------------------------------------------------------ models


def stt_pair(*, num_encoders=3, two_windows=False, **swin_over):
    sw = dict(SWIN)
    if num_encoders == 4:
        sw.update(depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
                  out_indices=(0, 1, 2, 3), input_size=(32, 32))
    sw.update(swin_over)
    kw = dict(num_bins=4, base_num_channels=8, num_encoders=num_encoders,
              norm_input=True)
    jm = j_flownet.STTFlowNet(swin=JSwinConfig(**sw), **kw)
    tm = ann_flownet.STTFlowNet(SwinConfig(**sw), **kw,
                                input_bins=8 if two_windows else 4)
    return jm, tm, (2, 8 if two_windows else 4) + tuple(sw["input_size"])


def unet_pair():
    kw = dict(num_bins=4, base_num_channels=4, num_encoders=3,
              kernel_size=5)
    return (j_flownet.MultiResUNetFlow(**kw),
            ann_flownet.MultiResUNetFlow(**kw), (2, 4, 16, 24))


MODELS = {
    "stt": lambda: stt_pair(),
    "stt_v1_two_windows": lambda: stt_pair(two_windows=True,
                                           arc_type="swinv1"),
    "stt_4en_odd": lambda: stt_pair(num_encoders=4, input_size=(15, 25)),
    "unet": unet_pair,
}


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("train", [False, True])
def test_models_match_jax_f64(name, train):
    jm, tm, shape = MODELS[name]()
    x = rand(shape, 14, sparse=True)
    variables = crossed(jm, tm, (x, False), seed=15)
    out = japply(jm, variables, jnp.asarray(x), train, train=train)
    want = out[0] if train else out
    got = tm.train(train)(to_torch(x))
    assert len(got["flow"]) == len(want["flow"])
    for g, w in zip(got["flow"], want["flow"]):
        assert g.shape == (shape[0], 2) + shape[2:]
        close(g.detach(), w)
    if train:
        new = from_jax({"params": variables["params"], **out[1]}, tm)
        for k, v in new.items():
            close(tm.state_dict()[k], v)


def test_registry_builds_the_ann_configs():
    for cfg, name in (("train_dsec_stt_voxel.yaml", "STTFlowNet"),
                      ("train_mdr_stt_voxel.yaml", "STTFlowNet_4en"),
                      ("test_tiny_ann.yaml", "STTFlowNet")):
        config = load_config(os.path.join(CONFIGS, cfg))
        model_cfg, swin, spiking = build_configs(config)
        model = get_model(config["model"]["name"], model_cfg, swin, spiking,
                          input_bins=chunk_bins(config))
        assert type(model).__name__ == "STTFlowNet"
        assert config["model"]["name"] == name
        assert model.input_bins == model.num_bins == model_cfg["num_bins"]
        attn = model.sttmultires_unet.encoders.swin3d.stage0.block0.attn
        assert attn.qk_scale is None
    unet = get_model("MultiResUNet", {"num_bins": 10}, swin, spiking)
    assert unet.num_encoders == 4
    with pytest.raises(ValueError, match="bins"):
        unet(torch.zeros(1, 5, 16, 16))


@pytest.mark.parametrize("name", ["stt", "stt_4en_odd", "unet"])
def test_from_jax_fills_every_entry_and_raises_on_strays(name):
    jm, tm, shape = MODELS[name]()
    variables = crossed(jm, tm, (rand(shape, 16), False), seed=17)
    assert set(from_jax(variables, tm)) == set(tm.state_dict())
    stats = variables.get("batch_stats", {})
    stray = {"params": dict(variables["params"], stray={"scale": 1.0}),
             "batch_stats": stats}
    with pytest.raises(KeyError, match="stray"):
        from_jax(stray, tm)
    params = dict(variables["params"])
    dropped = sorted(params)[0]
    del params[dropped]
    with pytest.raises(KeyError, match="no JAX variable"):
        from_jax({"params": params, "batch_stats": stats}, tm)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_reference_names_round_trip_through_jax():
    """The port's reference-named state_dict converts back, by JAX's own
    converter (the STT rules) and under the port's U-Net rules, to the JAX
    variables the port was loaded from; the port's loader inverts it."""
    for name, convert in (
            ("stt", lambda sd, tm: j_interop.convert_state_dict(
                sd, num_stages=3, max_depth=1, num_encoders=3,
                family="ann")),
            ("unet", lambda sd, tm: j_interop.convert_with_rules(
                sd, torch_interop.build_unet_rules(num_encoders=3)))):
        jm, tm, shape = MODELS[name]()
        variables = crossed(jm, tm, (rand(shape, 18), False), seed=19)
        ref = {k: v.numpy() for k, v in
               torch_interop.to_reference_state_dict(tm).items()}
        params, stats, unmatched = convert(ref, tm)
        assert unmatched == []
        for coll, tree in (("params", params), ("batch_stats", stats)):
            want = dict(_leaves(variables.get(coll, {})))
            got = dict(_leaves(tree))
            assert set(got) == set(want), coll
            for path, v in want.items():
                np.testing.assert_array_equal(got[path], v)
        back, unmatched = torch_interop.load_reference_state_dict(ref, tm)
        assert unmatched == []
        for k, v in tm.state_dict().items():
            assert torch.equal(back[k], v), k
    # the rules the port picks for an STTFlowNet are JAX's on every key
    tm = MODELS["stt"]()[1]
    mine = {r[0]: r for r in torch_interop.model_rules(tm)}
    theirs = {r[0]: r for r in j_interop.build_ann_rules(
        num_stages=3, max_depth=1, num_encoders=3,
        num_blocks=tm.sttmultires_unet.encoders.num_blocks)}
    keys = [k for k in torch_interop.to_reference_state_dict(tm)
            if not k.endswith("num_batches_tracked")]
    assert keys and all(mine[k] == theirs[k] for k in keys)


def test_pretrained_functions_match_jax():
    rng = np.random.default_rng(20)
    table = rng.standard_normal((15 * 15, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pretrained.geometric_regrid_bias_table(table, 23),
        j_pretrained.geometric_regrid_bias_table(table, 23))
    t3 = rng.standard_normal((3 * 5 * 5, 2))
    np.testing.assert_array_equal(
        pretrained.interpolate_rel_pos_bias_table(t3, (2, 3, 3), (2, 4, 4)),
        j_pretrained.interpolate_rel_pos_bias_table(t3, (2, 3, 3),
                                                    (2, 4, 4)))
    np.testing.assert_array_equal(
        pretrained.geometric_relative_coords((2, 3, 3), (2, 5, 5)),
        j_pretrained.geometric_relative_coords((2, 3, 3), (2, 5, 5)))
    emb = rng.standard_normal((1, 16, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pretrained.interpolate_abs_pos_embed(emb, 36),
        j_pretrained.interpolate_abs_pos_embed(emb, 36))
    pe = rng.standard_normal((1, 2, 2 * 9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        pretrained.interpolate_positional_encoding(pe, 2 * 16),
        j_pretrained.interpolate_positional_encoding(pe, 2 * 16))
    sd = {"patch_embed.proj.weight": rng.standard_normal((8, 2, 4, 4)),
          "layers.0.blocks.1.attn.relative_position_bias_table":
              rng.standard_normal((13 * 13, 2)),
          "layers.0.blocks.1.attn.relative_position_index": np.zeros(3),
          "layers.0.blocks.1.mlp.fc1.weight": rng.standard_normal((4, 2))}
    got = pretrained.inflate_swin2d_state_dict(sd, time_patch=2,
                                               window_size=(2, 5, 5))
    want = j_pretrained.inflate_swin2d_state_dict(sd, time_patch=2,
                                                  window_size=(2, 5, 5))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------ training


def _batches(shape, n, seed):
    rng = np.random.default_rng(seed)
    hw, b = shape[2:], shape[0]
    return [dict(chunk=rand(shape, seed + i, sparse=True),
                 label=3.0 * rng.standard_normal((b, 2) + hw),
                 mask=(rng.random((b, 1) + hw) > 0.2) * 1.0)
            for i in range(n)]


def test_stt_train_trajectory_matches_jax_f64(jax_keeps_float64):
    """Three AdamW steps (eps 1e-6, lr halved at the third) of a swin-v2
    STTFlowNet from one randomized float64 state: loss and grad norm to
    1e-9 relative, every parameter and BN statistic to 1e-8 absolute
    after each step."""
    jm, tm, shape = stt_pair()
    batches = _batches(shape, 3, 21)
    variables = crossed(jm, tm, (batches[0]["chunk"], False), seed=22)
    kw = dict(polarity=False, norm_input=True)
    with jax.enable_x64(True):
        as_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa
        state = j_train_step.TrainState.create(
            apply_fn=jm.apply, params=as_jax(variables["params"]),
            batch_stats=as_jax(variables["batch_stats"]),
            tx=j_optim.build_optimizer(**OPT))
        step = j_train_step.make_train_step(donate=False, **kw)
        want = []
        for b in batches:
            state, m = step(state, as_jax(b), jax.random.PRNGKey(0))
            want.append((float(m["loss"]), float(m["grad_norm"]), from_jax(
                jax.tree_util.tree_map(np.asarray, {
                    "params": state.params,
                    "batch_stats": state.batch_stats}), tm)))
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    opt = optim.build_optimizer(tm.named_parameters(), **OPT)
    opt.eps = EPS
    tstep = make_train_step(tm, opt, **kw)
    for b, (wl, wn, wsd) in zip(batches, want):
        m = tstep(jax.tree_util.tree_map(to_torch, b))
        np.testing.assert_allclose(float(m["loss"]), wl, rtol=1e-9)
        np.testing.assert_allclose(float(m["grad_norm"]), wn, rtol=1e-9)
        for k, v in tm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), wsd[k].numpy(), rtol=0,
                                       atol=1e-8, err_msg=k)
    moved = [k for k in start if not torch.equal(start[k],
                                                 tm.state_dict()[k])]
    assert any("running_var" in k for k in moved)
    assert any("logit_scale" in k for k in moved)
    assert any("cpb_fc1" in k for k in moved)
    assert int(opt.count) == 3


def _remat_run(model, batches, remat, seed, **kw):
    opt = optim.build_optimizer(model.named_parameters(), **OPT)
    gen = torch.Generator().manual_seed(seed)
    step = make_train_step(model, opt, polarity=False, norm_input=True,
                           remat=remat, generator=gen, **kw)
    losses = [float(step(jax.tree_util.tree_map(to_torch, b))["loss"])
              for b in batches]
    return losses, model.state_dict(), gen.get_state()


@pytest.mark.parametrize("policy,dtype", [
    ("dots", None), ("dots_no_batch", None), ("all", None),
    ("dots", torch.bfloat16)])
def test_remat_step_equals_the_plain_step(policy, dtype):
    """Two steps with drop-path on (rates up to 0.9) from one generator
    seed, float64 (or bf16 compute): remat gives the plain step's losses,
    parameters, BN statistics (a recompute does not update them again) and
    generator state; another seed gives other parameters, so the masks
    matter."""
    _, tm, shape = stt_pair(drop_path_rate=0.9)
    randomize_(tm.double(), torch.Generator().manual_seed(23))
    batches = _batches(shape, 2, 24)
    kw = dict(compute_dtype=dtype)
    plain = _remat_run(copy.deepcopy(tm), batches, None, 5, **kw)
    remat = _remat_run(copy.deepcopy(tm), batches, policy, 5, **kw)
    other = _remat_run(copy.deepcopy(tm), batches, None, 6, **kw)
    np.testing.assert_allclose(remat[0], plain[0], rtol=1e-12)
    assert torch.equal(remat[2], plain[2])
    for k, v in plain[1].items():
        close(remat[1][k], v, rtol=1e-12)
    assert any(not torch.allclose(other[1][k], v, rtol=1e-6)
               for k, v in plain[1].items())


def test_remat_refuses_what_it_cannot_run():
    _, tm, _ = stt_pair()
    opt = optim.build_optimizer(tm.named_parameters(), **OPT)
    with pytest.raises(ValueError, match="remat policy"):
        make_train_step(tm, opt, remat="some")
    snn = get_model("MS_SpikingformerFlowNet_en4", {"num_bins": 4,
                    "base_num_channels": 8}, SwinConfig(
                        input_size=(24, 32), depths=(1, 1, 1, 1),
                        num_heads=(2, 2, 2, 2), window_size=(2, 3, 3)),
                    SpikingConfig(num_steps=4, neuron_type="psn"))
    # every SNN of the zoo rematerializes now; a model with no block to
    # checkpoint is refused
    make_train_step(snn, optim.build_optimizer(snn.named_parameters(),
                                               **OPT), remat="dots")
    bare = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="no block"):
        make_train_step(bare, optim.build_optimizer(bare.named_parameters(),
                                                    **OPT), remat="dots")


# ------------------------------------------------------------ entry points


def ann_tree_config(root, *, num_chunks=1, batch_size=2):
    """The tiny ANN config on the DSEC tree of ``dsec_tree``; with two
    chunks, the two-window path (8 bins into a 4-bin model)."""
    cfg = load_config(TINY_ANN)
    cfg["data"].update(path=root, num_frames=BINS, num_chunks=num_chunks)
    cfg["model"]["num_bins"] = BINS
    cfg["loader"].update(batch_size=batch_size, resolution=list(FRAME),
                         crop=CROP, augment=[], augment_prob=[])
    cfg["metrics"]["name"] = ["AEE", "AAE"]
    return cfg


def test_tiny_ann_trains_resumes_and_evaluates_on_the_tree(tmp_path):
    """train_dsec (remat "dots") on the tree, --resume, then eval_dsec with
    the checkpoint and with its reference-named .pt: the same metrics."""
    tree = make_tree(str(tmp_path / "dsec"))
    path = write_config(tmp_path / "ann.yaml", ann_tree_config(tree))
    run_dir = str(tmp_path / "run")
    args = ["--config", path, "--device", "cpu", "--run_dir", run_dir]
    _, opt = train_dsec.main(args + ["--max_steps", "1"])
    assert int(opt.count) == 1
    assert latest_epoch(os.path.join(run_dir, "ckpt")) == 0
    model, opt = train_dsec.main(args + ["--resume"])
    assert int(opt.count) == 2
    assert latest_epoch(os.path.join(run_dir, "ckpt")) == 1
    ckpt_res = eval_dsec.main(["--train_config", path, "--ckpt",
                               os.path.join(run_dir, "ckpt"), "--device",
                               "cpu", "--run_dir", str(tmp_path / "e1")])
    pt = str(tmp_path / "ref.pt")
    torch.save(torch_interop.to_reference_state_dict(model), pt)
    pt_res = eval_dsec.main(["--train_config", path, "--torch_ckpt", pt,
                             "--device", "cpu", "--run_dir",
                             str(tmp_path / "e2")])
    assert ckpt_res == pt_res
    assert ckpt_res["num_samples"] == 3
    assert all(np.isfinite(ckpt_res[k]) for k in ("AEE", "PE1", "AAE"))


def test_tiny_ann_config_trains_resumes_and_evaluates_synthetic(tmp_path):
    """The shipped tiny ANN config as it is (remat "dots", flips) through
    the entry points, --synthetic on the CPU."""
    run_dir = str(tmp_path / "run")
    args = ["--config", TINY_ANN, "--synthetic", "--device", "cpu",
            "--max_steps", "2", "--run_dir", run_dir]
    _, opt = train_dsec.main(args)
    assert int(opt.count) == 2 and int(opt.notfinite_count) == 0
    _, opt = train_dsec.main(args + ["--resume"])
    assert int(opt.count) == 4
    res = eval_dsec.main(["--train_config", TINY_ANN, "--ckpt",
                          os.path.join(run_dir, "ckpt"), "--synthetic",
                          "--device", "cpu", "--run_dir",
                          str(tmp_path / "eval")])
    assert res["num_samples"] == 16 and np.isfinite(res["AEE"])


def test_two_window_evaluation_matches_jax_f64(tmp_path):
    """evaluate on the tree's doubleseq split (two chunks into the
    two-window path) against JAX's eval step and metrics, float64."""
    tree = make_tree(str(tmp_path / "dsec"))
    cfg = ann_tree_config(tree, num_chunks=2, batch_size=1)
    model_cfg, swin, spiking = build_configs(cfg)
    tm = get_model("STTFlowNet", model_cfg, swin, spiking,
                   input_bins=chunk_bins(cfg))
    assert tm.input_bins == 2 * BINS
    jm = j_flownet.STTFlowNet(
        swin=JSwinConfig(**{k: getattr(swin, k) for k in (
            "arc_type", "patch_embed_type", "input_size", "patch_size",
            "depths", "num_heads", "out_indices", "window_size",
            "pretrained_window_size", "mlp_ratio", "drop_path_rate")},
            qk_scale=None),
        num_bins=BINS, base_num_channels=32, norm_input=True)
    x = np.zeros((1, 2 * BINS) + tuple(CROP))
    variables = crossed(jm, tm, (x, False), seed=25)
    got = eval_dsec.evaluate(cfg, tm, dsec.DSECDatasetLite(cfg, "valid"),
                             device="cpu")
    step = j_train_step.make_eval_step(polarity=False, norm_input=True)
    state = j_train_step.TrainState(
        step=0, params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=(),
        apply_fn=jm.apply, tx=None)
    metrics_fn = j_evaluate.make_metrics_fn(
        metric_names=cfg["metrics"]["name"], polarity=False, norm_input=True)
    acc = j_evaluate.MetricsAccumulator()
    with jax.enable_x64(True):
        for batch in j_dsec.batch_iterator(
                j_dsec.DSECDatasetLite(cfg, "valid"), 1):
            label, mask = (jnp.asarray(batch[k], jnp.float64)
                           for k in ("label", "mask"))
            chunk, label, mask = j_center_crop(
                jnp.asarray(batch["chunk"], jnp.float64), label, mask,
                tuple(CROP))
            pred = step(state, chunk)[-1].astype(jnp.float64)
            acc.append(metrics_fn(pred, label, mask, chunk), 1)
        want = acc.results()
    assert got["num_samples"] == want["num_samples"] == 3
    for k in ("AEE", "PE1", "PE2", "PE3", "outlier", "AAE"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-9, err_msg=k)


def test_flow_server_serves_stt_voxels_and_refuses_its_events(tmp_path):
    cfg = ann_tree_config(str(tmp_path), num_chunks=2)
    with FlowServer(cfg, device="cpu", bf16=False) as server:
        server.warmup()
        flow = server.infer(rand((2 * BINS, *CROP), 26).astype(np.float32))
        assert flow.shape == (2, *CROP) and np.isfinite(flow).all()
        ev = {k: np.zeros(16, np.float32) for k in "xytp"}
        with pytest.raises(ValueError, match="num_frames"):
            server.infer(ev)
    with FlowServer(ann_tree_config(str(tmp_path)), device="cpu",
                    bf16=True) as server:
        flow = server.infer(rand((BINS, *CROP), 27).astype(np.float32))
        assert flow.dtype == np.float32 and np.isfinite(flow).all()
