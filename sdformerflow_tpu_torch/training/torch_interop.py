"""Checkpoints under the reference's state_dict names -> the port, and
back: the port's own copy of the rules of
``sdformerflow_tpu/training/torch_interop.py``, for the SNN
(``SpikingformerFlowNet``, ``MS_SpikingformerFlowNet*``), the spiking
U-Net (``SpikingMultiResUNet``), the ANN STTFlowNet family and the ANN
MultiResUNet; the family is chosen from the model.

A rule maps a reference key (the module tree of
``MS_SpikingformerFlowNet*``) to a flax variable path and a layout:

- Conv2d weight OIHW -> HWIO; ConvTranspose2d (I, O, kh, kw) ->
  (kh, kw, I, O); Linear [out, in] -> [in, out]; the STT projections, 1x1
  convs [O, I, 1, 1] in the reference, -> Dense [I, O];
- BatchNorm weight/bias -> scale/bias (params), running_mean/var ->
  mean/var (batch_stats);
- LayerNorm weight/bias -> scale/bias;
- PSN ``spiking_neuron.weight``/``bias``, PLIF ``w``, positional encodings,
  relative-position-bias tables and ``logit_scale`` pass through.

``convert_state_dict`` gives the flax tree, which ``from_jax`` turns into
the port's state_dict (whose module tree has the flax names);
``load_reference_state_dict`` composes the two. The port keeps the
reference's layouts (``from_jax`` undoes each rule's transform) but for
the STT projections (Linear [O, I] for the reference's [O, I, 1, 1]), so
``to_reference_state_dict``, the inverse, renames and restores those.

The ANN rules cover the ``PatchEmbedLocal`` embed, as JAX's do. The GLIF
fields map one to one onto the port's ``sn.glif.<field>`` entries (JAX
packs them into its ``GLIFParams`` leaf). As in JAX, the rules name BN
sites only: the GN / IN / LN (``GroupNorm_0``), BN_notrack and BNTT
entries of a model with such a ``spike_norm`` have no reference name.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.ann_flownet import MultiResUNetFlow, STTFlowNet
from ..models.ann_layers import InstanceNorm
from ..models.snn_flownet import SpikingMultiResUNetFlow
from ..models.spiking_layers import (Conv2d, GroupNorm, TorchBatchNorm,
                                     TorchConvTranspose)
from .from_jax import from_jax

_TRANSFORMS = {
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "deconv": lambda a: a.transpose(2, 3, 0, 1),
    "linear": lambda a: a.T,
    "conv1x1": lambda a: a[..., 0, 0].T,   # [O, I, 1, 1] -> [I, O]
    "id": lambda a: a,
}


def _norm_rule(torch_prefix: str, flax_prefix: str, direct: bool = False):
    """BN rules: SpikingNormLayer wraps BatchNorm2d under .norm_layer;
    'direct' norms (nn.BatchNorm2d used directly) have no extra nesting.
    The flax SpikingNorm names its BatchNorm 'BatchNorm_0'."""
    t = torch_prefix + (".{}" if direct else ".norm_layer.{}")
    f = flax_prefix if direct else flax_prefix + "/BatchNorm_0"
    return [
        (t.format("weight"), "params", f + "/scale", "id"),
        (t.format("bias"), "params", f + "/bias", "id"),
        (t.format("running_mean"), "batch_stats", f + "/mean", "id"),
        (t.format("running_var"), "batch_stats", f + "/var", "id"),
    ]


_GLIF_FIELDS = ("alpha", "beta", "gamma", "tau", "v_threshold",
                "linear_decay", "v_subreset", "conduct")


def _neuron_rules(torch_prefix, flax_prefix):
    rules = [
        (torch_prefix + ".spiking_neuron.weight", "params",
         flax_prefix + "/weight", "id"),   # PSN
        (torch_prefix + ".spiking_neuron.bias", "params",
         flax_prefix + "/bias", "id"),     # PSN
        (torch_prefix + ".spiking_neuron.w", "params",
         flax_prefix + "/w", "id"),        # PLIF
    ]
    for fld in _GLIF_FIELDS:               # GLIF
        rules.append((f"{torch_prefix}.spiking_neuron.{fld}", "params",
                      f"{flax_prefix}/glif/{fld}", "id"))
    return rules


def _conv_block_rules(t, f, *, has_sn=True, deconv=False, norm_direct=False,
                      deconv_kind="deconv"):
    """SpikingConv{Encoder,Decoder,...}Layer: Sequential conv + SpikingNorm
    + neuron; a decoder's ``deconv`` has the layout ``deconv_kind``."""
    kind = deconv_kind if deconv else "conv"
    tconv = f"{t}.{'deconv' if deconv else 'conv'}.0"
    fconv = f"{f}/{'deconv' if deconv else 'conv'}"
    rules = [
        (tconv + ".weight", "params", fconv + "/kernel", kind),
        (tconv + ".bias", "params", fconv + "/bias", "id"),
    ]
    rules += _norm_rule(f"{t}.norm_layer", f"{f}/norm", direct=norm_direct)
    if has_sn:
        rules += _neuron_rules(f"{t}.sn", f"{f}/sn")
    return rules


def _resblock_rules(t, f):
    rules = []
    for c in ("conv1", "conv2"):
        rules += [(f"{t}.{c}.0.weight", "params", f"{f}/{c}/kernel", "conv"),
                  (f"{t}.{c}.0.bias", "params", f"{f}/{c}/bias", "id")]
    for n in ("norm1", "norm2"):
        rules += _norm_rule(f"{t}.{n}", f"{f}/{n}")
    for s in ("sn1", "sn2"):
        rules += _neuron_rules(f"{t}.{s}", f"{f}/{s}")
    return rules


def build_rules(num_stages=4, max_depth=8, num_res=2, num_encoders=4,
                pe_res=2, use_upsample_conv=False) -> list:
    """The rule list of the SpikingformerFlowNet family (SEW and MS, every
    patch embed's names): (reference key, collection, flax path,
    transform). ``use_upsample_conv``: the decoders' ``deconv`` is a
    regular conv (bilinear resize + conv), not a transposed one."""
    R = []
    root_t = "sttmultires_unet"
    root_f = "sttmultires_unet"

    # ---- patch embed (MS_PED_Spiking_PatchEmbed_Conv_sfn)
    pe_t = f"{root_t}.encoders.swin3d.patch_embed"
    pe_f = f"{root_f}/encoders/patch_embed"
    R += _conv_block_rules(f"{pe_t}.head", f"{pe_f}/head")
    R += _conv_block_rules(f"{pe_t}.conv", f"{pe_f}/conv", has_sn=False)
    # SEW embeds have a trailing sn on the stride-2 conv; MS_PED's has none
    R += _neuron_rules(f"{pe_t}.conv.sn", f"{pe_f}/conv/sn")
    for r in range(pe_res):
        R += _resblock_rules(f"{pe_t}.residual_encoding.resblocks.{r}",
                             f"{pe_f}/residual_encoding/res{r}")
    # PED projection (direct nn.Conv2d / nn.BatchNorm2d)
    R += [(f"{pe_t}.proj.conv_res.weight", "params",
           f"{pe_f}/proj/conv_res/kernel", "conv"),
          (f"{pe_t}.proj.conv.weight", "params",
           f"{pe_f}/proj/conv/kernel", "conv")]
    R += _norm_rule(f"{pe_t}.proj.norm_layer", f"{pe_f}/proj/norm",
                    direct=True)
    R += _neuron_rules(f"{pe_t}.proj.sn", f"{pe_f}/proj/sn")

    # ---- swin stages
    for i in range(num_stages):
        st_t = f"{root_t}.encoders.swin3d.layers.{i}"
        st_f = f"{root_f}/encoders/stage{i}"
        for j in range(max_depth):
            b_t = f"{st_t}.swin_blocks.{j}"
            b_f = f"{st_f}/block{j}"
            a_t, a_f = f"{b_t}.attn", f"{b_f}/attn"
            R += [(f"{a_t}.positional_encoding", "params",
                   f"{a_f}/k/positional_encoding", "id"),
                  (f"{a_t}.relative_position_bias_table", "params",
                   f"{a_f}/relative_position_bias_table", "id"),
                  (f"{a_t}.linear_q.weight", "params",
                   f"{a_f}/q/linear/kernel", "linear"),
                  (f"{a_t}.linear_k.weight", "params",
                   f"{a_f}/k/linear/kernel", "linear"),
                  (f"{a_t}.linear_v.weight", "params",
                   f"{a_f}/v/linear/kernel", "linear"),
                  (f"{a_t}.proj.weight", "params",
                   f"{a_f}/proj/kernel", "linear"),
                  (f"{a_t}.proj.bias", "params", f"{a_f}/proj/bias", "id")]
            for qkv in ("q", "k", "v"):
                R += _norm_rule(f"{a_t}.bn_{qkv}", f"{a_f}/{qkv}/bn")
                R += _neuron_rules(f"{a_t}.sn_{qkv}", f"{a_f}/{qkv}/sn")
            R += _norm_rule(f"{a_t}.proj_bn", f"{a_f}/proj_bn")
            for s in ("sn2_q", "attn_sn", "proj_sn"):
                R += _neuron_rules(f"{a_t}.{s}", f"{a_f}/{s}")
            # swinv2 (Hamming) attention: logit_scale + cpb MLP
            R += [(f"{a_t}.logit_scale", "params", f"{a_f}/logit_scale",
                   "id"),
                  (f"{a_t}.cpb_mlp.0.weight", "params",
                   f"{a_f}/cpb_fc1/kernel", "linear"),
                  (f"{a_t}.cpb_mlp.0.bias", "params", f"{a_f}/cpb_fc1/bias",
                   "id"),
                  (f"{a_t}.cpb_mlp.2.weight", "params",
                   f"{a_f}/cpb_fc2/kernel", "linear")]
            m_t, m_f = f"{b_t}.mlp", f"{b_f}/mlp"
            R += [(f"{m_t}.fc1.weight", "params", f"{m_f}/fc1/kernel",
                   "linear"),
                  (f"{m_t}.fc2.weight", "params", f"{m_f}/fc2/kernel",
                   "linear")]
            R += _norm_rule(f"{m_t}.bn1", f"{m_f}/bn1")
            R += _norm_rule(f"{m_t}.bn2", f"{m_f}/bn2")
            R += _neuron_rules(f"{m_t}.sn1", f"{m_f}/sn1")
            R += _neuron_rules(f"{m_t}.sn2", f"{m_f}/sn2")
        # patch merging
        R += [(f"{st_t}.downsample.reduction.weight", "params",
               f"{st_f}/downsample/reduction/kernel", "linear")]
        R += _norm_rule(f"{st_t}.downsample.norm", f"{st_f}/downsample/norm")
        R += _neuron_rules(f"{st_t}.downsample.sn", f"{st_f}/downsample/sn")

    # ---- bottleneck resblocks + decoders + preds
    for i in range(num_res):
        R += _resblock_rules(f"{root_t}.resblocks.{i}",
                             f"{root_f}/resblock{i}")
    for i in range(num_encoders):
        R += _conv_block_rules(f"{root_t}.decoders.{i}",
                               f"{root_f}/decoder{i}", deconv=True,
                               deconv_kind="conv" if use_upsample_conv
                               else "deconv")
        R += _neuron_rules(f"{root_t}.preds.{i}.sn", f"{root_f}/pred{i}/sn")
        R += [(f"{root_t}.preds.{i}.conv.0.weight", "params",
               f"{root_f}/pred{i}/conv/kernel", "conv"),
              (f"{root_t}.preds.{i}.conv.0.bias", "params",
               f"{root_f}/pred{i}/conv/bias", "id")]
    return R


def _layernorm_rule(t, f):
    return [(f"{t}.weight", "params", f"{f}/scale", "id"),
            (f"{t}.bias", "params", f"{f}/bias", "id")]


def _ann_norm_rule(t, f):
    """A BatchNorm2d attribute of an ANN layer (torch) -> its Norm2d's
    TorchBatchNorm (flax, auto-named ``BatchNorm_0``)."""
    return _norm_rule(t, f"{f}/BatchNorm_0", direct=True)


def _ann_conv_rule(t, f, kind="conv"):
    return [(f"{t}.weight", "params", f"{f}/kernel", kind),
            (f"{t}.bias", "params", f"{f}/bias", "id")]


def _ann_resblock_rule(t, f):
    R = _ann_conv_rule(f"{t}.conv1", f"{f}/conv1") \
        + _ann_conv_rule(f"{t}.conv2", f"{f}/conv2")
    for n in ("bn1", "bn2"):
        R += _ann_norm_rule(f"{t}.{n}", f"{f}/{n}")
    return R


def _ann_decoder_rules(root_t, root_f, num_encoders, num_res=2):
    """Bottleneck resblocks, decoders (upsample conv or transposed conv,
    with their BN) and prediction heads of the ANN U-Nets."""
    R = []
    for i in range(num_res):
        R += _ann_resblock_rule(f"{root_t}resblocks.{i}",
                                f"{root_f}resblock{i}")
    for i in range(num_encoders):
        t, f = f"{root_t}decoders.{i}", f"{root_f}decoder{i}"
        R += _ann_conv_rule(f"{t}.conv2d", f"{f}/conv2d")
        R += _ann_conv_rule(f"{t}.transposed_conv2d",
                            f"{f}/transposed_conv2d", "deconv")
        R += _ann_norm_rule(f"{t}.norm_layer", f"{f}/norm_layer")
        R += _ann_conv_rule(f"{root_t}preds.{i}.conv2d",
                            f"{root_f}pred{i}/conv2d")
    return R


def build_ann_rules(num_stages=3, max_depth=8, num_encoders=3,
                    num_blocks=2) -> list:
    """The rule list of the ANN STTFlowNet family (the reference's
    ``STSwinNet.py`` module tree)."""
    R = []
    root_t = root_f = "sttmultires_unet"
    sw_t = f"{root_t}.encoders.swin3d"
    sw_f = f"{root_f}/encoders/swin3d"
    pe_t, pe_f = f"{sw_t}.patch_embed", f"{sw_f}/patch_embed"
    R += _ann_conv_rule(f"{pe_t}.head", f"{pe_f}/head")
    R += _ann_conv_rule(f"{pe_t}.proj", f"{pe_f}/proj")
    for r in range(1, 5):
        R += _ann_resblock_rule(f"{pe_t}.residual_encoding.resblock{r}",
                                f"{pe_f}/residual_encoding/resblock{r}")
    for i in range(num_stages):
        st_t, st_f = f"{sw_t}.layers.{i}", f"{sw_f}/stage{i}"
        for j in range(max_depth):
            b_t, b_f = f"{st_t}.swin_blocks.{j}", f"{st_f}/block{j}"
            R += _layernorm_rule(f"{b_t}.norm1", f"{b_f}/norm1")
            R += _layernorm_rule(f"{b_t}.norm2", f"{b_f}/norm2")
            a_t, a_f = f"{b_t}.attn", f"{b_f}/attn"
            R += [(f"{a_t}.qkv.weight", "params", f"{a_f}/qkv/kernel",
                   "linear"),
                  (f"{a_t}.qkv.bias", "params", f"{a_f}/qkv/bias", "id"),
                  (f"{a_t}.proj.weight", "params", f"{a_f}/proj/kernel",
                   "linear"),
                  (f"{a_t}.proj.bias", "params", f"{a_f}/proj/bias", "id"),
                  (f"{a_t}.relative_position_bias_table", "params",
                   f"{a_f}/relative_position_bias_table", "id"),
                  (f"{a_t}.logit_scale", "params", f"{a_f}/logit_scale",
                   "id"),
                  (f"{a_t}.cpb_mlp.0.weight", "params",
                   f"{a_f}/cpb_fc1/kernel", "linear"),
                  (f"{a_t}.cpb_mlp.0.bias", "params", f"{a_f}/cpb_fc1/bias",
                   "id"),
                  (f"{a_t}.cpb_mlp.2.weight", "params",
                   f"{a_f}/cpb_fc2/kernel", "linear")]
            for fc in ("fc1", "fc2"):
                R += [(f"{b_t}.mlp.{fc}.weight", "params",
                       f"{b_f}/mlp/{fc}/kernel", "linear"),
                      (f"{b_t}.mlp.{fc}.bias", "params",
                       f"{b_f}/mlp/{fc}/bias", "id")]
        R += _layernorm_rule(f"{st_t}.downsample.norm",
                             f"{st_f}/downsample/norm")
        R += [(f"{st_t}.downsample.reduction.weight", "params",
               f"{st_f}/downsample/reduction/kernel", "linear")]
        R += _layernorm_rule(f"{sw_t}.norm{i}", f"{sw_f}/norm{i}")
    for i in range(num_stages):
        for k in range(num_blocks):
            R += [(f"{root_t}.encoders.projections.{i}.{k}.weight", "params",
                   f"{root_f}/encoders/proj{i}_{k}/kernel", "conv1x1"),
                  (f"{root_t}.encoders.projections.{i}.{k}.bias", "params",
                   f"{root_f}/encoders/proj{i}_{k}/bias", "id")]
    return R + _ann_decoder_rules(f"{root_t}.", f"{root_f}/", num_encoders)


def build_unet_rules(num_encoders=4, num_res=2) -> list:
    """The rule list of the ANN MultiResUNet: ``encoders.{i}``,
    ``resblocks.{i}``, ``decoders.{i}``, ``preds.{i}`` -> ``encoder{i}``,
    ``resblock{i}``, ``decoder{i}``, ``pred{i}``. The torch names are
    derived from the flax tree in the pattern of the STT rules; no
    reference MultiResUNet state_dict has been checked against them."""
    R = []
    for i in range(num_encoders):
        R += _ann_conv_rule(f"encoders.{i}.conv2d", f"encoder{i}/conv2d")
        R += _ann_norm_rule(f"encoders.{i}.norm_layer",
                            f"encoder{i}/norm_layer")
    return R + _ann_decoder_rules("", "", num_encoders, num_res)


def build_snn_unet_rules(num_encoders=4, num_res=2,
                         use_upsample_conv=True) -> list:
    """The rule list of the spiking U-Net (``SpikingMultiResUNet``, JAX
    ``build_unet_rules``): ``encoders.{i}``, ``resblocks.{i}``,
    ``decoders.{i}``, ``preds.{i}`` -> ``encoder{i}``, ``resblock{i}``,
    ``decoder{i}``, ``pred{i}``. The upsample decoder's ``deconv`` is a
    regular conv; only the transpose decoder holds a transposed kernel."""
    R = []
    for i in range(num_encoders):
        R += _conv_block_rules(f"encoders.{i}", f"encoder{i}")
    for i in range(num_res):
        R += _resblock_rules(f"resblocks.{i}", f"resblock{i}")
    kind = "conv" if use_upsample_conv else "deconv"
    for i in range(num_encoders):
        t, f = f"decoders.{i}", f"decoder{i}"
        R += [(f"{t}.deconv.0.weight", "params", f"{f}/deconv/kernel", kind),
              (f"{t}.deconv.0.bias", "params", f"{f}/deconv/bias", "id")]
        R += _norm_rule(f"{t}.norm_layer", f"{f}/norm")
        R += _neuron_rules(f"{t}.sn", f"{f}/sn")
    for i in range(num_encoders):
        t, f = f"preds.{i}", f"pred{i}"
        R += [(f"{t}.conv.0.weight", "params", f"{f}/conv/kernel", "conv"),
              (f"{t}.conv.0.bias", "params", f"{f}/conv/bias", "id")]
        R += _neuron_rules(f"{t}.sn", f"{f}/sn")
    return R


def convert_with_rules(state_dict: Dict[str, np.ndarray],
                       rules) -> Tuple[dict, dict, list]:
    """Reference state_dict -> (params, batch_stats, unmatched keys) under
    a rule list: the ``module.`` prefix of DataParallel checkpoints
    stripped, ``num_batches_tracked`` and the membrane state
    ``.spiking_neuron.v`` skipped."""
    rules = {t: (coll, path, tr) for t, coll, path, tr in rules}
    params: dict = {}
    batch_stats: dict = {}
    unmatched = []
    for key, val in state_dict.items():
        key = re.sub(r"^module\.", "", key)
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith(".spiking_neuron.v"):
            continue  # membrane state buffer (reset to 0), not a parameter
        if key not in rules:
            unmatched.append(key)
            continue
        coll, path, tr = rules[key]
        node = params if coll == "params" else batch_stats
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _TRANSFORMS[tr](np.asarray(val))
    return params, batch_stats, unmatched


def convert_state_dict(state_dict: Dict[str, np.ndarray], num_stages=4,
                       max_depth=8, num_encoders=4) -> Tuple[dict, dict, list]:
    """Reference SNN state_dict -> (params, batch_stats, unmatched keys)."""
    return convert_with_rules(state_dict, build_rules(
        num_stages=num_stages, max_depth=max_depth,
        num_encoders=num_encoders))


def flax_to_torch_key(coll: str, path: str, num_stages=4, max_depth=8,
                      num_encoders=4):
    """(reference key, transform) of a flax variable path, or (None, None)."""
    for t, c, f, tr in build_rules(num_stages=num_stages, max_depth=max_depth,
                                   num_encoders=num_encoders):
        if c == coll and f == path:
            return t, tr
    return None, None


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pt``/``.pth`` -> {key: numpy array}: a state_dict, a
    dict holding one under ``state_dict``, or a whole pickled model (which
    needs the reference's classes to unpickle)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        raise RuntimeError(
            f"{path}: cannot unpickle ({e}); a checkpoint that holds a whole "
            "model needs the reference's classes on the path - save its "
            "state_dict() instead") from e
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


def model_rules(model: nn.Module) -> list:
    """The rule list of ``model``'s family, sized to it (stages, the
    deepest stage's blocks, decoders, time groups)."""
    if isinstance(model, MultiResUNetFlow):
        return build_unet_rules(num_encoders=model.num_encoders,
                                num_res=model.num_residual_blocks)
    if isinstance(model, SpikingMultiResUNetFlow):
        return build_snn_unet_rules(
            num_encoders=model.num_encoders,
            num_res=model.num_residual_blocks,
            use_upsample_conv=not isinstance(model.decoder0.deconv,
                                             TorchConvTranspose))
    found = [tuple(map(int, m.groups())) for m in map(
        re.compile(r"\.stage(\d+)\.block(\d+)\.").search, model.state_dict())
        if m]
    unet = model.sttmultires_unet
    kw = dict(num_stages=1 + max(i for i, _ in found),
              max_depth=1 + max(j for _, j in found),
              num_encoders=unet.num_encoders)
    if isinstance(model, STTFlowNet):
        return build_ann_rules(**kw, num_blocks=unet.encoders.num_blocks)
    return build_rules(
        **kw, num_res=unet.num_residual_blocks,
        pe_res=unet.encoders.patch_embed.residual_encoding.num_blocks,
        use_upsample_conv=not isinstance(unet.decoder0.deconv,
                                         TorchConvTranspose))


def load_reference_state_dict(state_dict: Dict[str, np.ndarray],
                              model: nn.Module) -> Tuple[dict, list]:
    """Reference-named state_dict -> (``model``'s state_dict, unmatched
    reference keys), by the rules of ``model``'s family. Every entry of
    ``model`` is filled, or ``from_jax`` raises ``KeyError``."""
    params, batch_stats, unmatched = convert_with_rules(state_dict,
                                                        model_rules(model))
    return from_jax({"params": params, "batch_stats": batch_stats},
                    model), unmatched


def _flax_name(module: nn.Module, leaf: str) -> Tuple[str, str]:
    """(collection, flax leaf) of the port entry ``leaf`` of ``module``:
    ``from_jax``'s naming run backwards."""
    if isinstance(module, TorchBatchNorm):
        return {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}[leaf]
    if leaf == "weight" and isinstance(module, (Conv2d, TorchConvTranspose,
                                                nn.Linear)):
        return "params", "kernel"
    if leaf == "weight" and isinstance(module, (nn.LayerNorm, InstanceNorm,
                                                GroupNorm)):
        return "params", "scale"
    return "params", leaf


def to_reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict under the reference's names (the inverse of
    :func:`load_reference_state_dict`); raises ``KeyError`` for an entry
    no rule covers."""
    modules = dict(model.named_modules())
    rules = {(c, f): (t, tr) for t, c, f, tr in model_rules(model)}
    out = {}
    for key, val in model.state_dict().items():
        mod_name, leaf = key.rsplit(".", 1)
        coll, flax_leaf = _flax_name(modules[mod_name], leaf)
        path = "/".join(mod_name.split(".") + [flax_leaf])
        if (coll, path) not in rules:
            raise KeyError(f"port entry {key} ({coll}/{path}) has no "
                           "reference name")
        name, tr = rules[(coll, path)]
        out[name] = val[:, :, None, None] if tr == "conv1x1" else val
    return out
