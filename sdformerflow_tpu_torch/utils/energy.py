"""Energy-proxy estimation: firing-rate-weighted synaptic ops (SynOps), a
copy of ``sdformerflow_tpu/utils/energy.py`` with the same arithmetic.

The reference ships per-module ``record_flops()`` tables (its
``models/STSwinNet_SNN/Spiking_STSwinNet.py:211-238`` and
``Spiking_swin_transformer3D.py:393-411``) and firing-rate monitors, but never
joins the two. This module performs that join using the standard
Spikformer-family energy convention the SDformerFlow paper's efficiency
claims rest on:

    E_SNN = E_MAC * FLOPs(analog-input conv)
          + E_AC  * sum_site( rate(input spikes) * T_site * FLOPs(site) )

with E_MAC = 4.6 pJ and E_AC = 0.9 pJ (Horowitz, "Computing's energy
problem", ISSCC 2014; 45 nm CMOS — the constants every spiking-transformer
paper uses). The ANN comparator is E_ANN = E_MAC * total MAC count.

Scope: the MS (membrane-shortcut) Spikingformer family — SDformerFlow
itself. MS ordering is spike -> conv (Spiking_modules.py MS_* classes),
so every compute site's input firing rate is the ``sn`` site in its own
module scope, which ``SpikingNeuron`` records while
``models/spiking_layers.py:collect_sites`` runs. The SEW family
(conv -> spike) would need the *previous* layer's rate per site and is
intentionally not mapped here.

Time-step accounting: the reference's flops record mixes conventions —
conv/MLP/decoder sites are per single timestep, while attention sites
count one full (wt, wh, ww) window slab (token length N includes wt).
``energy_spikingformer`` therefore multiplies conv-ish sites by T and
attention sites by ceil(T / wt) so every site covers the whole forward.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np

from ..models.common import SwinConfig
from .flops import record_flops_spikingformer

# Horowitz ISSCC 2014, 45 nm: energy per 32-bit multiply-accumulate and
# per accumulate. Joules.
E_MAC_J = 4.6e-12
E_AC_J = 0.9e-12

# sentinel rate key: the site consumes analog (non-spike) input -> MACs
ANALOG = "__analog__"


def _value(v) -> float:
    """A recorded rate (a tensor on any device, an array or a number) as
    the float of its mean."""
    if hasattr(v, "detach"):   # a torch tensor
        v = v.detach().cpu().numpy()
    return float(np.asarray(v).mean())


def normalize_spike_rates(rates) -> Dict[str, float]:
    """Flatten a spike-rate collection to {dotted.site.name: rate}.

    Accepts a flat mapping with "/"- or "."-joined keys: the site dict of
    ``make_eval_step(collect_spike_rates=True)`` (tensors) or the
    ``spike_rates.json`` that ``eval_dsec --store_spike_rates`` writes
    (either package's), or a nested mapping of such mappings (JAX's
    ``intermediates`` tree, as plain dicts). Trailing ``spike_rate`` /
    tuple-index components are stripped, so keys end at the neuron site
    name (e.g. ``...patch_embed.head.sn``).
    """
    def flatten(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                yield from flatten(v, key)
            elif isinstance(v, (list, tuple)):
                for i, x in enumerate(v):
                    yield f"{key}/[{i}]", x
            else:
                yield key, v

    items = list(flatten(rates, ""))
    # a mixed telemetry tree (membrane stats, attention maps) is filtered
    # to spike_rate leaves; a plain {site: rate} dict passes through whole
    tagged = [(k, v) for k, v in items if "spike_rate" in k]
    if tagged:
        items = tagged
    out: Dict[str, float] = {}
    for key, val in items:
        parts = [p for p in key.replace("/", ".").split(".") if p]
        while parts and (parts[-1].strip("[]").isdigit()
                         or parts[-1] == "spike_rate"):
            parts.pop()
        if not parts:
            continue
        out[".".join(parts)] = _value(val)
    return out


def _lookup(rates: Dict[str, float], suffix: str) -> float:
    """Find the unique rate whose dotted name ends with ``suffix``."""
    hits = [k for k in rates
            if k == suffix or k.endswith("." + suffix)]
    if len(hits) != 1:
        raise KeyError(
            f"spike-rate site {suffix!r}: {len(hits)} matches "
            f"({hits[:3]}...); have {sorted(rates)[:5]}...")
    return rates[hits[0]]


def _site_rate_map(depths, num_residual_blocks, num_encoders,
                   pe_resblocks=2) -> Dict[Tuple[str, ...], object]:
    """Map each flops-record site (nested-key path) of
    ``record_flops_spikingformer`` to the dotted suffix of the MS neuron
    that feeds it, ``ANALOG`` for the analog-input head conv, or a tuple
    of two suffixes for the split-accounted linear-QK ``attn`` site
    (adds gated by q spikes, mults by k spikes).
    """
    m: Dict[Tuple[str, ...], object] = {
        # MS_PED embed (spiking_patch_embed.py MS_PED class): head is
        # SEW-order conv on the analog voxel encoding -> MACs; the
        # stride-2 conv consumes head's sn output (first_layer=True skips
        # its own input spike); resblocks and PED proj are spike->conv.
        ("patch_embed", "head"): ANALOG,
        ("patch_embed", "conv"): "patch_embed.head.sn",
        ("patch_embed", "proj"): "patch_embed.proj.sn",
    }
    for i in range(pe_resblocks):
        m[("patch_embed", f"res{i}_conv0")] = (
            f"patch_embed.residual_encoding.res{i}.sn1")
        m[("patch_embed", f"res{i}_conv1")] = (
            f"patch_embed.residual_encoding.res{i}.sn2")
    for i, depth in enumerate(depths):
        for b in range(depth):
            blk = f"stage{i}.block{b}"
            # linear-QK attention (spiking_swin.py
            # SpikingQKWindowAttention3D): proj_sn spikes the block input
            # feeding BOTH q and k linears; attn = k * spike(sum q); the
            # proj linear consumes the binary k*token product, whose
            # closest sown proxy is attn_sn's rate.
            m[(f"layer{i}", f"block{b}", "attn", "q")] = f"{blk}.attn.proj_sn"
            m[(f"layer{i}", f"block{b}", "attn", "k")] = f"{blk}.attn.proj_sn"
            m[(f"layer{i}", f"block{b}", "attn", "attn")] = (
                f"{blk}.attn.q.sn", f"{blk}.attn.k.sn")
            m[(f"layer{i}", f"block{b}", "attn", "proj")] = f"{blk}.attn.attn_sn"
            m[(f"layer{i}", f"block{b}", "mlp0")] = f"{blk}.mlp.sn1"
            m[(f"layer{i}", f"block{b}", "mlp1")] = f"{blk}.mlp.sn2"
        if i < len(depths) - 1:
            m[(f"layer{i}", "downsample")] = f"stage{i}.downsample.sn"
    for i in range(num_residual_blocks):
        m[(f"res{i}_conv0",)] = f"resblock{i}.sn1"
        m[(f"res{i}_conv1",)] = f"resblock{i}.sn2"
    for i in range(num_encoders):
        m[(f"decoder{i}",)] = f"decoder{i}.sn"
        m[(f"pred{i}",)] = f"pred{i}.sn"
    return m


def _flatten_record(record, prefix=()) -> Dict[Tuple[str, ...], int]:
    out: Dict[Tuple[str, ...], int] = {}
    for k, v in record.items():
        if isinstance(v, dict):
            out.update(_flatten_record(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = int(v)
    return out


def energy_spikingformer(swin: SwinConfig, spike_rates, *, num_steps: int,
                         base_channels: int = 96, num_encoders: int = 4,
                         num_residual_blocks: int = 2, num_ch: int = 2,
                         kernel_size: int = 3, e_mac: float = E_MAC_J,
                         e_ac: float = E_AC_J) -> Dict:
    """Join the analytic flops record with measured firing rates.

    ``spike_rates``: a flat rate dict or a tree of them (see
    ``normalize_spike_rates``). ``num_steps``: T, the simulation length of
    the forward being measured (the conv-site flops in the record are per
    timestep). Raises ``KeyError`` if any compute site cannot be paired
    with exactly one sown neuron site — mismatches fail loudly rather
    than silently under-counting.

    Returns per-site rows plus totals: ``macs``, ``acs`` (SynOps),
    ``energy_j`` and the ANN comparator ``ann_energy_j`` (all sites at
    rate 1 priced at E_MAC — the convention the paper's SNN-vs-ANN
    efficiency ratios use).
    """
    rates = normalize_spike_rates(spike_rates)
    record = _flatten_record(record_flops_spikingformer(
        swin, base_channels=base_channels, num_encoders=num_encoders,
        num_residual_blocks=num_residual_blocks, num_ch=num_ch,
        kernel_size=kernel_size, ms=True))
    site_map = _site_rate_map(swin.depths, num_residual_blocks,
                              num_encoders)
    wt = swin.window_size[0]
    attn_mult = math.ceil(num_steps / wt)

    per_site = {}
    macs = 0.0
    acs = 0.0
    ann_ops = 0.0
    for path, flops in record.items():
        if path not in site_map:
            raise KeyError(f"flops site {path} has no rate mapping")
        src = site_map[path]
        is_attn = len(path) >= 3 and path[2] == "attn"
        tmult = attn_mult if is_attn else num_steps
        total = flops * tmult
        ann_ops += total
        name = ".".join(path)
        if src is ANALOG:
            macs += total
            per_site[name] = {"flops": total, "rate": None, "ops": total,
                              "kind": "mac"}
        elif isinstance(src, tuple):  # split site: half adds, half mults
            r_q, r_k = (_lookup(rates, s) for s in src)
            ops = total / 2 * r_q + total / 2 * r_k
            acs += ops
            per_site[name] = {"flops": total, "rate": (r_q + r_k) / 2,
                              "ops": ops, "kind": "ac"}
        else:
            r = _lookup(rates, src)
            ops = total * r
            acs += ops
            per_site[name] = {"flops": total, "rate": r, "ops": ops,
                              "kind": "ac"}

    energy = macs * e_mac + acs * e_ac
    return {
        "per_site": per_site,
        "macs": macs,
        "acs": acs,
        "energy_j": energy,
        "energy_mj": energy * 1e3,
        "ann_energy_j": ann_ops * e_mac,
        "snn_vs_ann_ratio": energy / (ann_ops * e_mac) if ann_ops else 0.0,
        "num_steps": num_steps,
    }


def energy_ann(record, *, e_mac: float = E_MAC_J) -> Dict:
    """ANN energy: every op is a MAC (no time expansion — the ANN record
    is already per full forward)."""
    total = sum(_flatten_record(record).values())
    return {"macs": float(total), "energy_j": total * e_mac,
            "energy_mj": total * e_mac * 1e3}
