"""ANN patch embeddings, mirrors of
``sdformerflow_tpu/models/ann_patch_embed.py``: a head conv, residual
feature generators and a strided projection per time group.

Input ``[T, B, H, W, patch_t]`` (T time groups of voxel bins), output
``[B, T, H', W', embed_dim]``. As in JAX, the T groups go through one conv
as one batch, so the BN statistics of the residual blocks are taken over
(T, B) jointly (the reference loops over the groups).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from .ann_layers import ResidualBlock
from .spiking_layers import Conv2d, conv2d, conv_output_size


class ResidualFeatureGenerator(nn.Module):
    """``num_blocks`` BN residual blocks named ``resblock1``..."""

    def __init__(self, dim, num_blocks=4, norm="BN"):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"resblock{i + 1}",
                            ResidualBlock(dim, 1, "relu", norm))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"resblock{i + 1}")(x)
        return x


def _proj(dim, patch_size) -> Conv2d:
    """3x3 conv at stride ``patch_size[-2:]``, padding 1."""
    return Conv2d(dim, dim, 3, stride=tuple(patch_size[-2:]), padding=1)


def _patches(img_size, patch_size, pre_stride=1) -> Tuple[int, int]:
    h, w = (conv_output_size(n, 3, pre_stride, 1) for n in img_size)
    return (conv_output_size(h, 3, patch_size[-2], 1),
            conv_output_size(w, 3, patch_size[-1], 1))


class PatchEmbedLocal(nn.Module):
    """head conv -> 4 residual blocks -> strided proj, per time group."""

    def __init__(self, img_size, patch_size=(2, 4, 4), embed_dim=96,
                 num_groups=2):
        super().__init__()
        del num_groups
        self.patches_resolution = _patches(img_size, patch_size)
        self.head = conv2d(patch_size[0], embed_dim, 3, 1)
        self.residual_encoding = ResidualFeatureGenerator(embed_dim)
        self.proj = _proj(embed_dim, patch_size)

    def forward(self, x):
        x = self.proj(self.residual_encoding(self.head(x)))
        return x.transpose(0, 1)


class PatchEmbedLocalConv(nn.Module):
    """PatchEmbedLocal with a stride-2 conv after a half-width head."""

    def __init__(self, img_size, patch_size=(2, 4, 4), embed_dim=96,
                 num_groups=2):
        super().__init__()
        del num_groups
        self.patches_resolution = _patches(img_size, patch_size, 2)
        self.head = conv2d(patch_size[0], embed_dim // 2, 3, 1)
        self.conv = conv2d(embed_dim // 2, embed_dim, 3, 2)
        self.residual_encoding = ResidualFeatureGenerator(embed_dim)
        self.proj = _proj(embed_dim, patch_size)

    def forward(self, x):
        x = self.residual_encoding(self.conv(self.head(x)))
        return self.proj(x).transpose(0, 1)


class PatchEmbedLocalGlobal(nn.Module):
    """Half the embedding from each time group, half from a global head
    over all ``num_groups * patch_t`` bins (broadcast over the groups)."""

    def __init__(self, img_size, patch_size=(2, 4, 4), embed_dim=96,
                 num_groups=2):
        super().__init__()
        half = embed_dim // 2
        self.patches_resolution = _patches(img_size, patch_size)
        self.global_head = conv2d(num_groups * patch_size[0], half, 3, 1)
        self.global_residual_encoding = ResidualFeatureGenerator(half)
        self.global_proj = _proj(half, patch_size)
        self.head = conv2d(patch_size[0], half, 3, 1)
        self.residual_encoding = ResidualFeatureGenerator(half)
        self.proj = _proj(half, patch_size)

    def forward(self, x):
        T, B, H, W, C = x.shape
        g = x.permute(1, 2, 3, 0, 4).reshape(B, H, W, T * C)
        g = self.global_proj(self.global_residual_encoding(
            self.global_head(g)))
        loc = self.proj(self.residual_encoding(self.head(x)))
        out = torch.cat([loc, g[None].expand(T, *g.shape)], dim=-1)
        return out.transpose(0, 1)


ANN_PATCH_EMBEDS = {
    "PatchEmbedLocal": PatchEmbedLocal,
    "PatchEmbedLocal_Conv": PatchEmbedLocalConv,
    "PatchEmbedLocalGlobal": PatchEmbedLocalGlobal,
}
