"""E-RAFT: dense optical flow from two consecutive event volumes.

Gehrig, Millhäusler, Gehrig and Scaramuzza, "E-RAFT: Dense Optical Flow
from Event Cameras", 3DV 2021 (https://github.com/uzh-rpg/E-RAFT,
``model/eraft.py``, configuration ``config/dsec_standard.json``: 15 voxel
bins a window, subtype ``standard``), built on RAFT's ``core/`` (Teed and
Deng, ECCV 2020, https://github.com/princeton-vl/RAFT). The JAX package has
no counterpart.

Input: ``[B, 2 * num_bins, H, W]``, the older window's bins first, then
the newer window's (the port's ``data.num_chunks`` layout,
``training/config.py:chunk_bins``); output ``{"flow": [...]}``, each
``[B, 2, H, W]``, the served flow last.

The layers, as RAFT writes them (module and parameter names are RAFT's, so
a published state_dict loads as it is):

- ``BasicEncoder(out, norm)``: ``conv1`` 7x7 stride 2 (bins -> 64), norm,
  ReLU; three layers of two ``ResidualBlock`` s at widths 64 (stride 1),
  96 and 128 (stride 2); ``conv2`` 1x1 (128 -> out). A residual block is
  ``y = relu(n1(conv3x3_s(x))); y = relu(n2(conv3x3(y)))``, ``x =
  n3(conv1x1_s(x))`` where the stride is not 1, out ``relu(x + y)``.
  ``fnet`` (out 256, instance norm without affine) runs on both windows as
  one batch; ``cnet`` (out 256, batch norm) on the newer window, as
  E-RAFT's ``cnet(image2)``: ``net = tanh(cnet[:128])``, ``inp =
  relu(cnet[128:])``.
- :func:`corr_pyramid`: the all-pairs volume ``fmap1^T fmap2 / sqrt(256)``
  and three ``avg_pool2d(2, 2)`` levels below it; :func:`lookup`: each
  level sampled at ``coords / 2^i + delta`` by ``grid_sample``
  (``align_corners=True``, zeros outside), ``delta`` RAFT's
  ``stack(meshgrid(dy, dx), -1)`` over ``linspace(-4, 4, 9)``, whose first
  component (dy's values) is added to x: the 324 channels keep RAFT's
  order, so published weights line up.
- ``BasicUpdateBlock`` (hidden 128): the motion encoder (``convc1`` 1x1
  324 -> 256, ``convc2`` 3x3 -> 192, ``convf1`` 7x7 2 -> 128, ``convf2``
  3x3 -> 64, ``conv`` 3x3 256 -> 126, each with ReLU, then the flow's two
  channels appended), ``SepConvGRU`` (1x5 then 5x1: ``z = σ(conv[h, x])``,
  ``r = σ(conv[h, x])``, ``q = tanh(conv[r h, x])``, ``h = (1 - z) h + z
  q``), the flow head (3x3 128 -> 256, ReLU, 3x3 -> 2) and the mask head
  (3x3 128 -> 256, ReLU, 1x1 -> 576, times 0.25).
- The iterations: ``coords0 = coords1`` = the 1/8 pixel grid; ``iters``
  times lookup, update, ``coords1 += delta``. The flow is the convex
  upsampling of ``coords1 - coords0`` (a softmax over 9 of the mask viewed
  ``[B, 1, 9, 8, 8, h, w]`` weighting ``unfold(8 * flow, 3x3, pad 1)``).
- E-RAFT's ``ImagePadder(min_size=32)``: a size that is not a multiple of
  32 is padded with zeros at the top and the left, and the flow unpadded.

Departures, each of form and not of value:

- In eval mode only the last iteration's flow is upsampled and returned
  (RAFT's ``test_mode``; E-RAFT's forward upsamples every iteration and
  returns them all). The mask head still runs every iteration, as RAFT's
  update block does. Train mode returns every iteration's flow.
- Precision: the encoders and the update block run in the parameters'
  dtype (bf16 on the serving path), the norms in >= float32 and returned in
  the input's dtype. The features are taken to >= float32 before the
  volume; the volume, its pyramid, the lookups, the coordinates and the
  convex upsampling stay >= float32: RAFT's own mixed-precision rule
  (``fmap1.float()``, ``CorrBlock`` returning ``.float()``). The volume's
  float32 GEMM runs in full float32 in cuBLAS unless the process turns TF32
  on (``torch.backends.cuda.matmul.allow_tf32``, False by default; neither
  the program nor the benchmark sets it).
- E-RAFT's ``warm_start`` subtype (the previous flow forward-warped into
  ``flow_init``) is not ported: the server is stateless.

While the tracer is on (``utils/tracing.py``) each forward records the span
``eraft.corr`` (the host's issue of the volume and its pyramid), one
``eraft.update`` an iteration (its lookup and update; the lookup alone
inside it as ``eraft.lookup``), and counts ``eraft.volumes`` (rows whose
volume was built) and ``eraft.lookups`` (rows times iterations).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import tracing

HIDDEN = CONTEXT = 128
CORR_LEVELS, CORR_RADIUS = 4, 4
PAD_TO = 32


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` computed in >= float32, returned in the input's
    dtype."""

    def forward(self, x):
        cdt = _wide(x.dtype)
        return F.batch_norm(
            x.to(cdt), self.running_mean.to(cdt), self.running_var.to(cdt),
            self.weight.to(cdt), self.bias.to(cdt), self.training,
            self.momentum, self.eps).to(x.dtype)


class InstanceNorm(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` (no affine, no running statistics) computed in
    >= float32, returned in the input's dtype."""

    def forward(self, x):
        return F.instance_norm(x.to(_wide(x.dtype)),
                               eps=self.eps).to(x.dtype)


NORMS = {"batch": BatchNorm, "instance": InstanceNorm}


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, norm_fn: str,
                 stride: int = 1):
        super().__init__()
        norm = NORMS[norm_fn]
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1,
                               stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1, self.norm2 = norm(planes), norm(planes)
        self.downsample = None
        if stride != 1:
            # RAFT registers the shortcut's norm twice (``norm3`` and
            # ``downsample.1``): its state_dicts hold both names
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """RAFT's feature / context encoder: [B, n_first, H, W] -> [B, out,
    H / 8, W / 8]."""

    def __init__(self, output_dim: int, norm_fn: str, n_first_channels: int):
        super().__init__()
        self.norm1 = NORMS[norm_fn](64)
        self.conv1 = nn.Conv2d(n_first_channels, 64, 7, stride=2, padding=3)
        self.layer1 = self._layer(64, 64, norm_fn, 1)
        self.layer2 = self._layer(64, 96, norm_fn, 2)
        self.layer3 = self._layer(96, 128, norm_fn, 2)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    @staticmethod
    def _layer(in_planes, dim, norm_fn, stride):
        return nn.Sequential(ResidualBlock(in_planes, dim, norm_fn, stride),
                             ResidualBlock(dim, dim, norm_fn, 1))

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                 levels: int = CORR_LEVELS) -> list:
    """The all-pairs correlation volume of two [B, C, h, w] feature maps
    and its pooled levels: ``levels`` tensors [B * h * w, 1, h_i, w_i]
    (``h_i = h >> i`` by floor), in >= float32."""
    B, C, h, w = fmap1.shape
    cdt = _wide(fmap1.dtype)
    with tracing.span("eraft.corr"):
        f1 = fmap1.to(cdt).reshape(B, C, h * w)
        f2 = fmap2.to(cdt).reshape(B, C, h * w)
        corr = torch.matmul(f1.transpose(1, 2), f2) / math.sqrt(C)
        corr = corr.reshape(B * h * w, 1, h, w)
        pyramid = [corr]
        for _ in range(levels - 1):
            corr = F.avg_pool2d(corr, 2, stride=2)
            pyramid.append(corr)
    tracing.count("eraft.volumes", B)
    return pyramid


def lookup_offsets(radius: int, *, dtype, device) -> torch.Tensor:
    """RAFT's ``delta``: [2r+1, 2r+1, 2] = ``stack(meshgrid(dy, dx), -1)``;
    entry (i, j) is (lin[i], lin[j]), the first added to x."""
    lin = torch.linspace(-radius, radius, 2 * radius + 1, dtype=dtype,
                         device=device)
    return torch.stack(torch.meshgrid(lin, lin, indexing="ij"), dim=-1)


def lookup(pyramid: list, coords: torch.Tensor,
           radius: int = CORR_RADIUS) -> torch.Tensor:
    """Bilinear samples of every level around ``coords`` [B, 2, h, w]
    (x, y at 1/8): [B, levels * (2r+1)^2, h, w], level-major, in the
    pyramid's dtype."""
    B, _, h, w = coords.shape
    k = 2 * radius + 1
    delta = lookup_offsets(radius, dtype=coords.dtype,
                           device=coords.device).view(1, k, k, 2)
    centroid = coords.permute(0, 2, 3, 1).reshape(B * h * w, 1, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        pts = centroid / 2 ** i + delta
        H, W = corr.shape[-2:]
        grid = torch.cat([2 * pts[..., :1] / (W - 1) - 1,
                          2 * pts[..., 1:] / (H - 1) - 1], dim=-1)
        sampled = F.grid_sample(corr, grid, align_corners=True)
        out.append(sampled.view(B, h, w, k * k))
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous()


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int = CORR_LEVELS * (2 * CORR_RADIUS
                                                         + 1) ** 2):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = HIDDEN,
                 input_dim: int = 128 + HIDDEN):
        super().__init__()
        n = hidden_dim + input_dim
        for tag, (k, p) in (("1", ((1, 5), (0, 2))), ("2", ((5, 1), (2, 0)))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{tag}",
                        nn.Conv2d(n, hidden_dim, k, padding=p))

    def forward(self, h, x):
        for tag in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, "convz" + tag)(hx))
            r = torch.sigmoid(getattr(self, "convr" + tag)(hx))
            q = torch.tanh(getattr(self, "convq" + tag)(
                torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = HIDDEN, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """(net, inp, corr, flow) -> (net, mask, delta_flow), in the
    parameters' dtype."""

    def __init__(self, hidden_dim: int = HIDDEN):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden_dim, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def coords_grid(batch: int, h: int, w: int, *, dtype, device):
    """[batch, 2, h, w]: channel 0 the x, channel 1 the y of each pixel."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys]).expand(batch, 2, h, w)


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT's convex upsampling: [B, 2, h, w] flow at 1/8 and its [B, 576,
    h, w] mask -> [B, 2, 8h, 8w], in the flow's dtype."""
    B, _, h, w = flow.shape
    mask = torch.softmax(mask.to(flow.dtype).view(B, 1, 9, 8, 8, h, w),
                         dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, h, w)
    up = torch.sum(mask * up, dim=2).permute(0, 1, 4, 2, 5, 3)
    return up.reshape(B, 2, 8 * h, 8 * w)


class ERAFT(nn.Module):
    """E-RAFT, subtype ``standard``: ``num_bins`` voxel bins a window,
    ``iters`` refinement steps (see the module's docstring)."""

    # a served events request holds this many windows, each voxelized into
    # ``num_bins`` bins over its own time span (``serving.FlowServer``)
    event_windows = 2

    def __init__(self, num_bins: int = 15, iters: int = 12):
        super().__init__()
        self.num_bins, self.iters = int(num_bins), int(iters)
        self.fnet = BasicEncoder(256, "instance", self.num_bins)
        self.cnet = BasicEncoder(HIDDEN + CONTEXT, "batch", self.num_bins)
        self.update_block = BasicUpdateBlock(HIDDEN)

    def forward(self, x):
        if x.shape[1] != 2 * self.num_bins:
            raise ValueError(f"E-RAFT takes [B, {2 * self.num_bins}, H, W] "
                             f"(two windows of {self.num_bins} bins), got "
                             f"{tuple(x.shape)}")
        H, W = x.shape[-2:]
        ph, pw = (-H) % PAD_TO, (-W) % PAD_TO
        x = F.pad(x, (pw, 0, ph, 0))
        B = x.shape[0]
        old, new = x[:, :self.num_bins], x[:, self.num_bins:]
        fmap = self.fnet(torch.cat([old, new], dim=0))
        pyramid = corr_pyramid(fmap[:B], fmap[B:])
        cnet = self.cnet(new)
        net, inp = torch.tanh(cnet[:, :HIDDEN]), torch.relu(cnet[:, HIDDEN:])
        cdt = pyramid[0].dtype
        coords0 = coords_grid(B, fmap.shape[-2], fmap.shape[-1], dtype=cdt,
                              device=x.device)
        coords1 = coords0
        flows = []
        for itr in range(self.iters):
            coords1 = coords1.detach()
            with tracing.span("eraft.update", itr):
                with tracing.span("eraft.lookup", itr):
                    corr = lookup(pyramid, coords1)
                flow = coords1 - coords0
                net, mask, delta = self.update_block(
                    net, inp, corr.to(net.dtype), flow.to(net.dtype))
                coords1 = coords1 + delta.to(cdt)
            if self.training or itr == self.iters - 1:
                up = upsample_flow(coords1 - coords0, mask)
                flows.append(up[..., ph:, pw:])
        tracing.count("eraft.lookups", B * self.iters)
        return {"flow": flows}
