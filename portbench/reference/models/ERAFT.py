"""The plain E-RAFT of a configuration: Gehrig et al., "E-RAFT: Dense
Optical Flow from Event Cameras" (3DV 2021, https://github.com/uzh-rpg/E-RAFT
``model/eraft.py``, ``config/dsec_standard.json``) on RAFT's ``core/``
(Teed and Deng, ECCV 2020), written out in plain torch from the papers'
equations.

Input ``[B, 2 * bins, H, W]``: the older window's bins, then the newer
window's. ``fnet`` (instance norm, 256 out) encodes both windows, ``cnet``
(batch norm, 128 + 128 out) the newer one. The all-pairs volume of the
1/8 features over sqrt(256) and three 2x2 average-pooled levels below it
are sampled bilinearly in a 9x9 square around each pixel's current match
(zeros outside the map), 12 times; each time the motion encoder, the
separable ConvGRU (1x5, then 5x1), the flow head and the mask head run, and
the match moves by the flow head's output. The flow is the last match's
displacement, upsampled 8x as a convex combination (a softmax over 9 of the
mask) of each pixel's 3x3 neighbours at 1/8. A size that is not a multiple
of 32 is padded with zeros at the top and the left (E-RAFT's
``ImagePadder``).

The 9x9 square's offsets keep RAFT's order: sample (i, j), channel ``9 i +
j`` of a level, lies at x + o[i], y + o[j], o = -4 .. 4.

Precision: float32 (the configuration's reference). Cast to bfloat16 it
runs the convolutions in bfloat16 as the configuration serves them, and
keeps the norms, the volume, the sampling, the matches and the upsampling
in >= float32 (RAFT's rule: ``fmap.float()``). Every convolution is a
:class:`~portbench.reference.precision.Quantizable`, so the float8 control
reaches it. The correlation's controls set :attr:`ERAFT.corr`: ``"bf16"``
builds the volume from bfloat16 features in bfloat16 and keeps its
pyramid and samples in bfloat16 (the coordinates stay float32); ``"tf32"``
computes the float32 volume with TF32 matmuls. Parameter names are RAFT's
(the program's), so one seed gives both the same weights. Nothing here
imports the program or JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..precision import Quantizable


def _wide(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


class Conv(Quantizable, nn.Conv2d):
    def forward(self, x):
        x, w = self.operands(x, self.weight)
        return F.conv2d(x, w, self.bias, self.stride, self.padding)


class BN(nn.BatchNorm2d):
    """(x - running mean) / sqrt(running var + 1e-5) * weight + bias, in
    >= float32."""

    def forward(self, x):
        xf = _wide(x)
        c = (1, -1, 1, 1)
        y = (xf - self.running_mean.to(xf.dtype).view(c)) / torch.sqrt(
            self.running_var.to(xf.dtype).view(c) + self.eps)
        return (y * self.weight.to(xf.dtype).view(c)
                + self.bias.to(xf.dtype).view(c)).to(x.dtype)


class IN(nn.Module):
    """Each sample's channel standardized over its pixels (biased variance,
    1e-5), in >= float32; no parameters."""

    def forward(self, x):
        xf = _wide(x)
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
        return ((xf - mean) / torch.sqrt(var + 1e-5)).to(x.dtype)


def _norm(kind, planes):
    return BN(planes) if kind == "batch" else IN()


class Residual(nn.Module):
    def __init__(self, cin, cout, kind, stride):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride=stride, padding=1)
        self.conv2 = Conv(cout, cout, 3, padding=1)
        self.norm1, self.norm2 = _norm(kind, cout), _norm(kind, cout)
        self.stride = stride
        if stride > 1:
            # RAFT's shortcut norm, registered as norm3 and downsample.1
            self.norm3 = _norm(kind, cout)
            self.downsample = nn.Sequential(Conv(cin, cout, 1, stride=stride),
                                            self.norm3)

    def forward(self, x):
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        short = self.downsample(x) if self.stride > 1 else x
        return torch.relu(short + y)


class Encoder(nn.Module):
    def __init__(self, out, kind, bins):
        super().__init__()
        self.norm1 = _norm(kind, 64)
        self.conv1 = Conv(bins, 64, 7, stride=2, padding=3)
        chans = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for n, (cin, cout, s) in enumerate(chans, 1):
            setattr(self, f"layer{n}", nn.Sequential(
                Residual(cin, cout, kind, s), Residual(cout, cout, kind, 1)))
        self.conv2 = Conv(128, out, 1)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        for n in (1, 2, 3):
            x = getattr(self, f"layer{n}")(x)
        return self.conv2(x)


def volume(f1, f2, corr="fp32"):
    """[B, C, h, w] features -> [B, h, w, h, w]: every pair's dot product
    over sqrt(C), in >= float32 (``corr`` "bf16": in bfloat16; "tf32":
    float32 with TF32 matmuls)."""
    if corr == "bf16":
        f1, f2 = f1.to(torch.bfloat16), f2.to(torch.bfloat16)
    else:
        f1, f2 = _wide(f1), _wide(f2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = corr == "tf32" or prev
    try:
        return torch.einsum("bcij,bckl->bijkl", f1, f2) / f1.shape[1] ** 0.5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pyramid(vol, levels=4):
    """The volume as [B, h, w, h_i, w_i] maps, each level the 2x2 average of
    the one above (a trailing odd row or column dropped)."""
    out = [vol]
    for _ in range(levels - 1):
        v = out[-1]
        H, W = v.shape[-2] // 2 * 2, v.shape[-1] // 2 * 2
        v = v[..., :H, :W]
        out.append(v.reshape(*v.shape[:-2], H // 2, 2, W // 2, 2)
                   .mean(dim=(-3, -1)))
    return out


def bilinear(maps, px, py):
    """``maps`` [M, H, W]; ``px``, ``py`` [M, K] pixel positions -> [M, K]:
    bilinear interpolation of each map at its K points, zero outside, in
    the maps' dtype."""
    M, H, W = maps.shape
    flat = maps.reshape(M, H * W)
    x0, y0 = torch.floor(px), torch.floor(py)
    out = torch.zeros_like(px, dtype=maps.dtype)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wgt = ((1 - (px - xi).abs()) * (1 - (py - yi).abs())).to(
                maps.dtype)
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            out = out + torch.where(inside, wgt * flat.gather(1, idx), 0.0)
    return out


def sample(levels, match, radius=4):
    """[B, levels * (2r+1)^2, h, w]: each level at match / 2^i plus the 9x9
    offsets, sample (i, j) at x + o[i], y + o[j]."""
    B, _, h, w = match.shape
    o = torch.arange(-radius, radius + 1, dtype=match.dtype,
                     device=match.device)
    k = o.numel()
    ox = o.view(k, 1).expand(k, k).reshape(-1)
    oy = o.view(1, k).expand(k, k).reshape(-1)
    mx = match[:, 0].reshape(B * h * w, 1)
    my = match[:, 1].reshape(B * h * w, 1)
    feats = []
    for i, v in enumerate(levels):
        maps = v.reshape(B * h * w, v.shape[-2], v.shape[-1])
        s = bilinear(maps, mx / 2 ** i + ox, my / 2 ** i + oy)
        feats.append(s.view(B, h, w, k * k))
    return torch.cat(feats, dim=-1).permute(0, 3, 1, 2)


class MotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = Conv(324, 256, 1)
        self.convc2 = Conv(256, 192, 3, padding=1)
        self.convf1 = Conv(2, 128, 7, padding=3)
        self.convf2 = Conv(128, 64, 3, padding=1)
        self.conv = Conv(256, 126, 3, padding=1)

    def forward(self, flow, corr):
        c = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        f = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        return torch.cat([torch.relu(self.conv(torch.cat([c, f], 1))), flow],
                         1)


class GRU(nn.Module):
    """h <- (1 - z) h + z q with z, r = sigmoid(conv[h, x]), q =
    tanh(conv[r h, x]): a 1x5 pass, then a 5x1 pass."""

    def __init__(self, hidden=128, inp=256):
        super().__init__()
        for pas, (k, p) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))),
                                     1):
            for g in "zrq":
                setattr(self, f"conv{g}{pas}",
                        Conv(hidden + inp, hidden, k, padding=p))

    def forward(self, h, x):
        for pas in (1, 2):
            z = torch.sigmoid(getattr(self, f"convz{pas}")(
                torch.cat([h, x], 1)))
            r = torch.sigmoid(getattr(self, f"convr{pas}")(
                torch.cat([h, x], 1)))
            q = torch.tanh(getattr(self, f"convq{pas}")(
                torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv(128, 256, 3, padding=1)
        self.conv2 = Conv(256, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)))


class Update(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = MotionEncoder()
        self.gru = GRU()
        self.flow_head = Head()
        self.mask = nn.Sequential(Conv(128, 256, 3, padding=1), nn.ReLU(),
                                  Conv(256, 576, 1))

    def forward(self, net, inp, corr, flow):
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def convex_up(flow, mask):
    """[B, 2, h, w] and [B, 576, h, w] -> [B, 2, 8h, 8w]: pixel (8y + a,
    8x + b) is the softmax(mask[k * 64 + 8a + b]) combination over k of
    8 * flow at the 3x3 neighbours (y + k // 3 - 1, x + k % 3 - 1), zero
    outside."""
    B, _, h, w = flow.shape
    pad = F.pad(8 * flow, (1, 1, 1, 1))
    nb = torch.stack([pad[:, :, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=2)
    m = torch.softmax(mask.to(flow.dtype).view(B, 9, 8, 8, h, w), dim=1)
    up = torch.einsum("nkijyx,nckyx->ncyixj", m, nb)
    return up.reshape(B, 2, 8 * h, 8 * w)


class ERAFT(nn.Module):
    corr = "fp32"   # the correlation's precision: "fp32", "bf16", "tf32"

    def __init__(self, bins=15, iters=12):
        super().__init__()
        self.bins, self.iters = bins, iters
        self.fnet = Encoder(256, "instance", bins)
        self.cnet = Encoder(256, "batch", bins)
        self.update_block = Update()

    def correlate(self, x):
        """A padded input's features of both windows, the volume's levels
        and the pixel grid at 1/8 (x, y; >= float32)."""
        B = x.shape[0]
        f1 = self.fnet(x[:, :self.bins])
        f2 = self.fnet(x[:, self.bins:])
        levels = pyramid(volume(f1, f2, self.corr))
        h, w = f1.shape[-2:]
        wide = torch.promote_types(levels[0].dtype, torch.float32)
        ys, xs = torch.meshgrid(torch.arange(h, dtype=wide, device=x.device),
                                torch.arange(w, dtype=wide, device=x.device),
                                indexing="ij")
        return f1, f2, levels, torch.stack([xs, ys]).expand(B, 2, h, w)

    def forward(self, x):
        H, W = x.shape[-2:]
        ph, pw = (32 - H % 32) % 32, (32 - W % 32) % 32
        x = F.pad(x, (pw, 0, ph, 0))
        f1, f2, levels, start = self.correlate(x)
        ctx = self.cnet(x[:, self.bins:])
        net, inp = torch.tanh(ctx[:, :128]), torch.relu(ctx[:, 128:])
        wide = start.dtype
        match = start
        for _ in range(self.iters):
            corr = sample(levels, match)
            net, mask, step = self.update_block(
                net, inp, corr.to(net.dtype), (match - start).to(net.dtype))
            match = match + step.to(wide)
        flow = convex_up(match - start, mask)
        return {"flow": [flow[..., ph:, pw:]]}


def build(program: dict):
    """E-RAFT of a config in the program's schema: ``model.num_bins`` bins
    a window, ``model.iters`` refinement steps."""
    model = program["model"]
    return ERAFT(bins=int(model.get("num_bins", 15)),
                 iters=int(model.get("iters", 12)))
