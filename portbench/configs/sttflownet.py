"""The reckoning of the ``sttflownet`` configuration: the floating-point
operations of one sample's forward and of one trained sample, from the
configuration's shapes alone (never from what the program ran).

Two operations a multiply-add. Counted: every convolution, dense layer and
attention product (q k^T, attention x v, the swin-v2 position-bias MLP) as
the architecture defines them: the window attention runs on the zero-padded
windows (the padded tokens take part in the softmax), the MLPs on the
unpadded tokens. Not counted: norms, activations, softmax, resizes.
``portbench/tests/test_reckoning.py`` ties the count to
``torch.utils.flop_counter`` on the plain reference at a small size.
"""

from __future__ import annotations


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _up(n, w):
    return -(-n // w) * w


def forward_macs(config: dict, height: int = None, width: int = None,
                 constant_inputs: bool = False) -> int:
    """Multiply-adds of one sample's forward at ``height`` x ``width``
    (default: the configuration's crop); with ``constant_inputs``, only
    those of the layers whose input is a constant (the head convolution
    and the position-bias MLPs' first layers), whose input gradient a
    trained step does not need."""
    model, swin = config["model"], config["swin_transformer"]
    crop = config["loader"]["crop"]
    H = height or crop[0]
    W = width or crop[1]
    H, W = _up(H, 2), _up(W, 2)            # STTFlowNet pads to even
    c0 = swin["base_num_channels"]
    pt, ph, pw = swin["swin_patch_size"]
    groups = model["num_bins"] // pt
    wd, wh, ww = swin["window_size"]
    macs = 0
    # patch embed, each time group: head, 4 residual blocks, strided proj
    h0, w0 = _out(H, 3, ph, 1), _out(W, 3, pw, 1)
    per_group = (H * W * pt * c0 * 9 + 8 * H * W * c0 * c0 * 9
                 + h0 * w0 * c0 * c0 * 9)
    macs += groups * per_group
    const = groups * H * W * pt * c0 * 9
    # swin stages
    h, w, D = h0, w0, groups
    skip = []
    depths, heads = swin["swin_depths"], swin["swin_num_heads"]
    for i, depth in enumerate(depths):
        dim = c0 * 2 ** i
        ew = [min(n, win) for n, win in zip((D, h, w), (wd, wh, ww))]
        erel = (2 * ew[0] - 1) * (2 * ew[1] - 1) * (2 * ew[2] - 1)
        N = ew[0] * ew[1] * ew[2]
        padded = _up(D, ew[0]) * _up(h, ew[1]) * _up(w, ew[2])
        windows = padded // N
        tokens = D * h * w
        hidden = int(dim * swin["mlp_ratio"])
        for _ in range(depth):
            macs += padded * dim * 3 * dim              # qkv
            macs += 2 * windows * N * N * dim           # q k^T, attn v
            macs += padded * dim * dim                  # proj
            macs += erel * (3 * 512 + 512 * heads[i])   # position-bias MLP
            const += erel * 3 * 512
            macs += 2 * tokens * dim * hidden           # MLP
        skip.append((h, w, dim))
        if i < len(depths) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            macs += D * h * w * 4 * dim * 2 * dim       # patch merging
    # per-stage, per-group projections C -> C / groups
    for (sh, sw, dim) in skip:
        macs += groups * sh * sw * dim * (dim // groups)
    # residual bottleneck; decoder i (x2 bilinear + 3x3 conv) at twice the
    # size of the skip it joins, then its 1x1 prediction
    chans = [groups * (d // groups) for _, _, d in skip]
    bh, bw, _ = skip[-1]
    c = chans[-1]
    macs += 2 * 2 * bh * bw * c * c * 9
    dec_out = list(reversed([c0] + [c0 * 2 ** i
                                    for i in range(len(depths))][:-1]))
    k = model.get("kernel_size", 3)
    n = len(depths)
    for i in range(n):
        sh, sw, _ = skip[n - i - 1]
        c += chans[n - i - 1] + (2 if i > 0 else 0)
        macs += 4 * sh * sw * c * dec_out[i] * k * k
        macs += 4 * sh * sw * dec_out[i] * 2
        c = dec_out[i]
    return const if constant_inputs else macs


def serve_flops_per_window(config: dict) -> float:
    """FLOPs of one served window: the forward at the crop."""
    return 2.0 * forward_macs(config)


def train_flops_per_sample(config: dict, height: int = None,
                           width: int = None) -> float:
    """FLOPs of one trained sample: the forward, and the backward's two
    products a layer (input and weight gradients) but for the input
    gradient of the layers whose input is a constant."""
    f = forward_macs(config, height, width)
    const = forward_macs(config, height, width, constant_inputs=True)
    return 2.0 * (3 * f - const)
