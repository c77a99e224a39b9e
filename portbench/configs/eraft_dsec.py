"""The reckoning of the ``eraft_dsec`` configuration: the operations of one
served request, and the work of its correlation volume and lookups, from
the configuration's shapes alone (never from what the program ran).

Two operations a multiply-add. Counted: every convolution, the volume's
product and the convex upsampling's combination (9 multiply-adds an output
value), as the architecture defines them; not counted: norms, activations,
the pooling, the bilinear sampling, the softmax, the GRU's gating.
``portbench/tests/test_portbench_eraft.py`` ties the count to
``torch.utils.flop_counter`` on the plain reference at two sizes.

At 480x640: the encoders 23.7 G multiply-adds a pass (three: the features
of both windows, the context of the newer), the volume 5.9 G, each of the
12 updates 15.0 G (the separable GRU 7.1 G of it): 0.514 TFLOP a request.
"""

from __future__ import annotations

LEVELS, RADIUS, FEATURES = 4, 4, 256


def _out(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _pad32(n):
    return -(-n // 32) * 32


def _conv(h, w, cin, cout, k, s=1, p=0):
    """(multiply-adds, out h, out w) of a square convolution."""
    ho, wo = _out(h, k, s, p), _out(w, k, s, p)
    return ho * wo * cin * cout * k * k, ho, wo


def encoder_macs(height: int, width: int, bins: int, out: int) -> int:
    """RAFT's BasicEncoder on one [bins, height, width] input."""
    macs, h, w = _conv(height, width, bins, 64, 7, 2, 3)
    cin = 64
    for dim, stride in ((64, 1), (96, 2), (128, 2)):
        m, ho, wo = _conv(h, w, cin, dim, 3, stride, 1)
        macs += m + 3 * ho * wo * dim * dim * 9     # the other 3x3 convs
        if stride != 1:
            macs += ho * wo * cin * dim               # the 1x1 shortcut
        h, w, cin = ho, wo, dim
    return macs + h * w * 128 * out


def update_macs(h: int, w: int) -> int:
    """One iteration's update block at the 1/8 grid h x w."""
    corr = LEVELS * (2 * RADIUS + 1) ** 2
    per_px = (corr * 256 + 256 * 192 * 9          # convc1, convc2
              + 2 * 128 * 49 + 128 * 64 * 9       # convf1, convf2
              + 256 * 126 * 9                     # conv
              + 6 * 384 * 128 * 5                 # the separable GRU
              + 128 * 256 * 9 + 256 * 2 * 9       # flow head
              + 128 * 256 * 9 + 256 * 576)        # mask head
    return h * w * per_px


def grid(program: dict):
    """(padded height, padded width, 1/8 height, 1/8 width)."""
    H, W = (_pad32(n) for n in program["loader"]["resolution"])
    return H, W, H // 8, W // 8


def forward_macs(program: dict) -> int:
    model = program["model"]
    bins = int(model.get("num_bins", 15))
    iters = int(model.get("iters", 12))
    H, W, h, w = grid(program)
    macs = 3 * encoder_macs(H, W, bins, FEATURES)
    macs += (h * w) ** 2 * FEATURES
    macs += iters * update_macs(h, w)
    return macs + 9 * 2 * H * W                   # the convex combination


def serve_flops_per_window(program: dict) -> float:
    """FLOPs of one served request (its two windows' forward)."""
    return 2.0 * forward_macs(program)


def volume_work(program: dict):
    """(FLOPs, bytes) of one row's volume and pyramid: the product
    ``fmap1^T fmap2`` of two [256, h w] float32 maps; the maps read once
    and every level written once, float32."""
    _, _, h, w = grid(program)
    n = h * w
    cells = sum((h >> i) * (w >> i) for i in range(LEVELS))
    return 2.0 * n * n * FEATURES, 4.0 * (2 * n * FEATURES + n * cells)


def lookup_bytes(program: dict) -> float:
    """Bytes of one row's lookup at one iteration: each pixel's
    (2r + 2)^2 float32 patch read at every level, its levels * (2r + 1)^2
    float32 samples written."""
    _, _, h, w = grid(program)
    return 4.0 * h * w * LEVELS * ((2 * RADIUS + 2) ** 2
                                   + (2 * RADIUS + 1) ** 2)
