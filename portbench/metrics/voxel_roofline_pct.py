"""``voxel_roofline_pct``: K3's share of its roofline in the profiled slice
after the window. The bound is the bytes K3 must move at the card's
3.35 TB/s: each event slot read once (x, y, t, p float32 and the valid
flag, one byte: 17 B) and each grid [bins, H, W] float32 written once,

    bytes = 17 * slots + 4 * grids * bins * H * W,

with ``slots`` the program's ``serve.event_slots`` counter over the slice
(rows times the event bucket), ``grids`` K3's launches (one a row: its
``tile_kernel``), ``bins`` the configuration's ``data.num_frames`` and
``H, W`` its ``loader.resolution``: 30.1 MB for 2^20 slots and one
10x480x640 grid. The time is that of K3's kernels in the trace
(``csrc/voxel.cu``: ``bin_kernel``, twice, ``plan_kernel``,
``tile_kernel``; the memset of its counters is left out). Nothing to read
where K3 did not run or the program counted no slot."""

from portbench import program_trace
from portbench.harness import PEAK_BYTES_PER_S

K3_KERNELS = ("bin_kernel", "plan_kernel", "tile_kernel")


def k3_bytes(slots: int, grids: int, bins: int, height: int,
             width: int) -> int:
    return 17 * slots + 4 * grids * bins * height * width


def read(cell, res):
    t = program_trace.read(cell, res)
    slots = t.counters.get("serve.event_slots", 0) if t else 0
    if slots <= 0:
        return None
    k3 = [(a, b, n) for a, b, n in t.kernels
          if any(k in n for k in K3_KERNELS)]
    seconds = sum(b - a for a, b, _ in k3) / 1e6
    grids = sum(1 for _, _, n in k3 if "tile_kernel" in n)
    if seconds <= 0 or grids == 0:
        return None
    program = res["program"]
    height, width = program["loader"].get("resolution", (480, 640))
    bins = program["data"].get("num_frames", 10)
    bound = k3_bytes(slots, grids, bins, height, width) / PEAK_BYTES_PER_S
    return 100.0 * bound / seconds
