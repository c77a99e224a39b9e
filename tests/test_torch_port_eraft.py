"""E-RAFT (``models/eraft.py``) against the plain reference the benchmark
judges it by (``portbench/reference/models/ERAFT.py``), in float64 on the
CPU at small sizes on seeded weights (``portbench.harness.seeded_state``,
one draw for both through RAFT's parameter names): each block, the whole
forward, and the server's two-window events requests.

Tolerances: the port and the reference compute the same float64 functions
in other orders (``grid_sample`` against a hand-written bilinear gather,
``matmul`` against ``einsum``, ``F.batch_norm`` against the formula), so
they differ by float64 rounding, a few 1e-16 of the largest value; each
test allows 1e-12 of the largest reference value for a block and 1e-10 for
a whole forward of 12 steps (the recurrence carries rounding through the
steps). The server against the eval step runs the same operations on the
same grids and must agree bit for bit.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from portbench.harness import seeded_state
from portbench.reference.models import ERAFT as ref_eraft
from sdformerflow_tpu_torch.models import eraft
from sdformerflow_tpu_torch.training.config import load_config

SEED = 2 ** 33 + 23
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _twins(port, ref, seed=SEED):
    """The two modules with one seed's weights, in float64."""
    assert set(port.state_dict()) == set(ref.state_dict())
    port.load_state_dict(seeded_state(port.state_dict(), seed, "cpu"))
    ref.load_state_dict(seeded_state(ref.state_dict(), seed, "cpu"))
    return port.double().eval(), ref.double().eval()


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _sparse(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g, dtype=torch.float64)
    return x * (torch.rand(*shape, generator=g) < 0.2)


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_encoder_equals_reference(norm):
    out = 256
    port, ref = _twins(eraft.BasicEncoder(out, norm, 15),
                       ref_eraft.Encoder(out, norm, 15))
    x = _sparse(2, 15, 32, 48)
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert a.shape == b.shape == (2, out, 4, 6)
    assert _gap(a, b) < 1e-12


def test_corr_pyramid_and_lookup_equal_reference():
    g = torch.Generator().manual_seed(1)
    f1, f2 = (torch.randn(2, 256, 16, 20, generator=g, dtype=torch.float64)
              for _ in range(2))
    pyr = eraft.corr_pyramid(f1, f2)
    ref = ref_eraft.pyramid(ref_eraft.volume(f1, f2))
    assert [tuple(p.shape[-2:]) for p in pyr] == [(16, 20), (8, 10), (4, 5),
                                                  (2, 2)]
    for p, r in zip(pyr, ref):
        assert _gap(p.view(r.shape), r) < 1e-12
    # matches on the grid, inside, across the border and far outside it
    coords = eraft.coords_grid(2, 16, 20, dtype=torch.float64, device="cpu")
    coords = coords + 6 * torch.randn(2, 2, 16, 20, generator=g,
                                      dtype=torch.float64)
    coords[0, 0, 0, :4] = torch.tensor([-5.3, -0.5, 19.5, 31.0])
    coords[1, 1, 3, :3] = torch.tensor([-9.0, 15.7, 40.2])
    a, b = eraft.lookup(pyr, coords), ref_eraft.sample(ref, coords)
    assert a.shape == b.shape == (2, 324, 16, 20)
    assert _gap(a, b) < 1e-12
    # x = 31: level 0 (width 20) all outside, level 2 (at 7.75) partly in
    assert float(a[0, :81, 0, 3].abs().sum()) == 0.0
    assert float(a[0, 162:243, 0, 3].abs().sum()) > 0.0


def test_lookup_keeps_rafts_offset_order():
    """Channel 9 i + j of level 0 at an integer match (x, y) is the volume
    at (x + o[i], y + o[j]): RAFT's stack(meshgrid(dy, dx)) adds its first
    component, dy's values, to x."""
    g = torch.Generator().manual_seed(2)
    f1, f2 = (torch.randn(1, 256, 12, 14, generator=g, dtype=torch.float64)
              for _ in range(2))
    pyr = eraft.corr_pyramid(f1, f2)
    coords = eraft.coords_grid(1, 12, 14, dtype=torch.float64, device="cpu")
    got = eraft.lookup(pyr, coords)
    vol = pyr[0].view(12, 14, 12, 14)          # [y1, x1, y2, x2]
    y, x = 5, 6
    for i in range(9):
        for j in range(9):
            want = vol[y, x, y + j - 4, x + i - 4]
            assert float(got[0, 9 * i + j, y, x]) == pytest.approx(
                float(want), rel=1e-12, abs=1e-12)
    assert eraft.lookup_offsets(4, dtype=torch.float64,
                                device="cpu")[0, 8].tolist() == [-4.0, 4.0]


def test_update_block_equals_reference():
    port, ref = _twins(eraft.BasicUpdateBlock(), ref_eraft.Update())
    g = torch.Generator().manual_seed(3)
    net = torch.tanh(torch.randn(2, 128, 8, 10, generator=g,
                                 dtype=torch.float64))
    inp = torch.relu(torch.randn(2, 128, 8, 10, generator=g,
                                 dtype=torch.float64))
    corr = torch.randn(2, 324, 8, 10, generator=g, dtype=torch.float64)
    flow = 3 * torch.randn(2, 2, 8, 10, generator=g, dtype=torch.float64)
    with torch.no_grad():
        a, b = port(net, inp, corr, flow), ref(net, inp, corr, flow)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        assert _gap(x, y) < 1e-12


def test_convex_upsampling_equals_reference():
    g = torch.Generator().manual_seed(4)
    flow = torch.randn(2, 2, 6, 7, generator=g, dtype=torch.float64)
    mask = torch.randn(2, 576, 6, 7, generator=g, dtype=torch.float64)
    a = eraft.upsample_flow(flow, mask)
    b = ref_eraft.convex_up(flow, mask)
    assert a.shape == (2, 2, 48, 56)
    assert _gap(a, b) < 1e-12
    # a constant flow upsamples to 8 times itself (the weights sum to 1)
    const = torch.full((1, 2, 6, 7), 0.5, dtype=torch.float64)
    up = eraft.upsample_flow(const, mask[:1])
    assert torch.allclose(up[..., 8:-8, 8:-8],
                          torch.full_like(up[..., 8:-8, 8:-8], 4.0))


@pytest.mark.parametrize("iters,rows", [(3, 1), (12, 2)])
def test_whole_forward_equals_reference(iters, rows):
    """At 128x160, the smallest size whose fourth level is 2x2 or more
    (RAFT divides by the level's width less one)."""
    port, ref = _twins(eraft.ERAFT(15, iters), ref_eraft.ERAFT(15, iters))
    x = _sparse(rows, 30, 128, 160, seed=iters)
    with torch.no_grad():
        a, b = port(x)["flow"], ref(x)["flow"]
    assert len(a) == len(b) == 1 and a[0].shape == (rows, 2, 128, 160)
    assert float(b[0].abs().max()) > 1.0
    assert _gap(a[0], b[0]) < 1e-10


def test_forward_pads_to_32():
    port, ref = _twins(eraft.ERAFT(15, 2), ref_eraft.ERAFT(15, 2))
    x = _sparse(1, 30, 120, 150, seed=5)
    with torch.no_grad():
        a, b = port(x)["flow"][-1], ref(x)["flow"][-1]
    assert a.shape == (1, 2, 120, 150)
    assert _gap(a, b) < 1e-10


def _config(h=128, w=160, iters=2):
    cfg = load_config(os.path.join(ROOT, "configs", "dsec_eraft.yaml"))
    cfg["loader"]["resolution"] = [h, w]
    cfg["model"]["iters"] = iters
    return cfg


def _window(n, h, w, seed, t0):
    rng = np.random.default_rng(seed)
    return {"x": rng.integers(0, w, n).astype(np.uint16),
            "y": rng.integers(0, h, n).astype(np.uint16),
            "t": (t0 + np.sort(rng.integers(0, 100_000, n))).astype(np.int64),
            "p": rng.integers(0, 2, n).astype(np.uint8)}


def _model(cfg):
    from sdformerflow_tpu_torch.training.export import build_inference_state
    model = build_inference_state(cfg, device="cpu")
    model.load_state_dict(seeded_state(model.state_dict(), SEED, "cpu"))
    return model.double()


@pytest.mark.parametrize("devices", [["cpu", "cpu"], None])
def test_server_pair_request_equals_eval_step(devices):
    """A two-window events request through ``FlowServer`` gives the eval
    step's flow on the two windows' grids, each window voxelized over its
    own span and normalized on its own; both windows' slots are counted.
    Batched (the padded row included), each row's windows are normalized
    apart and the flow is the step's bit for bit; one request a forward,
    each window is normalized over the batch's entries of that window,
    the same entries summed in another order (1e-5 of the largest flow)."""
    from sdformerflow_tpu_torch import native
    from sdformerflow_tpu_torch.ops.normalization import normalize_nonzero_std
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.export import step_kwargs
    from sdformerflow_tpu_torch.training.train_step import (make_eval_step,
                                                            voxelize_batch)
    cfg = _config()
    h, w = cfg["loader"]["resolution"]
    model = _model(cfg)
    old = _window(3000, h, w, 1, 5_000_000)
    new = _window(5000, h, w, 2, 5_100_000)
    grids = []
    for win in (old, new):
        x, y, t, p, valid = native.pack_window_plain(
            win["x"], win["y"], win["t"], win["p"], 8192, t0=0.0)
        grids.append(voxelize_batch(
            {k: torch.from_numpy(v)[None] for k, v in
             zip("xytp", (x, y, t, p))} | {"valid": torch.from_numpy(
                 valid)[None]}, num_bins=15, height=h, width=w))
    chunk = torch.cat(grids, dim=1)
    step = make_eval_step(copy.deepcopy(model),
                          **step_kwargs(cfg, bf16=False, events=False),
                          per_row=True)
    want = step(chunk)[-1][0].numpy()
    with FlowServer(cfg, model=model, device="cpu", bf16=False,
                    devices=devices, batch_window_s=0.0) as server:
        got = server.infer({"old": old, "new": new})
        stats = server.stats()
        enc = server._events_step.module
    assert got.shape == (2, h, w)
    rows = 1 if devices is None else len(devices)
    assert stats["serve.event_slots"] == rows * (4096 + 8192)
    if devices is None:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return
    np.testing.assert_array_equal(got, want)
    # each window normalized over its own nonzero entries
    x = enc.input_kw
    assert x["windows"] == 2 and x["norm_input"] == "std"
    from sdformerflow_tpu_torch.training.train_step import _model_input
    got_in = _model_input(chunk, None, None, None, **x)
    for k, g in enumerate(grids):
        np.testing.assert_array_equal(got_in[:, 15 * k:15 * (k + 1)].numpy(),
                                      normalize_nonzero_std(g).numpy())


def test_one_window_request_refused():
    from sdformerflow_tpu_torch.serving import FlowServer
    cfg = _config(iters=1)
    with FlowServer(cfg, model=_model(cfg), device="cpu",
                    bf16=False) as server:
        with pytest.raises(ValueError, match='"old"'):
            server.infer(_window(100, 128, 160, 3, 0))


def test_stt_still_refuses_events():
    """STTFlowNet of two chunks refuses raw events, one window or two, as
    JAX's server does."""
    from sdformerflow_tpu_torch.serving import FlowServer
    cfg = load_config(os.path.join(ROOT, "configs", "test_tiny_ann.yaml"))
    cfg["data"]["num_chunks"] = 2
    win = _window(100, 64, 96, 4, 0)
    with FlowServer(cfg, device="cpu", bf16=False) as server:
        with pytest.raises(ValueError, match="send voxel chunks"):
            server.infer(win)
        with pytest.raises(ValueError, match="not a window pair"):
            server.infer({"old": win, "new": win})


def test_mdr_two_chunk_step_normalizes_the_chunk_whole(tmp_path):
    """A model of one event window with a chunk of two (MDR SDformerFlow,
    ``train_mdr_sdformerflow.yaml``: ``num_chunks`` 2, min-max) is served
    and exported normalizing its 20 bins at once, as the trainer's and
    ``eval_mvsec``'s eval step does (``train_loop``'s keywords): the two
    window normalization is the model's (``event_windows``), not the
    chunk count's. The served and the exported flow equal that step's bit
    for bit (the same operations on the same chunk); normalizing each half
    on its own moves the flow. At the tiny config's widths and crop."""
    from sdformerflow_tpu_torch.models.registry import randomize_
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.export import (build_inference_state,
                                                        export_flow_model,
                                                        load_exported)
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "train_mdr_sdformerflow.yaml"))
    tiny = load_config(os.path.join(ROOT, "configs", "test_tiny_snn.yaml"))
    cfg["swin_transformer"] = tiny["swin_transformer"]
    cfg["model"]["base_num_channels"] = tiny["model"]["base_num_channels"]
    cfg["loader"]["crop"] = tiny["loader"]["crop"]
    cfg["loader"]["resolution"] = tiny["loader"]["resolution"]
    assert cfg["data"]["num_chunks"] == 2
    assert cfg["model"]["norm_input"] == "minmax"
    model = build_inference_state(cfg, device="cpu")
    randomize_(model, torch.Generator().manual_seed(0))
    # the later half's events an order of magnitude stronger, so that
    # min-max over each half differs from min-max over the chunk
    chunk = _sparse(1, 20, *cfg["loader"]["crop"], seed=7).float()
    chunk[:, 10:] *= 10
    kw = dict(encoding="voxel", polarity=True, norm_input="minmax",
              spike_th=None)
    want = make_eval_step(model, **kw)(chunk)[-1]
    with FlowServer(cfg, model=model, device="cpu", bf16=False,
                    batch_window_s=0.0) as server:
        served = server.infer(chunk[0].numpy())
    np.testing.assert_array_equal(served, want[0].numpy())
    export_flow_model(cfg, model, str(tmp_path), bf16=False, device="cpu")
    exported = load_exported(str(tmp_path))[1]["voxel"](chunk)
    np.testing.assert_array_equal(exported.numpy(), want.numpy())
    apart = copy.deepcopy(model)
    apart.event_windows = 2
    moved = make_eval_step(apart, **kw)(chunk)[-1]
    assert float((moved - want).abs().max()) > 1e-3 * float(
        want.abs().max())
