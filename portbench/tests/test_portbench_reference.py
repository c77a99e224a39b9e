"""Each configuration's plain reference against the program on the CPU at a
small size, in float64: the model in both modes (drop-path drawn alike),
the events front, the input path's decisions (the epoch's shuffle, the
crop and flips) and AdamW's update."""


import numpy as np
import pytest
import torch

from conftest import tiny_cell

from portbench.drivers import common
from portbench.harness import seeded_state
from portbench.reference import build as ref_build
from portbench.reference import train_ref


def _pair(cell):
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    program = common.program_config(cell)
    mc, swin, spiking = build_configs(program)
    prog = get_model(program["model"]["name"], mc, swin, spiking,
                     input_bins=common.chunk_bins(program))
    ref = ref_build.build(program)
    state = seeded_state(prog.state_dict(), cell.seed, "cpu")
    prog.load_state_dict(state)
    ref.load_state_dict(seeded_state(ref.state_dict(), cell.seed, "cpu"))
    return program, prog.double(), ref.double()


@pytest.mark.parametrize("train", [False, True])
def test_stt_model_equals_the_program(train):
    cell = tiny_cell("stt_train_b8")
    program, prog, ref = _pair(cell)
    x = torch.randn(2, common.chunk_bins(program), 72, 96,
                    dtype=torch.float64) * (torch.rand(2, 1, 72, 96) < 0.3)
    for m in (prog, ref):
        m.train(train)
        g = torch.Generator().manual_seed(5)
        for mod in m.modules():
            if hasattr(mod, "drop_path_generator"):
                mod.drop_path_generator = g
    fp, fr = prog(x)["flow"], ref(x)["flow"]
    assert len(fp) == len(fr) == 3
    for a, b in zip(fp, fr):
        assert torch.equal(a, b)


@pytest.mark.parametrize("workload", ["en4_serve_events_b8",
                                      "stt_train_b8"])
def test_weights_named_alike(workload):
    _, prog, ref = _pair(tiny_cell(workload))
    assert set(prog.state_dict()) == set(ref.state_dict())
    for k, v in prog.state_dict().items():
        assert torch.equal(v, ref.state_dict()[k]), k


@pytest.mark.parametrize("rows", [1, 2])
def test_en4_model_equals_the_program(rows):
    """The frozen spiking copy (its PSN and attention in plain forms) gives
    the program's flows bit for bit, a batch's rows refolded apart as the
    server runs them."""
    program, prog, ref = _pair(tiny_cell("en4_serve_events_b8"))
    for m in (prog, ref):
        for mod in m.modules():
            if hasattr(mod, "rows_apart"):
                mod.rows_apart = True
    g = torch.Generator().manual_seed(rows)
    x = torch.rand(rows, 10, 2, 72, 96, generator=g, dtype=torch.float64) \
        * (torch.rand(rows, 10, 2, 72, 96, generator=g) < 0.1)
    with torch.no_grad():
        fp, fr = prog(x)["flow"], ref(x)["flow"]
    assert len(fp) == len(fr) == 4
    for a, b in zip(fp, fr):
        assert torch.equal(a, b)


def test_events_front_equals_the_programs():
    """The plain events front gives the program's model input (its float32
    packing of the microsecond times aside)."""
    from portbench import scene
    from portbench.reference import events as ref_events
    from sdformerflow_tpu_torch.training.train_step import _model_input
    cell = tiny_cell("en4_serve_events_b8")
    program = common.program_config(cell)
    reqs = scene.events(2, cell.seed, cell.traffic["scene"], device="cpu")
    n = max(len(r["x"]) for r in reqs)
    buf = {k: torch.zeros(2, n, dtype=torch.float64) for k in "xytp"}
    valid = torch.zeros(2, n, dtype=torch.bool)
    for b, r in enumerate(reqs):
        for k in "xytp":
            buf[k][b, :len(r[k])] = torch.from_numpy(
                np.asarray(r[k], np.float64))
        valid[b, :len(r["x"])] = True
    res = program["loader"]["resolution"]
    x = _model_input({k: v.float() for k, v in buf.items()} | {
        "valid": valid}, None, dict(num_bins=10, height=res[0],
                                    width=res[1]),
        tuple(program["loader"]["crop"]), encoding="voxel", polarity=True,
        norm_input="minmax", spike_th=None, per_row=True)
    for b, r in enumerate(reqs):
        want = ref_events.model_input(r, program, "cpu")
        assert float((x[b].double() - want).norm() / want.norm()) < 1e-3


def test_epoch_order_is_the_batchers():
    from sdformerflow_tpu_torch.data.dsec import batch_iterator

    class Items:
        def __len__(self):
            return 37

        def __getitem__(self, i):
            return (np.full((1, 2, 2), i, np.float32),
                    np.zeros((2, 2), np.float32),
                    np.zeros((2, 2, 2), np.float32))
    got = [b["chunk"][:, 0, 0, 0].astype(int).tolist()
           for b in batch_iterator(Items(), 4, shuffle=True, seed=99)]
    want = [list(b) for b in train_ref.epoch_order(37, 4, 99)]
    assert got == want


def test_augmentation_decisions_are_the_programs():
    from sdformerflow_tpu_torch.data.augmentation import \
        build_train_augmentation
    program = tiny_cell("stt_train_b8").config["program"]
    loader = program["loader"]
    aug = build_train_augmentation(loader["augment"], loader["augment_prob"],
                                   crop=(40, 56))
    chunk = torch.randn(2, 4, 60, 80)
    flow = torch.randn(2, 2, 60, 80)
    mask = (torch.rand(2, 1, 60, 80) < 0.5).float()
    for seed in range(12):
        a = aug(torch.Generator().manual_seed(seed), chunk, flow, mask)
        b = train_ref.augment(torch.Generator().manual_seed(seed), chunk,
                              flow, mask, loader["augment"],
                              loader["augment_prob"], (40, 56))
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_adamw_equals_the_programs():
    from sdformerflow_tpu_torch.training.optim import build_optimizer
    g = torch.Generator().manual_seed(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    p_prog = {n: torch.randn(s, generator=g, dtype=torch.float64)
              for n, s in shapes.items()}
    p_ref = {n: t.clone() for n, t in p_prog.items()}
    for clip in (None, 0.5):
        pp = {n: torch.nn.Parameter(t.clone()) for n, t in p_prog.items()}
        pr = {n: t.clone() for n, t in p_ref.items()}
        opt = build_optimizer(list(pp.items()), lr=1e-3, weight_decay=0.01,
                              clip_grad=clip, milestones=())
        ref = train_ref.AdamW(pr, lr=1e-3, wd=0.01, clip=clip)
        for step in range(3):
            grads = {n: torch.randn(s, generator=g, dtype=torch.float64)
                     for n, s in shapes.items()}
            for n, p in pp.items():
                p.grad = grads[n].clone()
            opt.step()
            ref.step(grads)
            for n in shapes:
                torch.testing.assert_close(pp[n].detach(), pr[n], rtol=1e-12,
                                           atol=1e-14)


def test_flow_loss_equals_the_programs():
    from sdformerflow_tpu_torch.losses import flow_loss_supervised
    g = torch.Generator().manual_seed(1)
    flows = [torch.randn(3, 2, 8, 9, generator=g, dtype=torch.float64)
             for _ in range(3)]
    label = torch.randn(3, 2, 8, 9, generator=g, dtype=torch.float64)
    mask = (torch.rand(3, 1, 8, 9, generator=g) < 0.4).double()
    assert torch.equal(flow_loss_supervised(flows, label, mask),
                       train_ref.flow_loss(flows, label, mask))
