"""A run with the timed path broken underneath must come out not correct:
the harness's look for a chip skipped, every other part of a run driven
(set-up, window, check) at a small size on the CPU. One case for each fault
a cell can have: an answer altered where it is produced (in the server's
hand-back, at the model's output, and inside it: a PSN site's spikes, an
attention block's output, a residual join), answers (half of a batch)
never given, a step that leaves the state unchanged, half of each batch
left out of a step (the mean over the rest). One chip: no exchange between
chips to leave out."""

from concurrent.futures import Future

import numpy as np
import pytest

from conftest import tiny_cell

from portbench import run


def _correct(cell):
    return run.result_line(cell, run.execute(cell), "cpu")


def _wrap_submit(monkeypatch, alter):
    from sdformerflow_tpu_torch.serving import FlowServer
    submit = FlowServer.submit
    count = {"n": 0}

    def broken(self, request):
        inner = submit(self, request)
        outer = Future()
        k = count["n"]
        count["n"] += 1

        def done(f):
            if f.exception() is not None:
                outer.set_exception(f.exception())
            else:
                alter(outer, f.result(), k)
        inner.add_done_callback(done)
        return outer
    monkeypatch.setattr(FlowServer, "submit", broken)


SERVE = "en4_serve_events_b8"


def _fails_on(line, name):
    c = line["checks"][name]
    return not line["correct"] and c["value"] > c["limit"]


def test_serve_sound_run_is_correct():
    line = _correct(tiny_cell(SERVE))
    assert line["correct"], line["checks"]


def test_serve_answer_altered(monkeypatch):
    _wrap_submit(monkeypatch, lambda out, flow, k: out.set_result(
        np.roll(flow, 1, axis=-1) if k > 8 else flow))
    assert _fails_on(_correct(tiny_cell(SERVE)), "served_gap")


def test_serve_half_the_answers_never_given(monkeypatch):
    def alter(out, flow, k):
        if k > 8 and k % 2:     # past the warm-up, which would fail loudly
            out.set_exception(RuntimeError("row dropped"))
        else:
            out.set_result(flow)
    _wrap_submit(monkeypatch, alter)
    line = _correct(tiny_cell(SERVE))
    assert not line["correct"] and line["failed"] > 0


def test_serve_flow_altered_at_the_model(monkeypatch):
    from sdformerflow_tpu_torch.models import snn_flownet
    forward = snn_flownet.SpikingformerFlowNet.forward

    def scaled(self, *a, **kw):
        out = forward(self, *a, **kw)
        out["flow"][-1] = out["flow"][-1] * 1.1
        return out
    monkeypatch.setattr(snn_flownet.SpikingformerFlowNet, "forward", scaled)
    assert _fails_on(_correct(tiny_cell(SERVE)), "flow_gap")


def test_serve_spikes_altered_at_one_site(monkeypatch):
    from sdformerflow_tpu_torch.models import spiking_layers
    psn = spiking_layers.affine_psn

    def flipped(x, *a, **kw):
        s = psn(x, *a, **kw)
        if x.shape[-1] == 192:          # the sites of one width only
            s = s.clone()
            s.view(-1)[::50] = 1 - s.view(-1)[::50]
        return s
    monkeypatch.setattr(spiking_layers, "affine_psn", flipped)
    assert _fails_on(_correct(tiny_cell(SERVE)), "spike_flips")


def test_serve_attention_altered(monkeypatch):
    from sdformerflow_tpu_torch.models import spiking_swin
    attn = spiking_swin.fused_qk_attention

    def shifted(x, *a, **kw):
        return attn(x.roll(1, dims=1), *a, **kw)
    monkeypatch.setattr(spiking_swin, "fused_qk_attention", shifted)
    assert _fails_on(_correct(tiny_cell(SERVE)), "attention_gap")


def test_serve_residual_join_dropped(monkeypatch):
    from sdformerflow_tpu_torch.models import spiking_layers
    monkeypatch.setattr(spiking_layers.MSResBlock, "join",
                        lambda self, out, identity: out)
    assert _fails_on(_correct(tiny_cell(SERVE)), "potential_gap")


def test_train_sound_run_is_correct():
    line = _correct(tiny_cell("stt_train_b8"))
    assert line["correct"], line["checks"]


def test_train_state_unchanged(monkeypatch):
    from sdformerflow_tpu_torch.training import optim
    monkeypatch.setattr(optim.FlatOptimizer, "_update",
                        lambda self, params, g, g_norm: None)
    line = _correct(tiny_cell("stt_train_b8"))
    assert not line["correct"]
    assert line["checks"]["move_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch(monkeypatch):
    from sdformerflow_tpu_torch.training import train_step
    make = train_step.make_train_step

    def halved(*a, **kw):
        step = make(*a, **kw)

        def run_half(batch):
            n = batch["chunk"].shape[0] // 2
            return step({k: v[:n] for k, v in batch.items()})
        return run_half
    monkeypatch.setattr(train_step, "make_train_step", halved)
    line = _correct(tiny_cell("stt_train_b8"))
    assert not line["correct"]
    assert line["checks"]["loss_gap"]["value"] > line["checks"]["loss_gap"][
        "limit"]


def test_train_gradient_altered(monkeypatch):
    from sdformerflow_tpu_torch.training import optim
    step = optim.FlatOptimizer.step

    def doubled(self, group=None):
        for p in self.named.values():
            if p.grad is not None:
                p.grad.mul_(2.0)
        return step(self, group)
    monkeypatch.setattr(optim.FlatOptimizer, "step", doubled)
    line = _correct(tiny_cell("stt_train_b8"))
    assert not line["correct"]
    assert line["checks"]["grad_gap"]["value"] > line["checks"]["grad_gap"][
        "limit"]


def _stt_serve_cell():
    """An ANN served as a cell of the voxel kind would be (no such cell is
    in BENCHMARK.json: the whole-flow check that judges it, against the
    reference's bf16 and float32 flows, runs here at a small size)."""
    cell = tiny_cell("stt_train_b8")
    cell.traffic = {"driver": "serve", "kind": "voxel", "streams": 4,
                    "stream_hz": 2.0, "rows": 2, "batch_window_s": 0.002,
                    "max_pending": 8, "pool": 4, "sample": 3,
                    "scene": cell.traffic["scene"]}
    cell.limits = {"flow_gap_ratio": 2.5, "unchecked": 0}
    cell.end_to_end = [{"name": "serve_latency_p95_ms", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}]
    return cell


def test_ann_serve_sound_and_altered(monkeypatch):
    assert _correct(_stt_serve_cell())["correct"]
    _wrap_submit(monkeypatch, lambda out, flow, k: out.set_result(
        np.roll(flow, 1, axis=-1) if k > 8 else flow))
    assert _fails_on(_correct(_stt_serve_cell()), "flow_gap_ratio")
