#!/usr/bin/env python3
"""Drive the PyTorch port's serving, train and DSEC evaluation paths, its
MDR / MVSEC slice, its raw-data preparation, rematerialization and tensor
parallelism, the last layers and the exported programs of every family
once on one NVIDIA H100, for the en4 SNN, the rest of the SNN zoo and the
ANN family.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build every kernel from the sources in the checkout - K1, K2 and K2b
   (one source), K3 and K4 by nvcc and the event packer by g++, in
   parallel, and K2's first, Triton version (phase 3's yardstick) meanwhile
   - and print the build seconds and ptxas' register and memory report;
   read the SASS of K1 and K4 (cuobjdump) and fail unless every bf16
   tensor-core instantiation holds HGMMA (wgmma) instructions;
2. K1 vs its plain twin at the attention shapes the en4 forward gives it,
   float32 and bfloat16: bitwise on dyadic inputs, flipped-spike share on
   Gaussian and on real captured inputs; timings beside the bound and
   beside K1's first, CUDA-core version on the same input;
3. K2 vs its plain twin at every PSN site shape of the forward, same checks;
   timed alone (prepared launches), with its wrapper and beside its first,
   Triton version alone, per shape against the bound;
4. K3's four entries vs their plain twins at 480x640, 10 and 15 bins, 2^20
   event slots: bitwise on dyadic events (uniform and skewed), within
   1e-4 on three synthetic windows (uniform continuous x/y, uniform
   integer x/y, and an invented skew: 9/10 of the events on 1/10 of the
   rows); each timed through its wrapper, alone and in a CUDA graph beside
   the first, atomic K3 in the same run and the bound, with device time by
   pass;
5. the voxel path: a full-width MS_SpikingformerFlowNet_en4 FlowServer
   (288x384, base 96, depths (2,2,6,2), window (2,9,9), T=10, bf16,
   weights from a seeded torch.Generator) answers voxel requests; launch
   counts, flow shapes, latency and the card's busy time per request
   (profiler) are checked and printed;
6. the raw-events path on the same server: synthetic windows (DSEC's
   dtypes, x/y uniform random integers over the frame) of
   0.6-1.0 x 2^20 events at 480x640 (and 4 in the 2^21 bucket) are packed,
   voxelized by K3, center-cropped to 288x384 and run through the forward;
   K3 +1 and K1 +12 launches per request; on exact (dyadic) windows the
   events flow equals the voxel flow of the plain twin's grid bit for bit;
   latency, throughput and the pieces of a request (host pack, H2D, K3,
   forward) are printed, with voxelize_batch beside its form before K3's
   redesign (atomic K3) and the two kernels alone on the same window;
7. kernel path vs plain path: float32 forwards on the card (TF32 off) with
   the kernels and with the plain twins, at 96x128 and at full width. Each
   kernel launch of the kernel path is held against its plain twin on the
   same input (flipped-spike share); with no flip the two forwards must be
   identical. Printed beside: the AEE of the plain path with one spike
   flipped, and of both paths to a float64 CPU forward;
8. K2b, the PSN site's whole VJP (dx and the dW, db, dscale, dshift
   reductions): one full-width float32 en4 train step (288x384, batch 1)
   holds each K2b launch against its plain twin on the captured (x, g) and
   counts K2 and K2b launches (one each per PSN site); then every site
   shape of that step, float32 and bfloat16, is checked on dyadic and
   Gaussian inputs, two launches must give the same bits, and it is timed
   alone, with its wrapper, beside the twin, the PyTorch reductions the
   earlier K2b needed (``_param_grads``) and the bound;
9. the train slice: the trainer entry point (``train_dsec.main``) on the en4
   config with ``--synthetic`` (480x640 chunks, random crop to 288x384,
   flips), float32 with TF32 off, batch 1, 14 steps: step times (host
   clock, a sync per step), launches per step, finite losses, moved
   parameters and BN statistics, metrics.jsonl, and a checkpoint that
   restores to identical tensors; the card's busy time per step
   (profiler) and the peak memory; 2 steps of the raw-events train step
   (480x640 events, K3, crop); and a 96x128 A/B, one train step with the
   kernels and one with the plain twins from the same state and batch;
10. the fused-embed eval path and the s2d embed: K4 (the channels-second
   conv + BN affine) at the 8 launch shapes of a full-width fused embed,
   float32 and bfloat16, bitwise on dyadic inputs, within 1e-5 (f32) or one
   bfloat16 rounding of the twin's largest on Gaussian ones, timed beside
   its twin, the bound, cuDNN and K4's first, CUDA-core version; K4a at the
   embed's 6 PSN sites and K2c at [10, 27648, 96] and [10, 6912, 96] (same
   checks as K2); then
   ``make_eval_step(fused_embed=True, num_steps=10)`` on the en4 bf16
   model at 288x384: K4 8, K4a 6 and K1 12 launches a request, K2 6 fewer
   than the module path's; latency over 32 requests and device busy, fused
   and module path interleaved; ``FlowServer(s2d=True)`` beside
   ``s2d=False`` the same way; and float32 A/Bs (96x128 and full width for
   the fused embed, 96x128 for s2d) holding each K4 and K4a launch against
   its twin and every spike site of the two paths against each other: with
   no spike differing, the flows must be equal;
11. the MDR / MVSEC geometry (configs/train_mdr_sdformerflow.yaml: T=5,
   window (2, 8, 8), 256x256, full width), where stage 4 has an odd window
   count: a bfloat16 eval forward, K1 at the even-M stages and the
   raw-refold attention at stage 4, each K1 and K2 launch held against its
   twin and the flow against the plain path's; and one float32 train step
   with each K2b launch (T = 5 and T = 2) held against its twin;
12. the DSEC evaluation protocol (``eval_dsec.main``) at full en4 width on
   a DSEC tree written at 480x640 (4 ``valid`` and 2 ``train`` windows of
   0.6-1.0 x 2^20 events in DSEC's dtypes on 45% of the frame, exact
   (dyadic) to voxelize, as pickled event lists and as the plain twin's
   10-bin grids; ~70% valid masks; the valid GT a first pass's flow plus
   noise, so that no metric saturates), from the seeded en4 weights saved
   under the reference's state_dict names (``module.`` prefix, skipped
   keys), bf16: the voxel layout with ``metrics.mask_events`` off (writing
   the submission PNGs) and on, and the event layout; each run's
   ``results.json`` has the six metrics over 4 windows, each within 1e-9
   of float64 numpy formulas written out here, fed the same flows,
   labels, masks and chunks; K1 12, K2 45 (and K3 1, event layout)
   launches a batch; the event layout equals the voxel layout, the event
   mask moves the metrics, the PNGs read back within 1/128 px; evaluation
   windows/s over 32 windows (the valid split cycled, the first batch
   left out; host clock, reads included), and a batch split into reading,
   host-to-device copy and step, with the card's busy time (profiler); the
   trainer
   (``train_dsec.main``) 2 float32 steps from each layout of the tree (K2b
   93 a step at 288x384); ``eval_dsec --ckpt`` and
   ``FlowServer(ckpt=...)`` on the trainer's checkpoint;
13. the ANN family, which runs none of the kernels (every launch count is
   set to 0 at its start and must be 0 at its end): STTFlowNet at the
   full width of
   ``configs/train_dsec_stt_voxel.yaml`` (base 96, depths (2,2,6),
   swin-v2, PatchEmbedLocal, patch (10,4,4), window (2,9,9), 20 bins,
   288x384, seeded random weights): the float32 forward (TF32 off) against
   the float64 forward of the same weights, within 1e-4 of the largest
   flow; ``FlowServer`` in bf16 on voxel requests (latency over 32 one at
   a time, windows/s over 32 queued, device busy, the bf16 flows within a
   mean EPE of 5% of the mean |flow| of the float32 forward, an events
   request refused); what a batch-1 forward keeps for the backward and the
   step's peak, plain and under remat ``dots`` and ``all``, whose gradients
   must equal the plain step's (same drop-path seed) within 1e-5 of the
   largest in float32 and, the same steps in float64, within 1e-9 of each
   leaf's own largest; the trainer (``train_dsec --synthetic``, float32) at batch 8
   and 1, with and without remat ``dots``: step p50/p90 after 2 warm-up
   steps, peak memory, device busy per batch-8 step; ``eval_dsec.main`` in
   bf16 from a reference-named ``.pt`` on phase 12's 480x640 tree with a
   doubleseq split (two 10-bin chunks a window), the metrics within 1e-9
   of the float64 recompute, windows/s over the split cycled to 32
   windows (batch 1, the first left out); STTFlowNet_4en at the MDR geometry
   (``configs/train_mdr_stt_voxel.yaml``, 256x256, 10 bins): a bf16
   forward (EPE bound as above) and a float32 train step; MultiResUNet
   (base 32, 4 encoders, kernel 5) at 288x384: float32 against float64.
   The JSON line ``{"ann": ...}`` before the kernels line holds them.

14. the MDR / MVSEC slice through its entry points, on trees written here
   at 260x346 by the port's own writers (an MDR ``dt1/train`` split of 8
   scenes, each 4 ``.npz`` of 2^15 events over 30 ms and a ``.flo`` GT;
   MVSEC ``outdoor_day1`` and ``indoor_flying1`` ``.h5`` event files of
   2^15 events, each read back bit for bit, and ``flowgt_dt1`` /
   ``flowgt_dt4``): ``train_mdr`` with ``configs/train_mdr_sdformerflow.yaml``
   at full width (batch 4, f32, TF32 off, the augmentor, 2 epochs of 2
   steps, each validated on outdoor_day1 dt1): K2 and K2b launches each
   step, K1 in the validations, finite train and valid losses in
   ``metrics.jsonl``; the run's validation step on the batch-4 chunk it
   read with every K1 and K2 launch held against its plain twin, and a
   train step on the run's last batch (batch 4) with every K2b launch held
   against its float64 twin; the step's p50 / p90, device busy (profiler)
   and peak memory; ``train_mdr`` with ``configs/train_mdr_stt_voxel.yaml``
   for 2 steps, launching no kernel; ``eval_mvsec`` with
   ``configs/eval_mvsec.yaml`` on indoor_flying1 at dt1 and dt4 (32
   windows each, the en4 run's checkpoint): K1 10 and K2 53 launches a
   window, the run's eval step on its first window with every K1 and K2
   launch held against its plain twin, AEE, PE1-3, outlier and AAE within
   1e-9 of the float64 numpy recompute, windows/s over the 31 windows
   after the first and a window's read (h5 + host voxelizer), H2D and
   step + metrics ms. The JSON line ``{"mdr_mvsec": ...}`` before the
   kernels line holds them;
15. the deployment surface at full en4 width (288x384, bf16, batch 1, the
   seeded weights saved as a trainer checkpoint): ``export_model
   --event_buckets 1048576 --verify`` (the voxel and events programs through
   ``torch.export``, K1, K2 and K3 as custom ops; export seconds and
   artifact MB); the programs reloaded in a fresh process that imports
   ``training/export.py`` and no model code, on 8 voxel and 8 exact
   (dyadic) 0.6-1.0 x 2^20-event windows at 480x640: K1 12, K2 45 (+K3 1)
   launches a request, no plain twin, flows equal to the live step's bit
   for bit, p50 and device busy beside the live step's; what the custom
   ops would cost the eager voxel request (p50 and a wrapper call, op
   against straight launch, interleaved); ``serve --port 0`` as a process,
   the same 16 requests over HTTP through ``flow_client.post_flow`` equal
   to the in-process ``FlowServer.infer``, ``/stats``, ``/healthz``, then
   SIGTERM and a clean exit; ``bench_serving --requests 32``. The JSON
   line ``{"deploy": ...}`` before the kernels line holds them, and each
   kernel entry's ``launches_export`` the reloaded programs' launches;
16. the rest of the train slice and the re-expressions: the seeded en4
   weights folded (``training/bn_folding.py:fold_model``) and served in
   bf16 through ``make_eval_step`` at 288x384: K1 12 and K2 45 launches a
   request, each launch against its twin, every spike site against the
   unfolded model's (the first differing site within rounding, the AEE
   for information), p50 and device busy beside the unfolded forward's;
   one float32 en4 train step with ``cfg.s2d_train`` on the same weights
   (K2 and K2b 93 launches each, every K2 launch against its twin, K2b's
   dx at the 4 x 48-channel block-space head within 1e-5 of the float64
   twin's largest, the loss against the plain twins' step from the same
   state), K2 and K2b alone at that site beside their twins and bounds,
   and its p50 / p90, device busy and peak memory beside the base step's;
   ``train_dsec --synthetic --max_steps 4`` on the en4 config written
   anew with Adam, SGD + one_cycle and AdamW + num_acc 2, each with
   Rotation first in ``loader.augment``: finite losses, steps / num_acc
   updates, the median wait of a step for its prefetched batch. The JSON
   line ``{"train_slice": ...}`` before the kernels line holds them, and
   each kernel entry's ``launches_folded_forward`` and
   ``launches_s2d_train_step`` the launches of those runs;
17. the rest of the SNN zoo at full width, from the en4 config cut to 3
   stages (depths (2, 2, 6), heads (3, 6, 12), out_indices (0, 1, 2); base
   96, T = 10, window (2, 9, 9), PSN + BN, 288x384, seeded random weights):
   the SEW ``SpikingformerFlowNet`` (``Spiking_PatchEmbed_Conv_sfn``)
   served in bf16 through ``FlowServer`` on 16 voxel requests (K2 once at
   every PSN site, p50 / p90, device busy) with every K2 launch of a
   forward held against its twin and each site's firing rate inside
   (0, 1); its float32 train step at batch 1 (K2 and K2b once at every
   site, each K2 launch against its twin, each K2b launch's dx within
   1e-5 of the float64 twin's largest, p50 / p90 of 4 steps after 2,
   device busy, peak memory); ``MS_SpikingformerFlowNet``
   (``MS_Spiking_PatchEmbed_Conv_sfn``) in bf16: K1 10 launches a forward
   and K2, each against its twin; the SEW model with LIF (the JAX
   default neuron) in bf16: no kernel launch, timed for information;
   ``SpikingMultiResUNet`` with its registry defaults (base 32, 4
   encoders, kernel 5, upsample-conv decoders) in bf16: K2, each launch
   against its twin. The JSON line ``{"zoo": ...}`` before the kernels
   line holds them, and each kernel entry's ``launches_zoo`` the launches
   of those runs;
18. the neuron telemetry and the energy report at full en4 width (the
   seeded en4 weights with ``store_v_seq``, bf16, 288x384): one collecting
   request (``make_eval_step(collect_spike_rates=True)``) counted from 0 -
   K1 0 and K2 once at every PSN site, the attention's five included, and
   a rate and a membrane record a site, 12 of them ``attn_sn`` - beside a
   plain request (K1 12, K2 45); the same collecting request on the plain
   twins (``site_functions``), every site's rate within 1e-3 of the
   kernels'; K2 with its potential output at every PSN shape of that
   request against ``psn_neuron(return_v=True)``, float32 and bfloat16
   (spikes and h bit for bit on dyadic inputs; on Gaussian ones at most
   1e-3 of the spikes flipped and h within 1e-6 of the twin's largest
   |h|), timed with and without h, alone (in turns) and in a CUDA graph,
   beside the twin and the bound; the device busy time of a collecting
   and of a plain request; ``eval_dsec.main`` with
   ``--store_spike_rates --energy_report --store_membrane --log_attn`` on 2
   synthetic windows (the five artefacts, launches, rates, energy,
   attention-map shapes, windows/s) beside the same run without the flags.
   The JSON line ``{"telemetry": ...}`` before the kernels line holds
   them, and each kernel entry's ``launches_telemetry`` the collecting
   request's launches;
19. data parallelism: ``FlowServer(devices=[cuda:0] * 2)`` on the en4 bf16
   server coalescing queued voxel and 0.6-1.0 x 2^20-event requests two a
   batch: a batched forward's K1 and K2 outputs against its rows' batch-1
   forwards (at most 1e-3 of the spikes flipped), K3 a row of an events
   group against its twin, K1 12, K2 45 launches a batched forward and K3
   one a row, windows/s of 32 queued requests beside ``devices=None``;
   the en4 float32 train step of a global batch of 2 at 288x384 over two
   gloo ranks on the one card (``torch.multiprocessing``, one row a rank,
   the spiking swin blocks' attention on the gathered batch) against one
   process at batch 2 on the same card, whose neurons are given the DP
   step's spikes (so that only the float32 summation order differs, and a
   wrong gradient reduction shows): the loss, every neuron call's own
   spikes against the DP step's (at most 1e-3 flipped), the parameters'
   moves (SGD) and running statistics, K2 and K2b 93 launches a rank a
   step (and in the one process) each held against its twin, the collectives
   a step and their time, step p50, device busy and peak memory a rank;
   ``train_dsec --synthetic --max_steps 4`` plainly and under
   ``torch.distributed.run --nproc_per_node 1`` (NCCL), with deterministic
   kernels: metrics.jsonl and the checkpoint equal bit for bit. The JSON
   line ``{"dp": ...}`` before the kernels line holds them, and each
   kernel entry's ``launches_dp_step`` and ``launches_dp_serving`` the
   launches of those runs;
20. the raw-data preparation, on trees the port's HDF5 writer makes here
   (the card's host has no h5py): a raw DSEC sequence at 480x640
   (``events.h5`` in DSEC's dtypes, chunked with shuffle and deflate,
   ``ms_to_idx``, ``t_offset``; 3 GT windows of 100 ms and 0.6-1.0 x 2^20
   events; a rectify map that is not the identity, sending events into
   (-1, 0) and past the frame; 16-bit RGB flow PNGs with a valid channel)
   through ``preprocess_dsec --input voxel --make_lists``: K3 once a window
   (counted from 0 over the run), each launch within 1e-4 of its plain
   twin's largest value on the card, timed alone, in a graph and beside
   the twin and the bound; a window's read, voxel and write ms; the GT and
   mask tensors equal to the PNGs; then ``eval_dsec --max_batches 2`` (en4
   at full width, bf16: K1 12 and K2 45 a batch, metrics within 1e-9 of
   the float64 recompute) on the tree just written, and ``--input cnt``
   and ``list`` (no launch; counts and rows checked against the voxel
   run's rectified events). A raw MVSEC ``indoor_flying4`` at 260x346
   (events, images, GT flow at 20 Hz, chunked with deflate) through
   ``encode_mvsec`` at dt 1 and dt 4 (the event rows equal to the raw
   rows), then ``eval_mvsec --max_batches 2`` at each (K1 10, K2 53 a
   window). The JSON line ``{"data_prep": ...}`` before the kernels line
   holds them, and each kernel entry's ``launches_data_prep`` the launches
   of each run;
21. the rest of the training surface at en4 full width (float32, TF32
   off, batch 1, 288x384, the seeded weights): the train step plain and
   under remat ``dots`` and ``all`` from one state - K2 93 (plain) or 186
   (a recompute at every site) and K2b 93 launches, every neuron call's
   spikes equal to the plain step's and every recompute's to its
   forward's (0 differing), the gradients within 1e-5 of the plain step's
   largest, the memory the forward keeps, the peak, p50 / p90 after 2
   warm-up steps and device busy; ``train_dsec --synthetic --max_steps 2``
   with ``optimizer.remat: dots`` on the en4 config; then the step as dp1
   x tp2 (``parallel/sharding_rules.py``: 41 weights sharded over their
   output channels) on two gloo ranks on cuda:0 against one process given
   the TP step's spikes (``forced_spikes``): the loss within 1e-4, the
   gathered parameters' moves within 1e-3 of the largest, the running
   statistics within 1e-4, K2 = K2b = 93 a rank, the model ranks' spikes
   and whole states equal; each rank's parameter and optimizer bytes
   against one process, peak, step p50 and the collectives of a step by
   kind with their ms. The JSON line ``{"train_surface": ...}`` before the
   kernels line holds them, and each kernel entry's
   ``launches_remat_step`` and ``launches_tp_step`` the launches of those
   steps;
22. the modules that close the port, at full width: the MS Sep-conv
   layers at en4's shapes (the encoder block, which holds ``MSSepConv``,
   at the first Swin stage's input [10, 1, 72, 96, 96] to 192 channels;
   the transpose decoder at the input of en4's first decoder and the
   prediction layer at the input of its last prediction head, both read
   from a forward), each in bf16 eval (K2 once at every PSN site, each
   launch against its twin, the sites' shapes bit for bit on dyadic
   inputs, the plain twins' forward equal where no spike flipped) and in
   float32 train (K2 and K2b once at every site, each K2b launch against
   the float64 twin); ``SpikingBNWindowAttention3D(spike_input=True,
   spike_output=False)`` on the SEW model's first-stage windows the same
   way (K2 4 launches: proj_sn_in, q, k, v); ``SpikingPatchEmbedLocal(
   spiking_proj=False)`` at en4's width in bf16; ``export_model --verify``
   of ``SpikingformerFlowNet`` (and its ``events_1048576`` program),
   ``MS_SpikingformerFlowNet``, ``SpikingMultiResUNet`` (phase 17's
   configs) and ``STTFlowNet`` (the DSEC STT config, 20-bin chunks) in
   bf16 from seeded random weights: each reloaded program equal to the
   live step bit for bit, its K1 / K2 / K3 op nodes equal to the live
   step's launches and its own, device busy (the median of 5 interleaved
   readings a route) within 2% of the live step's; export and load
   seconds and MB. The JSON line ``{"close":
   ...}`` before the kernels line holds them, and each kernel entry's
   ``launches_close`` and ``launches_zoo_export`` the launches of those
   runs.

The line before the card's name is a JSON object with each kernel's
launches, error, times and bound; then the card's name and power limit;
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It needs one CUDA card and the CUDA toolkit; it imports no JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "train_dsec_sdformerflow_en4.yaml")
VALID_CONFIG = os.path.join(ROOT, "configs", "valid_dsec.yaml")
SEED = 0
N_LATENCY = 32     # requests sent one at a time: the latency percentiles
N_QUEUED = 32      # requests queued at once: the throughput
# a Gaussian-input comparison may differ where a potential lands within
# float32 rounding of the threshold; more than this share of flipped
# output spikes is a fault, not rounding
MAX_FLIP_SHARE = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_graph_ms(fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels' own time, without the host's launch work
    (which bounds back-to-back launches of a kernel of a few microseconds)."""
    import torch
    fn()                                   # warm (and build) outside
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dyadic(shape, step, lo, hi, gen, device, dtype):
    """Values on a power-of-two grid: every float32 sum of them is exact."""
    import torch
    n = int(round((hi - lo) / step)) + 1
    v = torch.randint(0, n, shape, generator=gen, device=gen.device)
    return (v * step + lo).to(device, dtype)


# ------------------------------------------------------------ phase 1

def phase_build(torch, dev):
    """Build every kernel of the checkout: the four CUDA sources (nvcc) and
    the host event packer (g++) in parallel, K2's first, Triton version (the
    yardstick of phase 3) in this thread meanwhile. Returns the wall seconds
    of the whole build."""
    from concurrent.futures import ThreadPoolExecutor
    from sdformerflow_tpu_torch import kernel_build, native

    def timed(build, source):
        t0 = time.perf_counter()
        _, compiler_log = build(source)
        return time.perf_counter() - t0, compiler_log

    t_start = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        jobs = {
            "K1 qk_attn.cu (nvcc)": pool.submit(
                timed, kernel_build.build_cuda_library, "qk_attn.cu"),
            "K2, K2b psn.cu (nvcc)": pool.submit(
                timed, kernel_build.build_cuda_library, "psn.cu"),
            "K3 voxel.cu (nvcc)": pool.submit(
                timed, kernel_build.build_cuda_library, "voxel.cu"),
            "K4 conv_cs.cu (nvcc)": pool.submit(
                timed, kernel_build.build_cuda_library, "conv_cs.cu"),
            "event_ops.cpp (g++)": pool.submit(
                timed, kernel_build.build_host_library, "event_ops.cpp"),
        }
        t0 = time.perf_counter()
        with torch.inference_mode():
            for dt in (torch.float32, torch.bfloat16):
                x = torch.zeros(10, 4, 8, device=dev, dtype=dt)
                w = torch.zeros(10, 10, device=dev)
                b = torch.zeros(10, 1, device=dev)
                c = torch.ones(8, device=dev)
                triton_k2(x, w, b)
                triton_k2(x, w, b, c, c)
            torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        builds = {name: job.result() for name, job in jobs.items()}
    for name, (secs, compiler_log) in builds.items():
        log(f"[1] build {name}: {secs:.2f} s")
        if compiler_log.strip():
            log(compiler_log.strip())
    for source in ("qk_attn.cu", "psn.cu", "voxel.cu", "conv_cs.cu"):
        kernel_build.load_cuda_library(source)
    native._lib()
    wall = time.perf_counter() - t_start
    log(f"[1] build: all kernels {wall:.2f} s wall (nvcc and g++ in "
        f"parallel; the Triton yardstick of K2 {t_triton:.2f} s meanwhile)")
    for source, kernel in TENSOR_CORE_KERNELS:
        counts = sass_hgmma(kernel_build.build_cuda_library(source)[0])
        mine = {f: n for f, n in counts.items() if kernel in f}
        log(f"[1] SASS of {source}: " + "; ".join(
            f"{f[:90]} HGMMA x{n}" for f, n in sorted(counts.items())))
        check(mine and all(n > 0 for n in mine.values()),
              f"{source}: a bf16 {kernel} instantiation has no HGMMA "
              f"instruction in its SASS ({mine})")
    return wall


# K2's first version (PRs 1-5), a Triton kernel: a program owns BLOCK
# columns and, for each output step t, reloads the T input rows (meant to
# hit L1). Kept here only as phase 3's same-run yardstick; no path of the
# port runs it.
TRITON_BLOCK = 1024
tl = None   # triton.language, bound by _triton_k2_kernel()


def _triton_psn_fwd(x_ptr, w_ptr, b_ptr, scale_ptr, shift_ptr, out_ptr, N,
                    C, T: tl.constexpr, BLOCK_N: tl.constexpr,
                    HAS_AFFINE: tl.constexpr):
    offs = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    mask = offs < N
    if HAS_AFFINE:
        ch = offs % C
        sc = tl.load(scale_ptr + ch, mask=mask, other=0.0)
        sh = tl.load(shift_ptr + ch, mask=mask, other=0.0)
    for t in tl.static_range(T):
        h = tl.zeros([BLOCK_N], tl.float32) + tl.load(b_ptr + t)
        for s in tl.static_range(T):
            xs = tl.load(x_ptr + s * N + offs, mask=mask,
                         other=0.0).to(tl.float32)
            if HAS_AFFINE:
                xs = xs * sc + sh
            h += tl.load(w_ptr + t * T + s) * xs
        tl.store(out_ptr + t * N + offs,
                 (h >= 0.0).to(out_ptr.dtype.element_ty), mask=mask)


def _triton_k2_kernel():
    global tl
    from sdformerflow_tpu_torch import kernel_build
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(kernel_build.BUILD_DIR / "triton"))
    import triton
    import triton.language
    tl = triton.language
    return triton, triton.jit(_triton_psn_fwd)


def prepare_triton_k2(x, w, b, scale=None, shift=None):
    """A launch of the Triton K2 on prepared float32 W, b (and affine):
    ``(launch, out)``, as ``hopper_psn.prepare_k2``."""
    import torch
    if not hasattr(prepare_triton_k2, "kernel"):
        prepare_triton_k2.kernel = _triton_k2_kernel()
    triton, kern = prepare_triton_k2.kernel
    T, C = x.shape[0], x.shape[-1]
    w = w.float().contiguous()
    b = b.float().reshape(T).contiguous()
    sc, sh = (b, b) if scale is None else (scale.float().contiguous(),
                                            shift.float().contiguous())
    x = x.contiguous()
    n = x.numel() // T
    out = torch.empty_like(x)
    grid = (triton.cdiv(n, TRITON_BLOCK),)

    def launch():
        kern[grid](x, w, b, sc, sh, out, n, C, T=T, BLOCK_N=TRITON_BLOCK,
                   HAS_AFFINE=scale is not None, num_warps=8)
    return launch, out


def triton_k2(x, w, b, scale=None, shift=None):
    launch, out = prepare_triton_k2(x, w, b, scale, shift)
    launch()
    return out


# the bf16 kernels that must run on the tensor cores: (source, the name
# every instantiation's symbol contains)
TENSOR_CORE_KERNELS = (("conv_cs.cu", "conv_wgmma_kernel"),
                       ("qk_attn.cu", "qk_attn_wgmma_kernel"))


def sass_hgmma(lib):
    """{kernel symbol: count of HGMMA instructions} of a built library, read
    with cuobjdump -sass from the toolkit that built it."""
    from sdformerflow_tpu_torch import kernel_build
    tool = os.path.join(os.path.dirname(kernel_build._nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True)
    check(proc.returncode == 0, f"cuobjdump -sass {lib}: {proc.stderr}")
    counts, fn = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


# ------------------------------------------------------------- bounds
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores

HBM_BYTES_S = 3.35e12
BF16_TC_FLOP_S = 989e12
F32_FLOP_S = 67e12


def bound(n_bytes, flops, peak_flop_s):
    """(least ms, "bytes" or "operations"): each input byte read once and
    each output byte written once at HBM speed, or the operations at the
    peak rate of their type, whichever takes longer."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak_flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------- model set-up

def load_en4(torch):
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs, load_config
    config = load_config(CONFIG)
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, cfg)
    randomize_(model, torch.Generator().manual_seed(SEED))
    return config, model.state_dict()


def voxel_requests(n, bins, hw, seed):
    """Synthetic signed voxel windows: sparse, like event voxel grids."""
    rng = np.random.default_rng(seed)
    shape = (bins,) + tuple(hw)
    return [(rng.standard_normal(shape) * (rng.random(shape) < 0.3)
             ).astype(np.float32) for _ in range(n)]


def capture_sites(torch, model, run):
    """Run ``run()`` with hooks on every attention and PSN site of
    ``model``; returns (attention inputs, PSN site signatures)."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    from sdformerflow_tpu_torch.models.spiking_swin import (
        SpikingQKWindowAttention3D)
    attn, psn, handles = [], [], []

    def on_attn(mod, args):
        attn.append((mod, args[0].detach().clone()))

    def on_psn(mod, args, kwargs):
        x = args[0]
        psn.append((tuple(x.shape), x.dtype, kwargs.get("affine") is not None))

    attn_ids = set()
    for m in model.modules():
        if isinstance(m, SpikingQKWindowAttention3D):
            attn_ids.update(id(s) for s in m.modules())
            handles.append(m.register_forward_pre_hook(on_attn))
    for m in model.modules():
        if isinstance(m, SpikingNeuron) and id(m) not in attn_ids:
            handles.append(m.register_forward_pre_hook(on_psn,
                                                       with_kwargs=True))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return attn, psn


# ------------------------------------------------------------ phase 2

def phase_k1(torch, dev, attn_inputs):
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    gen = torch.Generator().manual_seed(SEED + 1)
    shapes = {}
    for mod, x in attn_inputs:
        key = (tuple(x.shape), mod.num_heads)
        shapes.setdefault(key, []).append((mod, x))
    max_err, worst_flip, ms, plain_ms, earlier_ms = 0.0, 0.0, 0.0, 0.0, 0.0
    device_ms, earlier_device_ms = 0.0, 0.0
    rates = []
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for (shape, nh), sites in shapes.items():
        mod, x_real = sites[0]
        _, M, wh, ww, C = shape
        ns = wh * ww
        for dt in (torch.float32, torch.bfloat16):
            # dyadic: x on a 1/4 grid, weights/pe on 1/8, affines on 1/4,
            # PSN weights on 1/4 - every f32 sum is exact in any order
            g = lambda *s, step=0.125, lo=-1.0, hi=1.0: dyadic(  # noqa: E731
                s, step, lo, hi, gen, dev, torch.float32)
            psn = lambda: (g(2, 2, step=0.25), g(2, step=0.25))  # noqa: E731
            (w_in, b_in), (w_q, b_q), (w_k, b_k) = psn(), psn(), psn()
            w_t, b_t = g(2, 2, step=0.25), g(2, step=1.0, lo=-4.0, hi=0.0)
            p = A.QKAttnParams(
                w_in=w_in, b_in=b_in, wq=g(C, C).to(dt),
                aq=g(C, step=0.25, lo=0.25, hi=2.0), cq=g(C),
                w_q=w_q, b_q=b_q, wk=g(C, C).to(dt),
                ak=g(C, step=0.25, lo=0.25, hi=2.0), ck=g(C),
                pe=g(2, ns, C).to(dt), w_k=w_k, b_k=b_k, w_t=w_t, b_t=b_t,
                wp=g(C, C), bp=g(C), ap=g(C), cp=g(C))
            x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
            got = A.qk_attn_interior(x, p, nh).float()
            want = A.qk_attn_interior_plain(x, p, nh).float()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            check(err == 0.0, f"K1 {shape} {dt} dyadic: max|d| = {err}")
            check(0.0 < got.mean().item() < 1.0,
                  f"K1 {shape} {dt} dyadic: degenerate output")
            # Gaussian input through the model's own (random) weights
            p_mod = mod.kernel_params()
            xg = torch.randn(shape, generator=gen).to(dev, dt)
            flip = (A.qk_attn_interior(xg, p_mod, nh)
                    != A.qk_attn_interior_plain(xg, p_mod, nh)
                    ).float().mean().item()
            worst_flip = max(worst_flip, flip)
            log(f"[2] K1 M={M} C={C} nh={nh} {str(dt)[6:]}: dyadic max|d| "
                f"{err} (bitwise), gaussian flipped share {flip:.3g}")
            check(flip <= MAX_FLIP_SHARE, f"K1 gaussian flips {flip}")
        # the real main-path inputs (bf16), their firing and timings
        p_real = mod.kernel_params()
        real_flip = 0.0
        for m_, xr in sites:
            a = A.qk_attn_interior(xr, m_.kernel_params(), nh)
            flip = (a != A.qk_attn_interior_plain(xr, m_.kernel_params(), nh)
                    ).float().mean().item()
            worst_flip = max(worst_flip, flip)
            real_flip = max(real_flip, flip)
            check(flip <= MAX_FLIP_SHARE, f"K1 real-input flips {flip}")
            rates.append(a.float().mean().item())
        t_k = cuda_time_ms(lambda: A.qk_attn_interior(x_real, p_real, nh))
        t_p = cuda_time_ms(
            lambda: A.qk_attn_interior_plain(x_real, p_real, nh))
        # the first, CUDA-core K1 on the same input: the yardstick
        t_e = cuda_time_ms(lambda: A.prepare_qk_attn_interior(
            x_real, p_real, nh, cuda_cores=True)[0]())
        # the kernels alone: back-to-back launches of prepared arguments,
        # without the wrapper's host work and weight re-layout
        d_k = cuda_time_ms(A.prepare_qk_attn_interior(x_real, p_real, nh)[0])
        d_e = cuda_time_ms(A.prepare_qk_attn_interior(
            x_real, p_real, nh, cuda_cores=True)[0])
        ms += t_k * len(sites)
        plain_ms += t_p * len(sites)
        earlier_ms += t_e * len(sites)
        device_ms += d_k * len(sites)
        earlier_device_ms += d_e * len(sites)
        # x read and the 0/1 products written once, the weights, pe and
        # affine/PSN rows read once; 4 C x C products per row (q and k, two
        # halves), on the bf16 tensor cores (0/1 x bf16 is exact there)
        site_bytes = (2 * nbytes(x_real) + 2 * C * C * x_real.element_size()
                      + 2 * ns * C * x_real.element_size() + 4 * C * 4
                      + 24 * 4)
        site_flops = 8 * M * ns * C * C
        b_ms, by = bound(site_bytes, site_flops, BF16_TC_FLOP_S)
        bound_by[by] += b_ms * len(sites)
        log(f"[2] K1 M={M} C={C} bf16 x{len(sites)}/forward: main-path "
            f"inputs flipped share {real_flip:.3g}; wrapper {t_k:.4f} ms "
            f"(CUDA-core K1 {t_e:.4f}), plain {t_p:.4f} ms; kernel alone "
            f"{d_k:.4f} ms (CUDA-core K1 {d_e:.4f}); "
            f"{site_bytes / 1e6:.2f} MB, {site_flops / 1e9:.3f} GFLOP, bound "
            f"{b_ms:.4f} ms ({by}): kernel alone at {100 * b_ms / d_k:.1f}% "
            f"of it (CUDA-core K1 {100 * b_ms / d_e:.1f}%), wrapper at "
            f"{100 * b_ms / t_k:.1f}%")
    bound_ms = sum(bound_by.values())
    log(f"[2] K1 per forward (bf16): wrapper {ms:.4f} ms (CUDA-core K1 "
        f"{earlier_ms:.4f}), kernel alone {device_ms:.4f} ms (CUDA-core K1 "
        f"{earlier_device_ms:.4f}), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms: kernel alone at "
        f"{100 * bound_ms / device_ms:.1f}% of it")
    return dict(max_abs_err=max_err, flip_share=worst_flip, ms=ms,
                plain_ms=plain_ms, earlier_ms=earlier_ms, device_ms=device_ms,
                earlier_device_ms=earlier_device_ms, rates=rates,
                n_shapes=len(shapes), bound_ms=bound_ms,
                bound_by=max(bound_by, key=bound_by.get))


# ------------------------------------------------------------ phase 3

def phase_k2(torch, dev, psn_sites):
    """K2 at every PSN site shape of the serving forward: bitwise on dyadic
    inputs and the flipped share on Gaussian ones, float32 and bfloat16;
    then, in the site's dtype with W and b in the model's dtype, the time
    of the kernel alone (prepared launches), with its wrapper, of its first,
    Triton version alone, and of the plain twin, beside the bound."""
    from sdformerflow_tpu_torch.ops.hopper_psn import (fused_affine_psn,
                                                       prepare_k2, psn_spike)
    gen = torch.Generator().manual_seed(SEED + 2)
    sites = {}
    for sig in psn_sites:
        sites[sig] = sites.get(sig, 0) + 1
    out = dict(max_abs_err=0.0, flip_share=0.0, ms=0.0, device_ms=0.0,
               earlier_device_ms=0.0, graph_ms=0.0, earlier_graph_ms=0.0,
               plain_ms=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for (shape, sdt, affine), count in sites.items():
        T, C = shape[0], shape[-1]
        errs, flips = [], []
        for dt in (torch.float32, torch.bfloat16):
            w = dyadic((T, T), 0.125, -1.0, 1.0, gen, dev, torch.float32)
            b = dyadic((T, 1), 0.25, -1.0, 1.0, gen, dev, torch.float32)
            kw = (dict(scale=dyadic((C,), 0.25, 0.25, 2.0, gen, dev,
                                    torch.float32),
                       shift=dyadic((C,), 0.25, -1.0, 1.0, gen, dev,
                                    torch.float32)) if affine else {})
            x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
            got = fused_affine_psn(x, w, b, **kw).float()
            err = (got - psn_spike(x, w, b, **kw).float()).abs().max().item()
            out["max_abs_err"] = max(out["max_abs_err"], err)
            check(err == 0.0, f"K2 {shape} {dt} dyadic: max|d| = {err}")
            check(0.0 < got.mean().item() < 1.0,
                  f"K2 {shape} {dt} dyadic: degenerate output")
            errs.append(err)
            wg = torch.randn(T, T, generator=gen).to(dev) * 0.4
            bg = torch.randn(T, 1, generator=gen).to(dev) * 0.4
            kwg = (dict(scale=torch.rand(C, generator=gen).to(dev) + 0.5,
                        shift=torch.randn(C, generator=gen).to(dev))
                   if affine else {})
            xg = torch.randn(shape, generator=gen).to(dev, dt)
            flip = (fused_affine_psn(xg, wg, bg, **kwg)
                    != psn_spike(xg, wg, bg, **kwg)).float().mean().item()
            out["flip_share"] = max(out["flip_share"], flip)
            check(flip <= MAX_FLIP_SHARE, f"K2 gaussian flips {flip}")
            flips.append(flip)
        xt = torch.randn(shape, generator=gen).to(dev, sdt)
        wt, bt = wg.to(sdt), bg.to(sdt)   # the model's dtype
        t_k = cuda_time_ms(lambda: fused_affine_psn(xt, wt, bt, **kwg))
        launch_k = prepare_k2(xt, wt, bt, **kwg)[0]
        launch_e = prepare_triton_k2(xt, wg, bg, kwg.get("scale"),
                                     kwg.get("shift"))[0]
        d_k, d_e = cuda_time_ms(launch_k), cuda_time_ms(launch_e)
        g_k, g_e = cuda_graph_ms(launch_k), cuda_graph_ms(launch_e)
        t_p = cuda_time_ms(lambda: psn_spike(xt, wt, bt, **kwg))
        for key, v in (("ms", t_k), ("device_ms", d_k),
                       ("earlier_device_ms", d_e), ("graph_ms", g_k),
                       ("earlier_graph_ms", g_e), ("plain_ms", t_p)):
            out[key] += v * count
        # x read and the spikes written once, W/b (and the affine) read
        # once; T x T multiply-adds per column in float32 on the CUDA cores
        n_col = xt.numel() // T
        site_bytes = (2 * nbytes(xt) + (T * T + T) * xt.element_size()
                      + (2 * C * 4 if affine else 0))
        site_flops = 2 * T * T * n_col + (2 * T * n_col if affine else 0)
        b_ms, by = bound(site_bytes, site_flops, F32_FLOP_S)
        bound_by[by] += b_ms * count
        log(f"[3] K2 {list(shape)} affine={affine} x{count}/forward: dyadic "
            f"max|d| f32/bf16 {errs}, gaussian flipped share {flips}; "
            f"{str(sdt)[6:]}: alone {d_k:.4f} ms, in a CUDA graph "
            f"{g_k:.4f} (Triton K2 alone {d_e:.4f}, graph {g_e:.4f}), wrapper "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms; {site_bytes / 1e6:.2f} MB, "
            f"bound {b_ms:.4f} ms ({by}): alone at {100 * b_ms / d_k:.1f}% "
            f"of it, graph {100 * b_ms / g_k:.1f}% (Triton K2 "
            f"{100 * b_ms / d_e:.1f}%, graph {100 * b_ms / g_e:.1f}%), "
            f"wrapper at {100 * b_ms / t_k:.1f}%")
    out.update(n_sites=len(psn_sites), bound_ms=sum(bound_by.values()),
               bound_by=max(bound_by, key=bound_by.get))
    log(f"[3] K2 per forward ({len(psn_sites)} sites): alone "
        f"{out['device_ms']:.4f} ms, in CUDA graphs {out['graph_ms']:.4f} "
        f"(Triton K2 alone {out['earlier_device_ms']:.4f}, graphs "
        f"{out['earlier_graph_ms']:.4f}), wrapper {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms: alone at "
        f"{100 * out['bound_ms'] / out['device_ms']:.1f}% of it, graphs "
        f"{100 * out['bound_ms'] / out['graph_ms']:.1f}%")
    return out


# ------------------------------------------------------------ phase 4
# K3, the voxelizer, at the sensor size of the raw-events path

SENSOR = (480, 640)
K3_EVENTS = 1 << 20
K3_TOL = 1e-4     # abs and rel, the tolerance of tests/test_pallas_voxel.py
# float operations of one valid event, by mode: t_n 3, corner weights
# 3 axes x 2 corners x 2, the value 2, then 3 multiplies and 1 add per
# corner (8 corners); v2 6 + 4, frames 5 + 8 + 4 x 2
K3_FLOPS = {"signed": 49, "polarities": 47, "v2": 10, "frames": 21}


def k3_entries():
    from sdformerflow_tpu_torch.ops import hopper_voxel as K
    from sdformerflow_tpu_torch.ops import voxel as V
    return {
        "signed": (K.voxel_grid_signed_k3, V.voxel_grid_signed, "num_bins",
                   {}),
        "polarities": (K.voxel_grid_polarities_k3, V.voxel_grid_polarities,
                       "num_bins", {}),
        "v2": (K.events_to_voxel_grid_v2_k3, V.events_to_voxel_grid_v2,
               "num_bins", {"normalize": False}),
        "frames": (K.events_to_frames_k3, V.events_to_frames, "num_frames",
                   {}),
    }


def k3_events(torch, gen, dev, bins, exact, skew=False):
    """K3_EVENTS event slots over the sensor frame, from one unit before
    to one unit beyond each edge, the last 1/16 padding (valid False).
    Dyadic: x/y/t on a 1/4 grid, t in [0, bins - 1], t_range (0, bins - 1):
    every weight and every sum is exact. Else uniform, t in [0, 1]. With
    ``skew``, 9/10 of the events on the middle 1/10 of the rows: an
    invented layout, not one measured on a real window."""
    n, (h, w) = K3_EVENTS, SENSOR
    k = 9 * n // 10
    if exact:
        x = dyadic((n,), 0.25, -1.0, w + 1.0, gen, dev, torch.float32)
        y = dyadic((n,), 0.25, -1.0, h + 1.0, gen, dev, torch.float32)
        if skew:
            y[:k] = dyadic((k,), 0.25, 0.45 * h, 0.55 * h, gen, dev,
                           torch.float32)
        t = dyadic((n,), 0.25, 0.0, bins - 1.0, gen, dev, torch.float32)
        t_range = (0.0, bins - 1.0)
    else:
        x = (torch.rand(n, generator=gen) * (w + 2) - 1).to(dev)
        y = torch.rand(n, generator=gen) * (h + 2) - 1
        if skew:
            y[:k] = torch.rand(k, generator=gen) * (0.1 * h) + 0.45 * h
        y = y.to(dev)
        t = torch.rand(n, generator=gen).sort().values.to(dev)
        t_range = (0.0, 1.0)
    p = torch.randint(0, 2, (n,), generator=gen).float().to(dev)
    valid = (torch.arange(n) < n - n // 16).to(dev)
    return (x, y, t, p), valid, t_range


def k3_integer_window(torch, dev):
    """One synthetic window of phase 6 (x/y uniform random integers over
    the frame, microsecond t), packed by the server's packer into its 2^20
    bucket; t_range its span."""
    from sdformerflow_tpu_torch import native
    win = event_windows(1, 0.6, 1.0, SEED + 12)[0]
    buf = np.empty((5, K3_EVENTS), np.float32)
    native.pack_window(win["x"], win["y"], win["t"], win["p"], K3_EVENTS,
                       t0=0.0, out=buf)
    ev = tuple(torch.from_numpy(buf[i]).to(dev) for i in range(4))
    valid = torch.from_numpy(buf[4] != 0).to(dev)
    return ev, valid, (float(win["t"].min()), float(win["t"].max()))


def atomic_k3_fn():
    """``voxel_scatter_atomic`` of csrc/voxel.cu, the first K3."""
    import ctypes
    from sdformerflow_tpu_torch import kernel_build
    fn = kernel_build.load_cuda_library("voxel.cu").voxel_scatter_atomic
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def prepare_atomic_k3(torch, ev, valid, mode, bins, t_range):
    """The first K3, kept in csrc/voxel.cu as voxel_scatter_atomic: a
    memset of the grid, then one float atomic a corner into it. Phase 4's
    same-run yardstick; no path of the package calls it. Returns
    ``(launch, out)`` as ``hopper_voxel.prepare_k3`` does."""
    from sdformerflow_tpu_torch.ops import hopper_voxel as K
    fn = atomic_k3_fn()
    (h, w), dev = SENSOR, ev[0].device
    out = torch.empty((bins, 2, h, w) if mode in ("polarities", "frames")
                      else (bins, h, w), device=dev)
    tr = torch.tensor(t_range, dtype=torch.float32, device=dev)
    args = ([e.data_ptr() for e in ev]
            + [valid.data_ptr(), tr.data_ptr(), out.data_ptr(),
               ev[0].numel(), K._MODES[mode], bins, h, w])

    def launch():
        out.zero_()
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"voxel_scatter_atomic launch failed: CUDA error "
              f"{err}")
        return tr, out
    return launch, out


K3_PASSES = {"Memset": "memset", "bin_kernel<false>": "count",
             "plan_kernel": "plan", "bin_kernel<true>": "scatter",
             "tile_kernel": "tiles"}


def k3_pass_us(torch, launch, n=10):
    """Device microseconds a call of each of K3's passes, from the
    profiler's kernel records over ``n`` prepared launches."""
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        name = next((v for k, v in K3_PASSES.items() if k in e.key), None)
        if name and us > 0:
            out[name] = out.get(name, 0.0) + us / n
    return out


def phase_k3(torch, dev):
    """The four K3 entries vs their plain twins at 480x640, 10 and 15 bins,
    2^20 event slots: bitwise on dyadic events (uniform and skewed), within
    K3_TOL on uniform (continuous x/y), integer (x/y uniform random
    integers) and skewed windows; each timed through its wrapper, alone
    (prepared launches) and in a CUDA graph, beside the first, atomic K3 in
    the same run, the twin and the bound."""
    from sdformerflow_tpu_torch.ops import hopper_voxel as K
    gen = torch.Generator().manual_seed(SEED + 10)
    (h, w), rows = SENSOR, {}
    max_err = max_rand_err = 0.0
    integer = k3_integer_window(torch, dev)
    for bins in (10, 15):
        exact = {s: k3_events(torch, gen, dev, bins, True, s)
                 for s in (False, True)}
        windows = {"uniform": k3_events(torch, gen, dev, bins, False),
                   "integer": integer,
                   "skewed": k3_events(torch, gen, dev, bins, False, True)}
        for kind, (entry, plain, bins_kw, extra) in k3_entries().items():
            kw = {bins_kw: bins, "height": h, "width": w, **extra}
            errs = []
            for skew, (ev, valid, t_range) in exact.items():
                got = entry(*ev, valid=valid, t_range=t_range, **kw)
                want = plain(*ev, valid=valid, t_range=t_range, **kw)
                err = (got - want).abs().max().item()
                check(err == 0.0, f"K3 {kind} bins={bins} dyadic skew="
                      f"{skew}: max|d| {err}")
                check(want.abs().sum().item() > 0, f"K3 {kind}: all-zero "
                      f"grid")
                errs.append(err)
                max_err = max(max_err, err)
            tiles = K.k3_tiles(kind, bins, h, w)
            log(f"[4] K3 {kind} {bins}x{h}x{w}: {tiles.describe()}; dyadic "
                f"uniform and skewed max|d| {errs} (bitwise)")
            for name, (ev, valid, t_range) in windows.items():
                run = lambda f: f(*ev, valid=valid, t_range=t_range,  # noqa: E731
                                  **kw)
                got, want = run(entry), run(plain)
                d = (got - want).abs()
                rand_err = d.max().item()
                check(bool((d <= K3_TOL + K3_TOL * want.abs()).all()),
                      f"K3 {kind} bins={bins} {name}: max|d| {rand_err}")
                check(got.abs().sum().item() > 0, f"K3 {kind}: all-zero "
                      f"grid")
                max_rand_err = max(max_rand_err, rand_err)
                launch, _ = K.prepare_k3(*ev, mode=kind, num_bins=bins,
                                         height=h, width=w, valid=valid,
                                         t_range=t_range)
                old, old_out = prepare_atomic_k3(torch, ev, valid, kind, bins,
                                                 t_range)
                old()
                d_old = (old_out - want).abs()
                check(bool((d_old <= K3_TOL + K3_TOL * want.abs()).all()),
                      f"atomic K3 {kind} bins={bins} {name}: max|d| "
                      f"{d_old.max().item()}")
                t_w = cuda_time_ms(lambda: run(entry))
                t_a, t_g = cuda_time_ms(launch), cuda_graph_ms(launch)
                t_oa, t_og = cuda_time_ms(old), cuda_graph_ms(old)
                t_a2 = cuda_time_ms(launch)
                t_p = cuda_time_ms(lambda: run(plain), iters=5)
                n_valid = int(valid.sum())
                n_bytes = nbytes(*ev, valid, got)
                b_ms, by = bound(n_bytes, K3_FLOPS[kind] * n_valid,
                                 F32_FLOP_S)
                passes = (k3_pass_us(torch, launch)
                          if (kind, bins) == ("signed", 10) else {})
                if passes:
                    log(f"[4] K3 signed 10 bins, {name}: device us a call "
                        f"by pass (profiler, 10 calls): " + ", ".join(
                            f"{k} {v:.1f}" for k, v in passes.items())
                        + f"; sum {sum(passes.values()):.1f}")
                row = dict(ms=t_w, device_ms=min(t_a, t_a2), graph_ms=t_g,
                           earlier_device_ms=t_oa, earlier_graph_ms=t_og,
                           plain_ms=t_p, bound_ms=b_ms, bound_by=by,
                           mb=n_bytes / 1e6, max_abs_err=rand_err,
                           **{f"{k}_us": v for k, v in passes.items()})
                rows[f"{kind}/{bins}/{name}"] = row
                log(f"[4] K3 {kind} {bins} bins, {name} ({n_valid} valid of "
                    f"{K3_EVENTS}): max|d| {rand_err:.3g}; alone "
                    f"{t_a:.4f} / {t_a2:.4f} ms, graph {t_g:.4f}, wrapper "
                    f"{t_w:.4f} (atomic K3 alone {t_oa:.4f}, graph "
                    f"{t_og:.4f}); plain {t_p:.4f} ms; {n_bytes / 1e6:.2f} "
                    f"MB, bound {b_ms:.4f} ms ({by}): graph at "
                    f"{100 * b_ms / t_g:.1f}% of it (atomic K3 "
                    f"{100 * b_ms / t_og:.1f}%)")
    main = rows["signed/10/uniform"]
    return dict(main, max_abs_err=max_err, uniform_max_abs_err=max_rand_err,
                tiles=K.k3_tiles("signed", 10, h, w).describe(), rows=rows)


# ------------------------------------------------------------ phase 5

def device_ms_per_call(torch, run, n, trace_name="smoke_forward_trace"):
    """Device time per call of ``run``: the union of the kernel intervals
    that ``torch.profiler`` records over ``n`` calls, divided by ``n``.
    None if the profiler records no kernel."""
    from torch.profiler import ProfilerActivity, profile
    trace = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                         trace_name + ".json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "kernel")
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3 / n


def phase_slice(torch, server, hw, card):
    from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn
    requests = voxel_requests(N_LATENCY + N_QUEUED, 10, hw, SEED + 3)
    hopper_attn.qk_attn_interior.launches = 0
    hopper_psn.fused_affine_psn.launches = 0
    latencies, flows = [], []
    for r in requests[:N_LATENCY]:        # one at a time: latency
        t0 = time.perf_counter()
        flows.append(server.infer(r))
        latencies.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()              # all queued: throughput
    futs = [server.submit(r) for r in requests[N_LATENCY:]]
    flows += [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    k1 = hopper_attn.qk_attn_interior.launches
    k2 = hopper_psn.fused_affine_psn.launches
    n = len(requests)
    for f in flows:
        check(f.shape == (2,) + tuple(hw), f"flow shape {f.shape}")
        check(np.isfinite(f).all(), "non-finite flow")
    check(k1 == 12 * n, f"K1 launched {k1} times for {n} requests, "
          f"expected {12 * n}")
    check(k2 > 0 and k2 % n == 0, f"K2 launched {k2} times for {n} requests")
    p50, p90 = (float(v) for v in np.percentile(latencies, [50, 90]))
    # outside the counted run: how much of a request the card is busy
    dev_ms = device_ms_per_call(torch, lambda: server.infer(requests[0]), 8)
    log(f"[5] voxel path: {n} requests, flows {list(flows[0].shape)} "
        f"finite; K1 {k1} launches ({k1 // n}/request), K2 {k2} "
        f"({k2 // n}/request)")
    log(f"[5] latency over {N_LATENCY} requests one at a time on {card}: "
        f"p50 {p50:.2f} ms, p90 {p90:.2f}, min {min(latencies):.2f}, max "
        f"{max(latencies):.2f}; {N_QUEUED} queued requests in "
        f"{wall * 1e3:.1f} ms = {N_QUEUED / wall:.2f} windows/s; mean |flow| "
        f"{float(np.mean([np.abs(f).mean() for f in flows])):.4g}")
    log("[5] device busy per request (union of kernel intervals, profiler, "
        "8 requests): " + ("not measured: the profiler recorded no kernel"
                           if dev_ms is None else
                           f"{dev_ms:.3f} ms, {100 * dev_ms / p50:.1f}% of "
                           f"the p50"))
    return dict(k1=k1, k2=k2, p50=p50, p90=p90, device_ms=dev_ms,
                windows_per_s=N_QUEUED / wall)



# ------------------------------------------------------------ phase 6
# the raw-events path: FlowServer with dict requests at sensor resolution

N_WINDOWS = 16    # distinct synthetic windows, cycled through


def event_windows(n, lo, hi, seed):
    """Synthetic windows at 480x640 in DSEC's dtypes, not its layout:
    uint16 x/y uniform random integers over the frame (no real window's
    rows or columns), int64
    microsecond t sorted over 100 ms, uint8 p; lo..hi x 2^20 events."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.uniform(lo, hi) * K3_EVENTS)
        out.append({
            "x": rng.integers(0, SENSOR[1], m, dtype=np.uint16),
            "y": rng.integers(0, SENSOR[0], m, dtype=np.uint16),
            "t": np.sort(rng.integers(0, 100_000, m, dtype=np.int64)),
            "p": rng.integers(0, 2, m, dtype=np.uint8)})
    return out


def atomic_voxelize_batch(torch, events, *, num_bins, height, width):
    """``voxelize_batch`` as it was before K3's redesign, over the first,
    atomic K3: the valid span by two masked reductions, then a row at a
    time the wrapper's checks, a [2] stack of the span, a zeroed grid and
    one launch, then a torch.stack of the rows. Phase 6's same-run
    yardstick; no path of the package calls it."""
    from sdformerflow_tpu_torch.ops import hopper_voxel as K
    fn = atomic_k3_fn()
    valid, t = events["valid"], events["t"]
    span = torch.stack([torch.where(valid, t, float("inf")).amin(dim=-1),
                        torch.where(valid, t, float("-inf")).amax(dim=-1)],
                       dim=-1)
    grids = []
    for b in range(t.shape[0]):
        ev = [events[k][b] for k in "xytp"]
        dev, n = K._check_events(*ev, valid[b])
        tr = torch.stack((span[b, 0], span[b, 1]))
        out = torch.zeros((num_bins, height, width), device=dev)
        err = fn(*(e.data_ptr() for e in ev), valid[b].data_ptr(),
                 tr.data_ptr(), out.data_ptr(), n, K._MODES["signed"],
                 num_bins, height, width,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"voxel_scatter_atomic launch failed: CUDA error "
              f"{err}")
        grids.append(out)
    return torch.stack(grids)


def dyadic_window(rng, bins, m):
    """A window whose grid is exact: x/y on a 1/4 grid from one unit
    before to one unit beyond the frame, integer t from 0 to 4 (bins - 1)
    with both ends present, so the server's valid-span t_range puts t_n on
    a 1/4 grid."""
    h, w = SENSOR
    t = rng.integers(0, 4 * (bins - 1) + 1, m).astype(np.int64)
    t[:2] = 0, 4 * (bins - 1)
    return {"x": (rng.integers(-4, 4 * (w + 1), m) * 0.25).astype(np.float32),
            "y": (rng.integers(-4, 4 * (h + 1), m) * 0.25).astype(np.float32),
            "t": t, "p": rng.integers(0, 2, m).astype(np.uint8)}


def phase_events(torch, dev, server, card):
    from sdformerflow_tpu_torch import native
    from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn
    from sdformerflow_tpu_torch.ops import hopper_voxel
    from sdformerflow_tpu_torch.ops.voxel import voxel_grid_signed
    from sdformerflow_tpu_torch.serving import next_bucket
    from sdformerflow_tpu_torch.training.train_step import (center_crop,
                                                            voxelize_batch)
    bins = server._num_bins
    crop = server._crop
    windows = event_windows(N_WINDOWS, 0.6, 1.0, SEED + 8)
    big = event_windows(4, 1.1, 1.9, SEED + 9)       # the 2^21 bucket
    server.warmup(K3_EVENTS)
    server.warmup(2 * K3_EVENTS)
    hopper_attn.qk_attn_interior.launches = 0
    hopper_psn.fused_affine_psn.launches = 0
    hopper_voxel.voxel_k3.launches = 0
    latencies, flows = [], []
    for i in range(N_LATENCY):               # one at a time: latency
        t0 = time.perf_counter()
        flows.append(server.infer(windows[i % N_WINDOWS]))
        latencies.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()                 # all queued: throughput
    futs = [server.submit(windows[i % N_WINDOWS]) for i in range(N_QUEUED)]
    flows += [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    flows += [server.infer(r) for r in big]
    k1 = hopper_attn.qk_attn_interior.launches
    k2 = hopper_psn.fused_affine_psn.launches
    k3 = hopper_voxel.voxel_k3.launches
    n = len(flows)
    for f in flows:
        check(f.shape == (2,) + tuple(crop), f"events flow shape {f.shape}")
        check(np.isfinite(f).all(), "non-finite events flow")
    check(k3 == n, f"K3 launched {k3} times for {n} events requests")
    check(k1 == 12 * n, f"K1 launched {k1} times for {n} events requests")
    check(k2 > 0 and k2 % n == 0, f"K2 launched {k2} times for {n} "
          f"events requests")
    check(next_bucket(len(big[0]["x"])) == 2 * K3_EVENTS,
          "no request in the 2^21 bucket")
    p50, p90 = (float(v) for v in np.percentile(latencies, [50, 90]))
    log(f"[6] events path: {n} requests at {SENSOR[0]}x{SENSOR[1]} "
        f"({min(len(w['x']) for w in windows)}-"
        f"{max(len(w['x']) for w in windows)} events, 4 in the 2^21 "
        f"bucket), flows {list(flows[0].shape)} finite; K3 {k3} launches "
        f"({k3 // n}/request), K1 {k1} ({k1 // n}/request), K2 {k2} "
        f"({k2 // n}/request)")
    log(f"[6] events latency over {N_LATENCY} requests one at a time on "
        f"{card}: p50 {p50:.2f} ms, p90 {p90:.2f}, min {min(latencies):.2f},"
        f" max {max(latencies):.2f}; {N_QUEUED} queued in "
        f"{wall * 1e3:.1f} ms = {N_QUEUED / wall:.2f} windows/s")

    # end-to-end identity on exact grids: events request == the voxel
    # request of its plain-twin grid after the same crop, bit for bit
    rng = np.random.default_rng(SEED + 11)
    for m in (K3_EVENTS * 2 // 3, K3_EVENTS):
        req = dyadic_window(rng, bins, m)
        ev = [torch.from_numpy(np.asarray(req[k], np.float32)).to(dev)
              for k in "xytp"]
        grid = voxel_grid_signed(*ev, num_bins=bins, height=SENSOR[0],
                                 width=SENSOR[1],
                                 t_range=(0.0, 4.0 * (bins - 1)))
        chunk = center_crop(grid, crop).cpu().numpy()
        check(np.abs(chunk).sum() > 0, "dyadic window: empty crop")
        f_ev, f_vox = server.infer(req), server.infer(chunk)
        check(np.array_equal(f_ev, f_vox), f"events vs voxel request on a "
              f"dyadic window of {m}: max|d| {np.abs(f_ev - f_vox).max()}")
    log(f"[6] dyadic windows ({K3_EVENTS * 2 // 3} and {K3_EVENTS} events):"
        f" events flow == voxel flow of the plain-twin grid, bit for bit")

    # where a request's time goes, piece by piece
    pack_ms, sorted_ms = [], []
    for w in windows:
        t0 = time.perf_counter()
        buf = server.pack_events(w)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        out = np.empty((5, buf.shape[-1]), np.float32)
        t0 = time.perf_counter()
        native.pack_window_sorted(w["x"], w["y"], w["t"], w["p"],
                                  buf.shape[-1], SENSOR[0], t0=0.0, out=out)
        sorted_ms.append((time.perf_counter() - t0) * 1e3)
    buf = server.pack_events(windows[0])
    h2d_ms = cuda_time_ms(lambda: buf.to(dev, non_blocking=True))
    dbuf = buf.to(dev)
    ev = {"x": dbuf[:, 0], "y": dbuf[:, 1], "t": dbuf[:, 2], "p": dbuf[:, 3],
          "valid": dbuf[:, 4] != 0}
    vox = dict(num_bins=bins, height=SENSOR[0], width=SENSOR[1])
    with torch.inference_mode():
        k3_ms = cuda_time_ms(lambda: voxelize_batch(ev, **vox))
        old_ms = cuda_time_ms(lambda: atomic_voxelize_batch(torch, ev,
                                                            **vox))
        grid = voxelize_batch(ev, **vox)
        old = atomic_voxelize_batch(torch, ev, **vox)
        d = (grid - old).abs()
        check(bool((d <= K3_TOL + K3_TOL * old.abs()).all()),
              f"voxelize_batch vs its atomic-K3 form: max|d| "
              f"{d.max().item()}")
        cropped = center_crop(grid, crop).contiguous()
        fwd_ms = cuda_time_ms(lambda: server._step(cropped), iters=10)
    # the kernels alone on the same row: the kernel's share of the gain
    row, valid0 = [ev[k][0] for k in "xytp"], ev["valid"][0]
    launch, _ = hopper_voxel.prepare_k3(
        *row, mode="signed", valid=valid0, valid_span=True, **vox)
    span = (float(row[2][valid0].min()), float(row[2][valid0].max()))
    old_launch, _ = prepare_atomic_k3(torch, row, valid0, "signed", bins,
                                      span)
    k3_alone_ms, atomic_alone_ms = cuda_time_ms(launch), cuda_time_ms(
        old_launch)
    dev_ms = device_ms_per_call(torch, lambda: server.infer(windows[0]), 8)
    pieces = dict(pack_ms=float(np.median(pack_ms)),
                  pack_sorted_ms=float(np.median(sorted_ms)),
                  h2d_ms=h2d_ms, k3_ms=k3_ms, forward_ms=fwd_ms,
                  voxelize_atomic_ms=old_ms, k3_alone_ms=k3_alone_ms,
                  atomic_alone_ms=atomic_alone_ms)
    log(f"[6] per request ({len(windows[0]['x'])} events in a "
        f"{buf.shape[-1]} bucket): host pack (pack_window into pinned "
        f"memory) median {pieces['pack_ms']:.2f} ms over {N_WINDOWS} "
        f"windows, pack_window_sorted {pieces['pack_sorted_ms']:.2f} ms; "
        f"H2D {buf.numel() * 4 / 1e6:.1f} MB {h2d_ms:.3f} ms; voxelize_batch "
        f"(K3 with its valid span, in place) {k3_ms:.3f} ms; forward at "
        f"{crop[0]}x{crop[1]} "
        f"(CUDA events, back-to-back) {fwd_ms:.2f} ms")
    kernel_share = atomic_alone_ms - k3_alone_ms
    log(f"[6] voxelize_batch {k3_ms:.4f} ms against {old_ms:.4f} in its "
        f"form before K3's redesign (masked-reduction span, [2] stack, "
        f"zeroed grid, atomic K3, torch.stack), same window: gain "
        f"{old_ms - k3_ms:.4f} ms; the kernels alone {atomic_alone_ms:.4f}"
        f" (atomic, memset included) -> {k3_alone_ms:.4f} ms: the kernel's "
        f"share {kernel_share:.4f}, the wrapper's "
        f"{old_ms - k3_ms - kernel_share:.4f}")
    log("[6] device busy per events request (profiler, 8 requests): "
        + ("not measured: the profiler recorded no kernel" if dev_ms is None
           else f"{dev_ms:.3f} ms, {100 * dev_ms / p50:.1f}% of the p50"))
    return dict(k1=k1, k2=k2, k3=k3, p50=p50, p90=p90, device_ms=dev_ms,
                windows_per_s=N_QUEUED / wall, **pieces)

# ------------------------------------------------------------ phase 7

@contextlib.contextmanager
def site_functions(psn, attend=None):
    """Run the model's PSN sites through ``psn`` (the signature of
    ``hopper_psn.affine_psn``) and its eval attention sites through
    ``attend``, in place of the wrappers that dispatch by device."""
    from sdformerflow_tpu_torch.models import spiking_layers, spiking_swin
    saved = spiking_layers.affine_psn, spiking_swin.fused_qk_attention
    spiking_layers.affine_psn = psn
    if attend is not None:
        spiking_swin.fused_qk_attention = attend
    try:
        yield
    finally:
        spiking_layers.affine_psn, spiking_swin.fused_qk_attention = saved


def checked_kernels(flips):
    """Site functions that launch the kernels and add up, in ``flips``, the
    output spikes where a launch disagrees with its plain twin on the same
    input: keys K1 and K2, each [flipped, total]."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops.hopper_psn import (fused_affine_psn,
                                                       psn_spike)

    def psn(x, w, b, *, scale=None, shift=None, **_):   # forward only
        y = fused_affine_psn(x, w, b, scale=scale, shift=shift)
        want = psn_spike(x, w, b, scale=scale, shift=shift)
        flips["K2"][0] += int((y != want).sum())
        flips["K2"][1] += y.numel()
        return y

    def attend(x, p, nh):
        a = A.qk_attn_interior(x, p, nh)
        flips["K1"][0] += int((a != A.qk_attn_interior_plain(x, p, nh)).sum())
        flips["K1"][1] += a.numel()
        return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)
    return psn, attend


def checked_forward(torch, step, chunk, label):
    """One forward of ``step`` on ``chunk`` with every K1 and K2 launch held
    against its plain twin on the same input (no more than MAX_FLIP_SHARE
    of the output spikes flipped), then the plain twins' forward: with no
    flipped spike the two finest flows must be identical. Returns the
    kernel path's finest flow, the K1 and K2 launches, the flips and
    whether the flows are equal."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    flips = {"K1": [0, 0], "K2": [0, 0]}
    A.qk_attn_interior.launches = P.fused_affine_psn.launches = 0
    with site_functions(*checked_kernels(flips)):
        flow = step(chunk)[-1]
    k1, k2 = A.qk_attn_interior.launches, P.fused_affine_psn.launches
    with site_functions(*plain_twins()):
        plain = step(chunk)[-1]
    for key, (n_flip, n) in flips.items():
        check(n > 0 and n_flip <= MAX_FLIP_SHARE * n,
              f"{label}: {key} flipped {n_flip} of {n} spikes")
    same = torch.equal(flow, plain)
    if flips["K1"][0] + flips["K2"][0] == 0:
        check(same, f"{label}: no kernel launch flipped a spike, yet the "
              "kernel path differs from the plain path")
    return dict(flow=flow, k1=k1, k2=k2, flips=flips, same=same)


def plain_twins(flip_one=False):
    """Site functions of the plain twins (the PSN's with its membrane on
    ``return_v``, as the telemetry asks). With ``flip_one``, the first
    attention site's first output spike is flipped: the witness of how far
    one flipped spike carries through the forward."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops.hopper_psn import psn_spike
    pending = [flip_one]

    def psn(x, w, b, *, scale=None, shift=None, return_v=False,
            **_):   # forward only
        return psn_spike(x, w, b, scale=scale, shift=shift,
                         return_v=return_v)

    def attend(x, p, nh):
        a = A.qk_attn_interior_plain(x, p, nh)
        if pending[0]:
            pending[0] = False
            a.view(-1)[0] = 1 - a.view(-1)[0]
        return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)
    return psn, attend


def phase_ab(torch, dev, config, state_dict):
    """Kernel path vs plain path in float32 on the card. Every kernel launch
    of the kernel path is held against its plain twin on the same input;
    with no flipped spike the two forwards must be identical. The plain path
    with one spike flipped and a float64 CPU forward are printed beside."""
    from sdformerflow_tpu_torch.losses import aee_metrics
    from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    model_cfg, swin, cfg = build_configs(config)
    name = config["model"]["name"]
    small_swin = SwinConfig(input_size=(96, 128), depths=(2, 2, 2, 2),
                            num_heads=(2, 2, 4, 4), window_size=(2, 3, 3))
    small_cfg = {"num_bins": 10, "base_num_channels": 16}
    small_state = randomize_(
        get_model(name, small_cfg, small_swin, SpikingConfig(
            num_steps=10, v_th=0.1, neuron_type="psn")),
        torch.Generator().manual_seed(SEED + 5)).state_dict()
    out = {}
    for label, mcfg, sw, sd in (("96x128", small_cfg, small_swin,
                                 small_state),
                                ("288x384", model_cfg, swin, state_dict)):
        hw = tuple(sw.input_size)
        chunk = torch.from_numpy(voxel_requests(1, 10, hw, SEED + 4)[0])[None]
        model = get_model(name, mcfg, sw, cfg)
        model.load_state_dict(sd)
        f = {"ref": make_eval_step(model.double())(chunk.double())[-1]}
        step = make_eval_step(model.float().to(dev))
        flips = {"K1": [0, 0], "K2": [0, 0]}
        for key, sites in (("kernels", checked_kernels(flips)),
                           ("plain", plain_twins()),
                           ("one_flip", plain_twins(flip_one=True))):
            with site_functions(*sites):
                f[key] = step(chunk.to(dev))[-1].double().cpu()
        del model, step
        torch.cuda.empty_cache()
        check(all(bool(torch.isfinite(v).all()) for v in f.values()),
              f"{label}: non-finite flow")
        ones = torch.ones_like(f["ref"][:, :1])
        aee = {f"{a}_vs_{b}": aee_metrics(f[a], f[b], ones)["AEE"].item()
               for a, b in (("kernels", "plain"), ("one_flip", "plain"),
                            ("kernels", "ref"), ("plain", "ref"))}
        mag = f["ref"].norm(dim=1).mean().item()
        log(f"[7] {label} f32 on the card: kernel launches vs their plain "
            f"twins on the same inputs: K1 {flips['K1'][0]} of "
            f"{flips['K1'][1]} spikes flipped, K2 {flips['K2'][0]} of "
            f"{flips['K2'][1]}")
        log(f"[7] {label} AEE kernels vs plain {aee['kernels_vs_plain']:.6g}; "
            f"plain with one spike flipped vs plain "
            f"{aee['one_flip_vs_plain']:.6g}; vs the f64 CPU forward: "
            f"kernels {aee['kernels_vs_ref']:.6g}, plain "
            f"{aee['plain_vs_ref']:.6g}; mean |flow| {mag:.6g}")
        for k, (n_flip, n) in flips.items():
            check(n > 0 and n_flip <= MAX_FLIP_SHARE * n,
                  f"{label}: {k} flipped {n_flip} of {n} spikes")
        if flips["K1"][0] + flips["K2"][0] == 0:
            check(torch.equal(f["kernels"], f["plain"]),
                  f"{label}: no kernel launch flipped a spike, yet the "
                  f"kernel path differs from the plain path")
        out[label] = dict(aee, K1_flipped=flips["K1"][0],
                          K2_flipped=flips["K2"][0])
    return out


# ------------------------------------------------------------ phase 8
# K2b, the PSN surrogate backward, at the sites of a full-width train step

TRAIN_HW = (288, 384)
N_TRAIN_STEPS = 14
# K2b vs its twin: the largest |d| as a share of the twin's largest
# magnitude. float32: the sums run in another order (1e-5). bfloat16 dx:
# one bfloat16 rounding of the largest value (2^-7). The twin runs in
# float64 on the same inputs: dW, db, dscale and dshift sum up to 10^6
# terms of either sign, and a float32 twin's own summation error reached
# 1.2e-5 of the largest db at the en4 train step's sites (a first run of
# this phase), so only a float64 twin can hold the kernel to 1e-5.
K2B_TOL = 1e-5


def captured_ok(err, terms):
    """The bound on K2b's launches in a real train step: dx within K2B_TOL
    of the float64 twin's largest |value|, the four reductions within
    K2B_TOL of their largest sum of |terms|. On a real step's data those
    sums cancel up to ~10^3-fold (db of a T = 2 site, where the spikes'
    cotangent sums to almost 0), and the float32 potential's rounding,
    which the forward's spikes fix (K2 and K2b share it), then reaches
    ~1e-5 of the largest |sum| in K2b and in the float32 twin alike. On
    the synthetic inputs of every site shape (phase 8's second part)
    all five outputs are held to K2B_TOL of the largest |value|."""
    return err["dx"] <= K2B_TOL and all(
        e <= K2B_TOL for name, e in terms.items() if name != "dx")
K2B_TOL_BF16 = 2.0 ** -7


def train_batch(torch, dev, hw, seed, batch=1, bins=10):
    """A synthetic voxel batch at crop size (chunk, label, mask)."""
    rng = np.random.default_rng(seed)
    shape = (batch, bins) + tuple(hw)
    parts = {"chunk": rng.standard_normal(shape) * (rng.random(shape) < 0.1),
             "label": 3.0 * rng.standard_normal((batch, 2) + tuple(hw)),
             "mask": rng.random((batch, 1) + tuple(hw)) > 0.2}
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
            for k, v in parts.items()}


def en4_trainer(torch, dev, config, state_dict, **step_kw):
    """(model, optimizer, train step): the config's model in float32 train
    mode from ``state_dict``, its AdamW, its train step."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.optim import build_optimizer
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, cfg,
                      train=True)
    model.load_state_dict(state_dict)
    model.float().to(dev)
    oc = config["optimizer"]
    opt = build_optimizer(model.named_parameters(), lr=oc["lr"],
                          weight_decay=oc["wd"], milestones=oc["milestones"],
                          clip_grad=config["loss"]["clip_grad"])
    step = make_train_step(model, opt,
                           norm_input=config["model"]["norm_input"],
                           generator=torch.Generator(dev).manual_seed(SEED),
                           **step_kw)
    return model, opt, step


def rel_err(got, want):
    """(max |got - want|, that over max |want|), in float64."""
    d = (got.double() - want.double()).abs().max().item()
    return d, d / max(want.double().abs().max().item(), 1e-300)


GRAD_NAMES = ("dx", "dW", "db", "dscale", "dshift")


def k2b_errors(got, want):
    """{name: largest |d| over the twin's largest} of K2b's five outputs."""
    return {n: rel_err(g, w)[1] for n, g, w in zip(GRAD_NAMES, got, want)
            if w is not None}


def plain64(P, x, g, w, b, **kw):
    """K2b's twin in float64 on the same inputs."""
    return P.psn_backward_plain(
        x.double(), g.double(), w.double(), b.double(),
        **{k: v.double() if hasattr(v, "double") else v
           for k, v in kw.items()})


def k2b_capture(torch, dev, P, step, batch, phase):
    """Run one train step with every K2b launch held against the float64
    twin on the captured (x, g). Returns (loss, K2 and K2b launches,
    {(shape, affine): count}, per output the worst largest |d| over the
    twin's largest |value|, the same over the largest sum of |terms| (see
    ``sum_of_terms``), and the first of these for the float32 twin)."""
    import functools
    sites, worst = {}, dict.fromkeys(GRAD_NAMES, 0.0)
    worst_terms = dict.fromkeys(GRAD_NAMES, 0.0)
    twin32 = dict.fromkeys(GRAD_NAMES, 0.0)
    where = {}

    def checked_backward(x, g, w, b, **kw):
        got = P.fused_psn_backward(x, g, w, b, **kw)
        want = plain64(P, x, g, w, b, **kw)
        key = (tuple(x.shape), kw.get("scale") is not None)
        terms = sum_of_terms(P, x, g, w, b, **kw)
        for name, e in k2b_errors(got, want).items():
            i = GRAD_NAMES.index(name)
            d = rel_err(got[i], want[i])[0]
            scale = (terms[i] if i else want[0]).abs().max().item()
            worst_terms[name] = max(worst_terms[name], d / max(scale, 1e-300))
            if e > worst[name]:
                worst[name] = e
                where[name] = (key, scale / max(want[i].abs().max().item(),
                                                1e-300))
        for name, e in k2b_errors(P.psn_backward_plain(x, g, w, b, **kw),
                                  want).items():
            twin32[name] = max(twin32[name], e)
        sites[key] = sites.get(key, 0) + 1
        return got

    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    impl = P.PSNImpl(P.fused_affine_psn, checked_backward)
    with site_functions(functools.partial(P.affine_psn, impl=impl)):
        loss = step(batch)["loss"].item()
    log(f"[{phase}] where each output's largest share of the twin's "
        "largest |value| was (site; the sum of |terms| over the largest "
        "|sum| there): "
        + "; ".join(f"{n} {list(k[0])} affine={k[1]} x{c:.3g}"
                    for n, (k, c) in where.items()))
    return (loss, P.fused_affine_psn.launches, P.fused_psn_backward.launches,
            sites, worst, worst_terms, twin32)


def sum_of_terms(P, x, g, w, b, **kw):
    """The float64 sums of |terms| of K2b's four reductions (dW, db,
    dscale, dshift; index 0, dx, is None): the scale of their float32
    rounding where the sums cancel. Upper bounds for dW, dscale and dshift
    (|x|, |W|, |scale| and |shift| in place of the signed values)."""
    kw64 = {k: v.double() if hasattr(v, "double") else v
            for k, v in kw.items()}
    gh = P.psn_backward_gh(x.double(), g.double(), w.double(), b.double(),
                           **kw64).abs()
    sc, sh = kw64.get("scale"), kw64.get("shift")
    return (None, *P._param_grads(
        x.double().abs(), gh, w.double().abs(), b.double(),
        None if sc is None else sc.abs(), None if sh is None else sh.abs()))


def phase_k2b(torch, dev, config, state_dict):
    """One full-width float32 train step with every K2b launch held against
    its twin on the captured (x, g); then each site shape of that step in
    float32 and bfloat16 on dyadic and Gaussian inputs: dx within K2B_TOL
    (bfloat16: K2B_TOL_BF16) and the four reductions within K2B_TOL of the
    twin's largest, two launches bitwise equal; timed (float32, summed over
    the step's sites) alone, with the wrapper, the twin, and the PyTorch
    reductions the earlier K2b left to ``_param_grads``, beside the bound."""
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    model, opt, step = en4_trainer(torch, dev, config, state_dict)
    batch = train_batch(torch, dev, TRAIN_HW, SEED + 20)
    loss, k2, k2b, sites, step_err, step_terms, twin32 = k2b_capture(
        torch, dev, P, step, batch, 8)
    del model, opt, step
    torch.cuda.empty_cache()
    n_sites = sum(sites.values())
    check(np.isfinite(loss), f"K2b capture step: loss {loss}")
    check(k2b == k2 == n_sites, f"K2 launched {k2} times, K2b {k2b}, for "
          f"{n_sites} PSN sites in one train step")
    check(captured_ok(step_err, step_terms),
          f"K2b vs its twin in the train step: {step_err}; over the sums "
          f"of |terms|: {step_terms}")
    log(f"[8] en4 f32 train step at {TRAIN_HW[0]}x{TRAIN_HW[1]}: loss "
        f"{loss:.6g}; K2 {k2} and K2b {k2b} launches ({len(sites)} site "
        f"shapes); each K2b launch vs the float64 twin on the captured "
        f"(x, g), largest |d| / twin's largest: " + ", ".join(
            f"{k} {v:.3g}" for k, v in step_err.items())
        + "; / the largest sum of |terms|: " + ", ".join(
            f"{k} {v:.3g}" for k, v in step_terms.items())
        + "; the float32 twin's own / twin's largest: " + ", ".join(
            f"{k} {v:.3g}" for k, v in twin32.items()))

    gen = torch.Generator().manual_seed(SEED + 21)
    out = dict(ms=0.0, device_ms=0.0, graph_ms=0.0, plain_ms=0.0,
               param_grads_ms=0.0, bf16_ms=0.0, bf16_graph_ms=0.0,
               max_abs_err=0.0, max_rel_err=0.0, bf16_max_rel_err=0.0,
               mb=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for (shape, affine), count in sorted(sites.items()):
        T, C = shape[0], shape[-1]
        times = {}
        for dt in (torch.float32, torch.bfloat16):
            f32 = torch.float32
            tol_dx = K2B_TOL if dt == f32 else K2B_TOL_BF16
            for dyad in (True, False):
                if dyad:
                    w = dyadic((T, T), 0.125, -1.0, 1.0, gen, dev, f32)
                    b = dyadic((T, 1), 0.25, -1.0, 1.0, gen, dev, f32)
                    kw = (dict(scale=dyadic((C,), 0.25, 0.25, 2.0, gen, dev,
                                            f32),
                               shift=dyadic((C,), 0.25, -1.0, 1.0, gen, dev,
                                            f32)) if affine else {})
                    x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
                    g = dyadic(shape, 0.25, -1.0, 1.0, gen, dev, dt)
                else:
                    w = torch.randn(T, T, generator=gen).to(dev) * 0.4
                    b = torch.randn(T, 1, generator=gen).to(dev) * 0.4
                    kw = (dict(scale=torch.rand(C, generator=gen).to(dev)
                               + 0.5,
                               shift=torch.randn(C, generator=gen).to(dev))
                          if affine else {})
                    x = torch.randn(shape, generator=gen).to(dev, dt)
                    g = torch.randn(shape, generator=gen).to(dev, dt)
                got = P.fused_psn_backward(x, g, w, b, **kw)
                again = P.fused_psn_backward(x, g, w, b, **kw)
                want = plain64(P, x, g, w, b, **kw)
                errs = k2b_errors(got, want)
                check(errs["dx"] <= tol_dx and all(
                    e <= K2B_TOL for k, e in errs.items() if k != "dx"),
                    f"K2b {shape} {dt} dyadic={dyad}: {errs}")
                check(all(a is None or torch.equal(a, c)
                          for a, c in zip(got, again)),
                      f"K2b {shape} {dt}: two launches differ")
                if dt == f32:
                    out["max_abs_err"] = max(
                        out["max_abs_err"],
                        *(rel_err(a, c)[0] for a, c in zip(got, want)
                          if c is not None))
                    out["max_rel_err"] = max(out["max_rel_err"],
                                             *errs.values())
                else:
                    out["bf16_max_rel_err"] = max(out["bf16_max_rel_err"],
                                                  *errs.values())
            launch = P.prepare_k2b(x, g, w, b, **kw)[0]
            times[dt] = (
                cuda_time_ms(lambda: P.fused_psn_backward(x, g, w, b, **kw)),
                cuda_time_ms(launch), cuda_graph_ms(launch),
                cuda_time_ms(lambda: P.psn_backward_plain(x, g, w, b, **kw)))
            if dt == f32:
                # what the earlier K2b left to PyTorch on top of its pass
                gh = P.psn_backward_gh(x, g, w, b, **kw)
                times["param_grads"] = cuda_time_ms(lambda: P._param_grads(
                    x, gh, w, b, kw.get("scale"), kw.get("shift")))
                # x and g read, dx written; W, b, the affine read and the
                # reductions written once (float32); 4 T^2 multiply-adds a
                # column (h, W^T gh, dW) plus the affine, the surrogate and
                # the channel sums (~10 T operations)
                n_col = x.numel() // T
                site_bytes = (3 * nbytes(x) + 2 * (T * T + T) * 4
                              + (4 * C * 4 if affine else 0))
                site_flops = (6 * T * T + 10 * T) * n_col
                b_ms, by = bound(site_bytes, site_flops, F32_FLOP_S)
                bound_by[by] += b_ms * count
                out["mb"] += site_bytes * count / 1e6
        (t_k, d_k, g_k, t_p), (t_kb, _, g_kb, _) = times[torch.float32], \
            times[torch.bfloat16]
        t_pg = times["param_grads"]
        for key, v in (("ms", t_k), ("device_ms", d_k), ("graph_ms", g_k),
                       ("plain_ms", t_p), ("bf16_ms", t_kb),
                       ("bf16_graph_ms", g_kb), ("param_grads_ms", t_pg)):
            out[key] += v * count
        log(f"[8] K2b {list(shape)} affine={affine} x{count}/step: f32 alone "
            f"{d_k:.4f} ms, in a CUDA graph {g_k:.4f}, wrapper {t_k:.4f} ms, "
            f"plain {t_p:.4f} ms, bf16 wrapper {t_kb:.4f} ms (graph "
            f"{g_kb:.4f}); the earlier path's _param_grads {t_pg:.4f} ms; "
            f"bound {b_ms:.4f} ms ({by}): alone at {100 * b_ms / d_k:.1f}% "
            f"of it, graph {100 * b_ms / g_k:.1f}%, wrapper "
            f"{100 * b_ms / t_k:.1f}%")
    out.update(launches=k2b, k2_launches=k2, n_shapes=len(sites),
               step_rel_err=step_err, step_terms_rel_err=step_terms,
               step_twin32_rel_err=twin32,
               bound_ms=sum(bound_by.values()),
               bound_by=max(bound_by, key=bound_by.get))
    log(f"[8] K2b per train step ({k2b} launches): alone "
        f"{out['device_ms']:.3f} ms, in CUDA graphs {out['graph_ms']:.3f} "
        f"(bf16 {out['bf16_graph_ms']:.3f}), wrapper {out['ms']:.3f} ms (bf16 "
        f"{out['bf16_ms']:.3f}), twin {out['plain_ms']:.3f} ms; the earlier "
        f"path's _param_grads {out['param_grads_ms']:.3f} ms; bound "
        f"{out['bound_ms']:.3f} ms ({out['bound_by']}, {out['mb']:.0f} MB): "
        f"alone at {100 * out['bound_ms'] / out['device_ms']:.1f}%; f32 "
        f"max|d| {out['max_abs_err']:.3g}, {out['max_rel_err']:.3g} of the "
        f"twin's largest; bf16 {out['bf16_max_rel_err']:.3g}")
    return out


# ------------------------------------------------------------ phase 9
# the train slice: the trainer entry point, the events step, an A/B

def phase_train(torch, dev, config, state_dict, card):
    import shutil
    from sdformerflow_tpu_torch import train_dsec
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.ops import hopper_voxel as V
    from sdformerflow_tpu_torch.training import train_loop as TL
    from sdformerflow_tpu_torch.training.checkpoints import (
        latest_epoch, restore_checkpoint)
    run_dir = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                           "smoke_train_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    records, start = [], {}

    def counters():
        return (P.fused_affine_psn.launches, P.fused_psn_backward.launches,
                V.voxel_k3.launches)

    make = TL.make_train_step

    def timed_make_train_step(*args, **kw):
        """The trainer's own step, with a sync and a clock around it."""
        step = make(*args, **kw)

        def run(batch):
            if not start:
                start.update({k: v.detach().clone()
                              for k, v in step.model.state_dict().items()})
            torch.cuda.synchronize()
            c0, t0 = counters(), time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            records.append(((time.perf_counter() - t0) * 1e3,
                            out["loss"].item(),
                            [a - b for a, b in zip(counters(), c0)]))
            return out
        return run

    TL.make_train_step = timed_make_train_step
    torch.cuda.reset_peak_memory_stats()
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    V.voxel_k3.launches = 0
    t0 = time.perf_counter()
    try:
        model, opt = train_dsec.main(
            ["--config", CONFIG, "--synthetic", "--max_steps",
             str(N_TRAIN_STEPS), "--run_dir", run_dir])
    finally:
        TL.make_train_step = make
    wall = time.perf_counter() - t0
    # the whole run's counts (K2 also serves the validation forwards)
    run_launches = dict(zip(("K2", "K2b", "K3"), counters()))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(records) == N_TRAIN_STEPS, f"{len(records)} train steps")
    ms = [r[0] for r in records]
    losses = [r[1] for r in records]
    check(all(np.isfinite(losses)), f"non-finite train losses {losses}")
    launches = {name: [r[2][i] for r in records]
                for i, name in enumerate(("K2", "K2b", "K3"))}
    check(len(set(launches["K2"])) == 1 and launches["K2"] == launches["K2b"]
          and launches["K2"][0] > 0
          and run_launches["K2b"] == sum(launches["K2b"]),
          f"K2 / K2b launches per step: {launches}; in the run: "
          f"{run_launches}")
    check(int(opt.count) == N_TRAIN_STEPS and int(opt.notfinite_count) == 0,
          f"{int(opt.count)} updates, {int(opt.notfinite_count)} skipped")
    final = model.state_dict()
    moved = {kind: sum(not torch.equal(start[k], final[k]) for k in start
                       if k.endswith(kind))
             for kind in ("weight", "running_mean", "running_var")}
    check(all(moved.values()), f"parameters / BN statistics moved: {moved}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    names = {r["name"] for r in recs}
    check({"train_loss", "valid_loss"} <= names
          and all(np.isfinite(r["value"]) for r in recs),
          f"metrics.jsonl: {recs}")
    # the checkpoint restores to identical tensors
    ckpt = os.path.join(run_dir, "ckpt")
    fresh, fresh_opt, _ = en4_trainer(torch, dev, config, state_dict)
    step_no, epoch = restore_checkpoint(ckpt, fresh, fresh_opt)
    same = all(torch.equal(v, final[k]) for k, v in fresh.state_dict().items())
    same_opt = (torch.equal(fresh_opt.m, opt.m)
                and torch.equal(fresh_opt.v, opt.v)
                and int(fresh_opt.count) == int(opt.count))
    check(latest_epoch(ckpt) == 0 and same and same_opt
          and step_no == N_TRAIN_STEPS,
          f"checkpoint round trip: epoch {epoch}, step {step_no}, model "
          f"{same}, optimizer {same_opt}")
    del fresh, fresh_opt
    p50, p90 = (float(v) for v in np.percentile(ms[2:], [50, 90]))
    log(f"[9] trainer entry (train_dsec --synthetic, en4 f32, TF32 off, "
        f"batch 1, 480x640 -> random crop 288x384): {N_TRAIN_STEPS} steps "
        f"in {wall:.1f} s with validation; step ms after 2 warm-up steps on "
        f"{card}: p50 {p50:.2f}, p90 {p90:.2f}, min {min(ms[2:]):.2f}, max "
        f"{max(ms[2:]):.2f} (first two {ms[0]:.1f}, {ms[1]:.1f}); losses "
        f"{losses[0]:.4g} -> {losses[-1]:.4g}, all finite; per step K2 "
        f"{launches['K2'][0]}, K2b {launches['K2b'][0]}, K3 "
        f"{launches['K3'][0]} launches (the whole run {run_launches}); "
        f"peak memory {peak_gb:.2f} GiB; "
        f"moved {moved}; metrics.jsonl {sorted(names)}; checkpoint epoch "
        f"{epoch} restores to identical tensors")

    # the card's busy time per step (profiler), the trained model going on
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    batch = train_batch(torch, dev, TRAIN_HW, SEED + 22)
    gen = torch.Generator(dev).manual_seed(SEED + 23)
    step = make_train_step(model, opt, norm_input="minmax", generator=gen)
    step(batch)
    dev_ms = device_ms_per_call(torch, lambda: step(batch), 3)
    log("[9] device busy per train step (union of kernel intervals, "
        "profiler, 3 steps): " + (
            "not measured: the profiler recorded no kernel" if dev_ms is None
            else f"{dev_ms:.2f} ms, {100 * dev_ms / p50:.1f}% of the p50"))
    split = train_step_split(torch, model, opt, batch)
    log(f"[9] train step by part (host clock, a sync after each part, median "
        f"of 3): forward + loss {split['forward_ms']:.2f} ms, backward "
        f"{split['backward_ms']:.2f} ms, optimizer {split['optimizer_ms']:.2f}"
        f" ms")

    # the raw-events train step: 480x640 events, K3, center crop
    from sdformerflow_tpu_torch.data.augmentation import center_crop
    from sdformerflow_tpu_torch.data.dsec import (SyntheticEventListDataset,
                                                  _collate)
    ds = SyntheticEventListDataset(num_samples=2, num_bins=10,
                                   height=SENSOR[0], width=SENSOR[1],
                                   seed=SEED + 24)
    ev_step = make_train_step(
        model, opt, norm_input="minmax", generator=gen, crop=TRAIN_HW,
        voxelize=dict(num_bins=10, height=SENSOR[0], width=SENSOR[1]))
    ev_ms, ev_losses, n_events = [], [], []
    for i in range(2):
        b = _collate([ds[i]])
        n_events.append(int(b["events"]["valid"].sum()))
        ev = {k: torch.from_numpy(v).to(dev) for k, v in b["events"].items()}
        label, mask = (torch.from_numpy(b[k]).to(dev)
                       for k in ("label", "mask"))
        _, label, mask = center_crop(label, label, mask, TRAIN_HW)
        k3 = V.voxel_k3.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ev_step({"events": ev, "label": label, "mask": mask})["loss"]
        ev_losses.append(loss.item())
        ev_ms.append((time.perf_counter() - t0) * 1e3)
        check(V.voxel_k3.launches == k3 + 1, "events train step: K3 "
              f"launched {V.voxel_k3.launches - k3} times for 1 row")
    check(all(np.isfinite(ev_losses)), f"events losses {ev_losses}")
    log(f"[9] events train step ({n_events} events at {SENSOR[0]}x"
        f"{SENSOR[1]}, K3 +1 per row, crop {TRAIN_HW[0]}x{TRAIN_HW[1]}): "
        f"losses {ev_losses}, {ev_ms[0]:.1f} / {ev_ms[1]:.1f} ms")
    del model, opt, step, ev_step
    torch.cuda.empty_cache()
    ab = phase_train_ab(torch, dev, config)
    return dict(p50_ms=p50, p90_ms=p90, step_ms=ms,
                device_ms_per_step=dev_ms, peak_mem_gib=peak_gb, **split,
                steps=N_TRAIN_STEPS, losses=losses,
                launches_per_step={k: v[0] for k, v in launches.items()},
                launches_trainer_run=run_launches, events_step_ms=ev_ms, events_losses=ev_losses, ab_96x128=ab)


def train_step_split(torch, model, opt, batch, n=3):
    """Median host ms of a train step's forward + loss, backward and
    optimizer update, with a sync after each."""
    from sdformerflow_tpu_torch.losses import flow_loss_supervised
    from sdformerflow_tpu_torch.ops.normalization import encode_input
    parts = []
    for _ in range(n):
        opt.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = flow_loss_supervised(model(encode_input(batch["chunk"]))["flow"],
                                    batch["label"], batch["mask"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    med = np.median(np.asarray(parts), axis=0)
    return dict(forward_ms=float(med[0]), backward_ms=float(med[1]),
                optimizer_ms=float(med[2]))


def phase_train_ab(torch, dev, config):
    """96x128, float32, TF32 off: one train step's loss and gradients with
    the kernels and with the plain twins, from the same state and batch (and
    the same drop-path draws). Every K2 launch is held against its twin;
    with no flipped spike the losses must be identical and every gradient
    leaf within 1e-4 of its norm."""
    import functools
    from sdformerflow_tpu_torch.losses import flow_loss_supervised
    from sdformerflow_tpu_torch.models.common import SpikingConfig, SwinConfig
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.models.spiking_swin import SpikingSwinBlock3D
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.ops.normalization import encode_input
    swin = SwinConfig(input_size=(96, 128), depths=(2, 2, 2, 2),
                      num_heads=(2, 2, 4, 4), window_size=(2, 3, 3))
    model = get_model(config["model"]["name"],
                      {"num_bins": 10, "base_num_channels": 16}, swin,
                      SpikingConfig(num_steps=10, v_th=0.1,
                                    neuron_type="psn"), train=True)
    randomize_(model, torch.Generator().manual_seed(SEED + 5))
    model.to(dev)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    batch = train_batch(torch, dev, (96, 128), SEED + 41)
    flips = [0, 0]

    def checked_forward(x, w, b, *, scale=None, shift=None):
        y = P.fused_affine_psn(x, w, b, scale=scale, shift=shift)
        flips[0] += int((y != P.psn_spike(x, w, b, scale=scale,
                                          shift=shift)).sum())
        flips[1] += y.numel()
        return y

    def run(impl):
        model.load_state_dict(state0)
        model.zero_grad(set_to_none=True)
        for m in model.modules():
            if isinstance(m, SpikingSwinBlock3D):
                m.drop_path_generator = torch.Generator(dev).manual_seed(SEED)
        with site_functions(functools.partial(P.affine_psn, impl=impl)):
            x = encode_input(batch["chunk"])
            loss = flow_loss_supervised(model(x)["flow"], batch["label"],
                                        batch["mask"])
            loss.backward()
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()
                             if p.grad is not None}

    k2b0 = P.fused_psn_backward.launches
    loss_k, grads_k = run(P.PSNImpl(checked_forward, P.fused_psn_backward))
    check(P.fused_psn_backward.launches > k2b0, "A/B: K2b not launched")
    loss_p, grads_p = run(P.PLAIN)
    check(set(grads_k) == set(grads_p), "A/B: different gradient leaves")
    # (|d|, |g|, name) per leaf. A bias before a train-mode BN has a zero
    # gradient in exact arithmetic (the BN subtracts the batch mean): its
    # computed gradient is float32 noise, ~1e-9 against a total ~10. So a
    # leaf passes within 1e-4 of its norm plus 1e-7 of the total norm (the
    # float32 resolution of the whole gradient); the worst share is read
    # over the leaves above 1e-5 of the total.
    rows = [((grads_k[n] - g).norm().item(), g.norm().item(), n)
            for n, g in grads_p.items()]
    total = float(np.sqrt(sum(r[1] ** 2 for r in rows)))
    bad = [r for r in rows if r[0] > 1e-4 * r[1] + 1e-7 * total]
    resolved = [r for r in rows if r[1] > 1e-5 * total]
    worst, worst_norm, worst_name = max(
        (d / g, g, n) for d, g, n in resolved)
    check(flips[0] <= MAX_FLIP_SHARE * flips[1],
          f"A/B: K2 flipped {flips[0]} of {flips[1]} spikes")
    if flips[0] == 0:
        check(loss_k == loss_p, f"A/B: no spike flipped, yet the losses "
              f"differ: {loss_k} vs {loss_p}")
        check(not bad, f"A/B: gradient leaves off (|d|, |g|, name), total "
              f"norm {total:.3g}: {bad[:6]}")
    log(f"[9] 96x128 f32 A/B, one train step from one state and batch: K2 "
        f"flipped {flips[0]} of {flips[1]} spikes; loss kernels {loss_k!r}, "
        f"plain {loss_p!r}; gradients: worst |d|/|g| {worst:.3g} over the "
        f"{len(resolved)} leaves above 1e-5 of the total norm {total:.3g} "
        f"({worst_name}); largest |d| among the {len(rows) - len(resolved)} "
        f"below it (the biases before a train-mode BN among them) "
        f"{max((r[0] for r in rows if r not in resolved), default=0):.3g}")
    del model
    torch.cuda.empty_cache()
    return dict(k2_flipped=flips[0], k2_spikes=flips[1], loss_kernels=loss_k,
                loss_plain=loss_p, worst_grad_rel=worst,
                leaves=len(rows), leaves_resolved=len(resolved),
                grad_norm=total)


# ----------------------------------------------------------- phase 10
# the fused-embed eval path (K4 + K4a through make_eval_step(fused_embed=
# True)), K2c, and the s2d embed (FlowServer(s2d=True))

N_EMBED_REQUESTS = 32   # interleaved latency requests per path
N_EMBED_COUNTED = 16    # requests of the counted run of each path
# K4 vs its twin on Gaussian inputs: the largest |d| over the twin's largest
# magnitude. float32: the sums run in another order (1e-5); bfloat16: one
# rounding of the largest value (2^-7)
K4_TOL = 1e-5
K4_TOL_BF16 = 2.0 ** -7
K2C_SHAPES = ((10, 27648, 96), (10, 6912, 96))


class SiteCall:
    """Stands in for one of ``ops/hopper_embed.py``'s kernel entries
    (``conv3x3_affine_cs`` or ``psn_spike_cs``) during a checked run: calls
    the real entry, whose own count then lands on this object's
    ``launches``, and hands the call to ``on_call(args, kwargs, out)``."""

    def __init__(self, real, on_call):
        self.real, self.on_call, self.launches = real, on_call, 0

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.on_call(args, kwargs, out)
        return out


@contextlib.contextmanager
def embed_sites(on_conv, on_spike):
    """Route the fused embed's K4 and K4a calls through :class:`SiteCall`."""
    from sdformerflow_tpu_torch.ops import hopper_embed as E
    saved = E.conv3x3_affine_cs, E.psn_spike_cs
    E.conv3x3_affine_cs = SiteCall(saved[0], on_conv)
    E.psn_spike_cs = SiteCall(saved[1], on_spike)
    try:
        yield
    finally:
        E.conv3x3_affine_cs, E.psn_spike_cs = saved


def capture_embed(torch, step, chunk):
    """The K4 calls (x, weight, scale, shift, stride) and K4a calls (x, W,
    b) of one fused-embed request, inputs cloned."""
    convs, spikes = [], []

    def on_conv(args, kw, out):
        x, w, sc, sh = (tuple(args) + (None, None))[:4]
        sc, sh = kw.get("scale", sc), kw.get("shift", sh)
        convs.append((x.clone(), w, sc, sh, kw.get("stride", 1)))

    def on_spike(args, kw, out):
        spikes.append((args[0].clone(), args[1], args[2]))

    with torch.inference_mode(), embed_sites(on_conv, on_spike):
        step(chunk)
    return convs, spikes


def conv_bound(x, w, out, stride):
    """(ms, basis) of one K4 launch: the inputs its outputs read (all of x,
    but only the kept pixels x[..., ::stride, ::stride] of a strided 1x1),
    w and a/b read, out written once; 2 Cin k^2 operations per output on the
    bf16 tensor cores (the card's peak for the main path's type)."""
    cout, cin, k, _ = w.shape
    x_read = x[..., ::stride, ::stride] if k == 1 else x
    flops = 2 * out.numel() * cin * k * k
    return bound(nbytes(x_read, w, out) + 8 * cout, flops, BF16_TC_FLOP_S)


def phase_k4(torch, dev, convs):
    """K4 vs its twin at each launch shape of the fused embed, float32 and
    bfloat16: bitwise on dyadic inputs, within K4_TOL / K4_TOL_BF16 on
    Gaussian ones; kernel, twin and cuDNN (one F.conv2d with the affine
    folded into weight and bias, same dtype) timed on the main path's input
    beside the bound."""
    import torch.nn.functional as F
    from sdformerflow_tpu_torch.ops import hopper_embed as E
    gen = torch.Generator(dev).manual_seed(SEED + 30)
    out = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, f32_ms=0.0,
               earlier_ms=0.0, device_ms=0.0, earlier_device_ms=0.0,
               max_abs_err=0.0, max_rel_err=0.0, bf16_max_rel_err=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for x_real, w_real, sc_real, sh_real, stride in convs:
        N, cin, H, W = x_real.shape
        cout, _, k, _ = w_real.shape
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x = dyadic((N, cin, H, W), 0.25, -2.0, 2.0, gen, dev, dt)
            w = dyadic((cout, cin, k, k), 0.125, -1.0, 1.0, gen, dev, dt)
            a = dyadic((cout,), 0.25, 0.25, 2.0, gen, dev, torch.float32)
            b = dyadic((cout,), 0.25, -1.0, 1.0, gen, dev, torch.float32)
            got = E.conv3x3_affine_cs(x, w, a, b, stride=stride)
            # cuDNN may pick Winograd, whose transforms round: the exact
            # reference is PyTorch's own im2col + GEMM convolution
            with torch.backends.cudnn.flags(enabled=False):
                want = E.conv3x3_affine_cs_plain(x, w, a, b, stride=stride)
            err = (got.float() - want.float()).abs().max().item()
            check(err == 0.0, f"K4 {list(x.shape)} k{k} s{stride} {dt} "
                  f"dyadic: max|d| {err}")
            check(want.abs().max().item() > 0, "K4 dyadic: all-zero output")
            xg = torch.randn(x.shape, generator=gen, device=dev).to(dt)
            wg = (torch.randn(w.shape, generator=gen, device=dev)
                  * 0.2).to(dt)
            ag = torch.rand(cout, generator=gen, device=dev) + 0.5
            bg = torch.randn(cout, generator=gen, device=dev)
            ad, rd = rel_err(E.conv3x3_affine_cs(xg, wg, ag, bg,
                                                 stride=stride),
                             E.conv3x3_affine_cs_plain(xg, wg, ag, bg,
                                                       stride=stride))
            tol = K4_TOL if dt == torch.float32 else K4_TOL_BF16
            check(rd <= tol, f"K4 {list(x.shape)} k{k} s{stride} {dt} "
                  f"gaussian: max|d| {rd:.3g} of the twin's largest")
            errs[dt] = rd
            if dt == torch.float32:
                out["max_rel_err"] = max(out["max_rel_err"], rd)
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["f32_ms"] += cuda_time_ms(
                    lambda: E.conv3x3_affine_cs(xg, wg, ag, bg,
                                                stride=stride), iters=10)
            else:
                out["bf16_max_rel_err"] = max(out["bf16_max_rel_err"], rd)
        # the main path's own launch (bf16), its twin and cuDNN
        run = lambda: E.conv3x3_affine_cs(x_real, w_real, sc_real,  # noqa: E731
                                          sh_real, stride=stride)
        y = run()
        t_k = cuda_time_ms(run, iters=10)
        t_p = cuda_time_ms(lambda: E.conv3x3_affine_cs_plain(
            x_real, w_real, sc_real, sh_real, stride=stride), iters=10)
        # the first, CUDA-core K4 on the same input: the yardstick
        t_e = cuda_time_ms(lambda: E.prepare_conv3x3_affine_cs(
            x_real, w_real, sc_real, sh_real, stride=stride,
            cuda_cores=True)[0](), iters=10)
        # the kernels alone: back-to-back launches of prepared arguments
        d_k = cuda_time_ms(E.prepare_conv3x3_affine_cs(
            x_real, w_real, sc_real, sh_real, stride=stride)[0], iters=10)
        d_e = cuda_time_ms(E.prepare_conv3x3_affine_cs(
            x_real, w_real, sc_real, sh_real, stride=stride,
            cuda_cores=True)[0], iters=10)
        a_f = (torch.ones(cout, device=dev) if sc_real is None
               else sc_real.float())
        w_f = (w_real.float() * a_f.reshape(-1, 1, 1, 1)).to(x_real.dtype)
        b_f = None if sh_real is None else sh_real.to(x_real.dtype)
        lib = F.conv2d(x_real, w_f, b_f, stride=stride, padding=k // 2)
        check(lib.shape == y.shape, f"cuDNN shape {lib.shape} vs {y.shape}")
        t_l = cuda_time_ms(lambda: F.conv2d(x_real, w_f, b_f, stride=stride,
                                            padding=k // 2), iters=10)
        b_ms, by = conv_bound(x_real, w_real, y, stride)
        bound_by[by] += b_ms
        out["ms"] += t_k
        out["plain_ms"] += t_p
        out["library_ms"] += t_l
        out["earlier_ms"] += t_e
        out["device_ms"] += d_k
        out["earlier_device_ms"] += d_e
        log(f"[10] K4 {cin}->{cout} k{k} s{stride} at {H}x{W} (N={N}): "
            f"dyadic bitwise f32/bf16, gaussian max|d| f32 "
            f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g} of "
            f"the twin's largest; bf16 wrapper {t_k:.4f} ms (CUDA-core K4 "
            f"{t_e:.4f}), plain {t_p:.4f} ms, cuDNN {t_l:.4f} ms; alone: "
            f"kernel {d_k:.4f} ms, CUDA-core K4 {d_e:.4f}; "
            f"{2 * y.numel() * cin * k * k / 1e9:.2f} GFLOP, bound "
            f"{b_ms:.4f} ms ({by}): kernel alone at {100 * b_ms / d_k:.1f}% "
            f"of it (CUDA-core K4 {100 * b_ms / d_e:.1f}%, cuDNN "
            f"{100 * b_ms / t_l:.1f}%)")
    out.update(bound_ms=sum(bound_by.values()),
               bound_by=max(bound_by, key=bound_by.get), n_shapes=len(convs))
    log(f"[10] K4 per request ({len(convs)} launches, bf16): wrapper "
        f"{out['ms']:.3f} ms (f32 {out['f32_ms']:.3f}; CUDA-core K4 "
        f"{out['earlier_ms']:.3f}), kernel alone {out['device_ms']:.3f} ms "
        f"(CUDA-core K4 {out['earlier_device_ms']:.3f}), twin "
        f"{out['plain_ms']:.3f} ms, cuDNN {out['library_ms']:.3f} ms, bound "
        f"{out['bound_ms']:.4f} ms "
        f"({out['bound_by']}): kernel alone at "
        f"{100 * out['bound_ms'] / out['device_ms']:.1f}% of it")
    return out


def psn_check(torch, dev, gen, shape, fn, plain, label, real=None):
    """A PSN entry with no affine (K4a, K2c) vs its twin at ``shape``:
    bitwise on dyadic inputs in float32 and bfloat16, the flipped share on
    Gaussian ones; kernel and twin timed on ``real`` (or a Gaussian bf16
    input) beside the bound. Returns (dyadic max|d|, worst flip share, ms,
    plain ms, bound ms, basis)."""
    T = shape[0]
    flips, max_err = [], 0.0
    for dt in (torch.float32, torch.bfloat16):
        x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
        w = dyadic((T, T), 0.125, -1.0, 1.0, gen, dev, torch.float32)
        b = dyadic((T, 1), 0.25, -1.0, 1.0, gen, dev, torch.float32)
        got = fn(x, w, b)
        err = (got.float() - plain(x, w, b).float()).abs().max().item()
        max_err = max(max_err, err)
        check(got.dtype == dt and err == 0.0,
              f"{label} {list(shape)} {dt} dyadic: max|d| {err} from the "
              f"twin")
        check(0.0 < got.float().mean().item() < 1.0,
              f"{label} dyadic: degenerate output")
        xg = torch.randn(shape, generator=gen, device=dev).to(dt)
        wg = torch.randn(T, T, generator=gen, device=dev) * 0.4
        bg = torch.randn(T, 1, generator=gen, device=dev) * 0.4
        flip = (fn(xg, wg, bg) != plain(xg, wg, bg)).float().mean().item()
        check(flip <= MAX_FLIP_SHARE, f"{label} gaussian flips {flip}")
        flips.append(flip)
    x_t, w_t, b_t = real if real is not None else (
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16), wg,
        bg)
    t_k = cuda_time_ms(lambda: fn(x_t, w_t, b_t))
    t_p = cuda_time_ms(lambda: plain(x_t, w_t, b_t))
    n_col = x_t.numel() // T
    b_ms, by = bound(2 * nbytes(x_t) + (T * T + T) * 4, 2 * T * T * n_col,
                     F32_FLOP_S)
    log(f"[10] {label} {list(shape)}: dyadic bitwise f32/bf16, gaussian "
        f"flipped share {flips}; {str(x_t.dtype)[6:]} kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms; bound {b_ms:.4f} ms ({by}), kernel at "
        f"{100 * b_ms / t_k:.1f}% of it")
    return max_err, max(flips), t_k, t_p, b_ms, by


def phase_k4a_k2c(torch, dev, spikes):
    """K4a at each PSN site of the fused embed and K2c at K2C_SHAPES."""
    from sdformerflow_tpu_torch.ops import hopper_embed as E
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    gen = torch.Generator(dev).manual_seed(SEED + 31)
    res = {}
    for label, fn, plain, cases in (
            ("K4a", E.psn_spike_cs, E.psn_spike_cs_plain,
             [(tuple(x.shape), (x, w, b)) for x, w, b in spikes]),
            ("K2c", P.psn_spike_tm, P.psn_spike_tm_plain,
             [(s, None) for s in K2C_SHAPES])):
        r = dict(flip_share=0.0, ms=0.0, plain_ms=0.0, max_abs_err=0.0)
        bound_by = {"bytes": 0.0, "operations": 0.0}
        for shape, real in cases:
            err, flip, t_k, t_p, b_ms, by = psn_check(torch, dev, gen, shape,
                                                      fn, plain, label, real)
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["flip_share"] = max(r["flip_share"], flip)
            r["ms"] += t_k
            r["plain_ms"] += t_p
            bound_by[by] += b_ms
        r.update(bound_ms=sum(bound_by.values()),
                 bound_by=max(bound_by, key=bound_by.get))
        res[label] = r
    return res


def request_loop(torch, steps, chunks):
    """Requests one at a time through each of ``steps`` (name -> eval
    step), interleaved request by request; host ms from the call to the
    finest flow on the host. Returns name -> (latencies, flows)."""
    out = {name: ([], []) for name in steps}
    for chunk in chunks:
        for name, step in steps.items():
            t0 = time.perf_counter()
            flow = step(chunk)[-1][0].cpu().numpy()
            out[name][0].append((time.perf_counter() - t0) * 1e3)
            out[name][1].append(flow)
    return out


def spike_recorders(records):
    """Site functions (``site_functions``) and a fused-embed K4a hook
    (``embed_sites``) that launch the kernels and append each spike site's
    0/1 output, channels-last, to the list ``records`` in the order the
    forward reaches them: (name, spikes), name "psn" or "K1"."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops.hopper_psn import fused_affine_psn

    def psn(x, w, b, *, scale=None, shift=None, **_):
        y = fused_affine_psn(x, w, b, scale=scale, shift=shift)
        records.append(("psn", y.bool()))
        return y

    def attend(x, p, nh):
        a = A.qk_attn_interior(x, p, nh)
        records.append(("K1", a.bool()))
        return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)

    def on_spike(args, kw, out):      # K4a: [T, B, C, H, W]
        records.append(("psn", out.permute(0, 1, 3, 4, 2).bool()))
    return psn, attend, on_spike


def path_flips(a, b, head_s2d=False):
    """Two recorded forwards compared site by site, in order (the first
    site of ``a`` taken to block space if ``head_s2d``): (spikes differing
    in all, spikes in all, index of the first site that differs or None,
    the share of that site's spikes that differ). Up to the first differing
    site the two forwards differ by rounding alone, so a right re-expression
    flips only a rounding-sized share there; after it the forward is
    chaotic (PERF.md: one flipped spike moves a full-width flow by AEE ~5).
    Raises if the two runs reach different sites."""
    from sdformerflow_tpu_torch.ops.s2d import space_to_depth
    check(len(a) == len(b), f"{len(a)} vs {len(b)} spike sites")
    n_flip, n, first, first_share = 0, 0, None, 0.0
    for i, ((ka, u), (kb, v)) in enumerate(zip(a, b)):
        if head_s2d and i == 0:
            u = space_to_depth(u)
        check(ka == kb and u.shape == v.shape, f"site {i}: {ka} "
              f"{tuple(u.shape)} vs {kb} {tuple(v.shape)}")
        d = int((u != v).sum())
        if d and first is None:
            first, first_share = i, d / u.numel()
        n_flip += d
        n += u.numel()
    return n_flip, n, first, first_share


def f32_embed_ab(torch, label, model, chunk):
    """Float32 on the card (TF32 off): the fused-embed step against the
    module step on one chunk. Each K4 launch is held against its twin
    (largest |d| within K4_TOL of the twin's largest) and each K4a launch
    against its twin (flips); every spike site of the two runs is compared;
    with no spike differing between the runs, the flows must be equal."""
    from sdformerflow_tpu_torch.losses import aee_metrics
    from sdformerflow_tpu_torch.ops import hopper_embed as E
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    T = model.sttmultires_unet.encoders.patch_embed.num_steps
    steps = {"module": make_eval_step(model),
             "fused": make_eval_step(model, fused_embed=True, num_steps=T)}
    recs, flows = {}, {}
    k4 = {"err": 0.0, "n": 0}
    k4a = [0, 0]

    def on_conv(args, kw, out):
        x, w, sc, sh = (tuple(args) + (None, None))[:4]
        sc, sh = kw.get("scale", sc), kw.get("shift", sh)
        want = E.conv3x3_affine_cs_plain(x, w, sc, sh,
                                         stride=kw.get("stride", 1))
        k4["err"] = max(k4["err"], rel_err(out, want)[1])
        k4["n"] += 1

    for name, step in steps.items():
        recs[name] = []
        psn, attend, on_spike = spike_recorders(recs[name])

        def on_spike_checked(args, kw, out, on_spike=on_spike):
            on_spike(args, kw, out)
            want = E.psn_spike_cs_plain(*args, **kw)
            k4a[0] += int((out != want).sum())
            k4a[1] += out.numel()

        with site_functions(psn, attend), \
                embed_sites(on_conv, on_spike_checked):
            flows[name] = step(chunk)[-1].double().cpu()
    check(k4["n"] == 8 and k4a[1] > 0, f"{label}: {k4['n']} K4 launches")
    check(k4["err"] <= K4_TOL, f"{label}: K4 vs its twin {k4['err']:.3g}")
    check(k4a[0] <= MAX_FLIP_SHARE * k4a[1],
          f"{label}: K4a flipped {k4a[0]} of {k4a[1]}")
    n_flip, n, first, share = path_flips(recs["module"], recs["fused"])
    check(share <= MAX_FLIP_SHARE, f"{label}: at spike site {first}, the "
          f"first where the fused and the module path differ, {share:.3g} "
          f"of the spikes differ")
    if n_flip == 0:
        check(torch.equal(flows["fused"], flows["module"]),
              f"{label}: no spike differs, yet the flows do")
    aee = aee_metrics(flows["fused"], flows["module"],
                      torch.ones_like(flows["module"][:, :1]))["AEE"].item()
    log(f"[10] {label} f32 fused embed vs module embed: K4 launches within "
        f"{k4['err']:.3g} of their twins' largest, K4a {k4a[0]} of {k4a[1]} "
        f"spikes flipped vs its twin; spikes differing between the paths "
        f"{n_flip} of {n} (first at site {first} of {len(recs['fused'])}, "
        f"{share:.3g} of its spikes); flows "
        f"{'identical' if n_flip == 0 else f'AEE {aee:.6g} apart'}")
    return dict(k4_rel_err=k4["err"], k4a_flipped=k4a[0],
                path_flipped=n_flip, spikes=n, first_site=first,
                first_site_share=share, aee=aee)


def small_config(config):
    """The en4 config cut to the 96x128 geometry of phase 7 (base 16,
    depths (2, 2, 2, 2), heads (2, 2, 4, 4), window (2, 3, 3))."""
    import copy
    small = copy.deepcopy(config)
    small["model"]["base_num_channels"] = 16
    small["swin_transformer"].update(swin_depths=[2, 2, 2, 2],
                                     swin_num_heads=[2, 2, 4, 4],
                                     window_size=[2, 3, 3])
    small["loader"]["crop"] = [96, 128]
    return small


def small_en4(torch, config):
    """(config, model config, SwinConfig, SpikingConfig, state_dict) of
    :func:`small_config`, weights seeded."""
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs
    small = small_config(config)
    mcfg, swin, cfg = build_configs(small)
    state = randomize_(get_model(small["model"]["name"], mcfg, swin, cfg),
                       torch.Generator().manual_seed(SEED + 5)).state_dict()
    return small, mcfg, swin, cfg, state


def f32_s2d_ab(torch, dev, label, config, state_dict, request):
    """Float32 on the card: ``FlowServer(s2d=True)`` against
    ``FlowServer(s2d=False)`` on one request, every spike site of the two
    forwards compared (the head's in block space); with none differing,
    the flows must be equal."""
    from sdformerflow_tpu_torch.serving import FlowServer
    recs, flows = {}, {}
    for name, s2d in (("base", False), ("s2d", True)):
        recs[name] = []
        psn, attend, _ = spike_recorders(recs[name])
        with FlowServer(config, state_dict, device=dev, bf16=False,
                        s2d=s2d) as server, site_functions(psn, attend):
            flows[name] = server.infer(request)
    n_flip, n, first, share = path_flips(recs["base"], recs["s2d"],
                                         head_s2d=True)
    check(share <= MAX_FLIP_SHARE, f"{label}: at spike site {first}, the "
          f"first where the s2d and the base server differ, {share:.3g} of "
          f"the spikes differ")
    if n_flip == 0:
        check(np.array_equal(flows["s2d"], flows["base"]),
              f"{label}: no spike differs, yet the s2d flows do")
    log(f"[10] {label} f32 FlowServer(s2d=True) vs s2d=False: spikes "
        f"differing {n_flip} of {n} (first at site {first}, {share:.3g} of "
        f"its spikes); flows {'identical' if n_flip == 0 else 'differ'}")
    return dict(path_flipped=n_flip, spikes=n, first_site=first,
                first_site_share=share)


def phase_embed(torch, dev, config, state_dict, card):
    """The fused-embed eval step and FlowServer(s2d=True) at full en4
    width (bf16), their launch counts, latency and device busy time beside
    the module path's; K4, K4a and K2c against their twins; the float32
    A/Bs at 96x128 and at full width."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.models.spiking_swin import (
        SpikingQKWindowAttention3D)
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_embed as E
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.train_step import (cast_params,
                                                            make_eval_step)
    model_cfg, swin, cfg = build_configs(config)
    name = config["model"]["name"]
    T = cfg.num_steps
    hw = tuple(config["loader"]["crop"])
    model = get_model(name, model_cfg, swin, cfg)
    model.load_state_dict(state_dict)
    model = cast_params(model.to(dev), torch.bfloat16)
    n_attn = sum(isinstance(m, SpikingQKWindowAttention3D)
                 for m in model.modules())
    steps = {"module": make_eval_step(model, compute_dtype=torch.bfloat16),
             "fused": make_eval_step(model, compute_dtype=torch.bfloat16,
                                     fused_embed=True, num_steps=T)}
    chunks = [torch.from_numpy(r)[None].to(dev) for r in
              voxel_requests(N_EMBED_REQUESTS, 10, hw, SEED + 32)]
    convs, spikes = capture_embed(torch, steps["fused"], chunks[0])
    check(len(convs) == 8 and len(spikes) == 6,
          f"fused embed: {len(convs)} K4 and {len(spikes)} K4a calls")
    with torch.inference_mode():
        k4 = phase_k4(torch, dev, convs)
        psn = phase_k4a_k2c(torch, dev, spikes)
    del convs, spikes
    for step in steps.values():           # warm-up outside the counts
        step(chunks[0])
    counters = (E.conv3x3_affine_cs, E.psn_spike_cs, A.qk_attn_interior,
                P.fused_affine_psn, P.psn_spike_tm)
    for c in counters:
        c.launches = 0
    counted = chunks[:N_EMBED_COUNTED]
    fused_only = request_loop(torch, {"fused": steps["fused"]}, counted)
    n_k4, n_k4a, n_k1, n_k2, n_k2c = (c.launches for c in counters)
    for c in counters:
        c.launches = 0
    module_only = request_loop(torch, {"module": steps["module"]}, counted)
    module_k2 = P.fused_affine_psn.launches
    n = len(counted)
    check(n_k4 == 8 * n and n_k4a == 6 * n and n_k1 == n_attn * n,
          f"fused path launches for {n} requests: K4 {n_k4}, K4a {n_k4a}, "
          f"K1 {n_k1}")
    check(module_k2 % n == 0 and n_k2 == module_k2 - 6 * n and n_k2c == 0,
          f"K2 launches: fused {n_k2}, module {module_k2} for {n} requests")
    for flow in fused_only["fused"][1] + module_only["module"][1]:
        check(flow.shape == (2,) + hw and np.isfinite(flow).all(),
              f"flow {flow.shape}, finite {np.isfinite(flow).all()}")
    timed = request_loop(torch, steps, chunks)    # interleaved: latency
    lat = {k: [float(v) for v in np.percentile(timed[k][0], [50, 90])]
           for k in steps}
    busy = {k: device_ms_per_call(torch, lambda s=step: s(chunks[0]), 8)
            for k, step in steps.items()}
    mean_d = float(np.mean([np.abs(a - b).mean() for a, b in zip(
        fused_only["fused"][1], module_only["module"][1])]))
    log(f"[10] fused-embed eval step (make_eval_step(fused_embed=True, "
        f"num_steps={T}), en4 bf16 at {hw[0]}x{hw[1]}): {n} requests, flows "
        f"finite; per request K4 {n_k4 // n}, K4a {n_k4a // n}, K1 "
        f"{n_k1 // n}, K2 {n_k2 // n} (module path K2 {module_k2 // n}); "
        f"mean |flow_fused - flow_module| {mean_d:.4g} (bf16)")
    log(f"[10] latency over {len(chunks)} requests one at a time, fused "
        f"and module "
        f"interleaved, on {card}: fused p50 {lat['fused'][0]:.2f} ms, p90 "
        f"{lat['fused'][1]:.2f}; module p50 {lat['module'][0]:.2f}, p90 "
        f"{lat['module'][1]:.2f}; device busy per request (profiler, 8 "
        f"requests): fused {busy['fused']}, module {busy['module']} ms")
    del steps, model, timed, fused_only, module_only
    torch.cuda.empty_cache()

    # FlowServer(s2d=True) beside s2d=False, requests interleaved
    servers = {"base": FlowServer(config, state_dict, device=dev, bf16=True),
               "s2d": FlowServer(config, state_dict, device=dev, bf16=True,
                                 s2d=True)}
    try:
        reqs = voxel_requests(N_EMBED_REQUESTS, 10, hw, SEED + 33)
        for srv in servers.values():
            srv.warmup()
        A.qk_attn_interior.launches = P.fused_affine_psn.launches = 0
        s_lat = {k: [] for k in servers}
        for r in reqs:
            for k, srv in servers.items():
                t0 = time.perf_counter()
                flow = srv.infer(r)
                s_lat[k].append((time.perf_counter() - t0) * 1e3)
                check(flow.shape == (2,) + hw and np.isfinite(flow).all(),
                      f"{k} server flow {flow.shape}")
        check(A.qk_attn_interior.launches == 2 * n_attn * len(reqs)
              and P.fused_affine_psn.launches % (2 * len(reqs)) == 0,
              f"servers: K1 {A.qk_attn_interior.launches}, K2 "
              f"{P.fused_affine_psn.launches} for 2 x {len(reqs)} requests")
        s2d_lat = {k: [float(v) for v in np.percentile(s_lat[k], [50, 90])]
                   for k in servers}
        s2d_busy = {k: device_ms_per_call(
            torch, lambda s=srv: s.infer(reqs[0]), 8)
            for k, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.close()
    log(f"[10] FlowServer(s2d=True) vs s2d=False, en4 bf16 at {hw[0]}x"
        f"{hw[1]}, {len(reqs)} requests each, interleaved, on {card}: s2d "
        f"p50 {s2d_lat['s2d'][0]:.2f} ms, p90 {s2d_lat['s2d'][1]:.2f}; base "
        f"p50 {s2d_lat['base'][0]:.2f}, p90 {s2d_lat['base'][1]:.2f}; device "
        f"busy per request: s2d {s2d_busy['s2d']}, base {s2d_busy['base']} "
        f"ms")
    del servers
    torch.cuda.empty_cache()

    # float32 A/Bs at 96x128 and at full width
    small, mcfg, sw, scfg, small_state = small_en4(torch, config)
    ab = {}
    for label, args in (("96x128", (mcfg, sw, scfg, small_state)),
                        ("288x384", (model_cfg, swin, cfg, state_dict))):
        mc, sw_, cf, sd = args
        m = get_model(name, mc, sw_, cf)
        m.load_state_dict(sd)
        m.float().to(dev)
        chunk = torch.from_numpy(voxel_requests(
            1, 10, tuple(sw_.input_size), SEED + 34)[0])[None].to(dev)
        ab[f"fused_{label}"] = f32_embed_ab(torch, label, m, chunk)
        del m
        torch.cuda.empty_cache()
    ab["s2d_96x128"] = f32_s2d_ab(
        torch, dev, "96x128", small, small_state,
        voxel_requests(1, 10, (96, 128), SEED + 34)[0])
    return dict(k4=k4, k4a=psn["K4a"], k2c=psn["K2c"],
                launches=dict(K4=n_k4, K4a=n_k4a, K1=n_k1, K2=n_k2,
                              K2c=n_k2c, module_K2=module_k2, requests=n),
                fused_p50_p90=lat["fused"], module_p50_p90=lat["module"],
                fused_device_ms=busy["fused"],
                module_device_ms=busy["module"],
                s2d_p50_p90=s2d_lat["s2d"], base_p50_p90=s2d_lat["base"],
                s2d_device_ms=s2d_busy["s2d"],
                base_device_ms=s2d_busy["base"], f32_ab=ab)


# ----------------------------------------------------------- phase 11
# the MDR / MVSEC geometry: an odd window count at stage 4

MDR_CONFIG = os.path.join(ROOT, "configs", "train_mdr_sdformerflow.yaml")


def window_counts(torch, model, run):
    """Run ``run()`` and return the window count M of every attention
    call, in order."""
    from sdformerflow_tpu_torch.models.spiking_swin import (
        SpikingQKWindowAttention3D)
    counts, handles = [], []
    for m in model.modules():
        if isinstance(m, SpikingQKWindowAttention3D):
            handles.append(m.register_forward_pre_hook(
                lambda mod, args: counts.append(args[0].shape[1])))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return counts


def phase_odd_m(torch, dev):
    """MS_SpikingformerFlowNet_en4 at the geometry of
    configs/train_mdr_sdformerflow.yaml (T=5, window (2, 8, 8), 256x256 -
    also the MVSEC protocol's crop; full width, random weights), where the
    window count is odd at stage 4 (M = 3): a bfloat16 eval forward with
    every K1 launch (the even-M stages) and K2 launch held against its twin
    and the whole forward against the plain twins' (with no flipped spike,
    identical), the raw-refold form at stage 4; then one float32 train step
    (batch 1) with every K2b launch, at T = 5 and T = 2, held against its
    twin."""
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        load_config)
    from sdformerflow_tpu_torch.training.train_step import (cast_params,
                                                            make_eval_step)
    t0 = time.perf_counter()
    config = load_config(MDR_CONFIG)
    model_cfg, swin, cfg = build_configs(config)
    name = config["model"]["name"]
    model = get_model(name, model_cfg, swin, cfg)
    randomize_(model, torch.Generator().manual_seed(SEED + 60))
    state = model.state_dict()
    hw = tuple(config["loader"]["crop"])
    T = cfg.num_steps
    depths = tuple(swin.depths)
    chunk = torch.from_numpy(voxel_requests(
        1, config["model"]["num_bins"], hw, SEED + 61)[0])[None].to(dev)
    # bf16 params, f32 BN statistics, cast here so the hooks below see the
    # model the step runs
    model = cast_params(get_model(name, model_cfg, swin, cfg), torch.bfloat16)
    model.load_state_dict(state)
    step = make_eval_step(model.to(dev),
                          norm_input=config["model"]["norm_input"],
                          compute_dtype=torch.bfloat16)
    ms = window_counts(torch, model, lambda: step(chunk))
    fwd = checked_forward(torch, step, chunk, "odd-M forward")
    flow, k1, k2, flips, same = (fwd[k] for k in ("flow", "k1", "k2",
                                                  "flips", "same"))
    odd = [m for m in ms if m % 2]
    check(flow.shape == (1, 2) + hw and bool(torch.isfinite(flow).all()),
          f"odd-M forward: flow {tuple(flow.shape)}")
    check(len(ms) == sum(depths) and len(odd) == depths[-1]
          and all(m == ms[-1] for m in odd),
          f"odd-M forward: window counts {ms}, expected odd M at the "
          f"{depths[-1]} blocks of stage 4 only")
    check(k1 == len(ms) - len(odd), f"odd-M forward: K1 launched {k1} "
          f"times for {len(ms) - len(odd)} even-M attention sites")
    check(k2 > 0, "odd-M forward: K2 not launched")
    log(f"[11] en4 bf16 eval at {hw[0]}x{hw[1]}, T={T}, window "
        f"{tuple(swin.window_size)}: window counts per block {ms} (raw "
        f"refold at M={odd[0]}); K1 {k1} launches, K2 {k2}; each launch vs "
        f"its twin: K1 {flips['K1'][0]} of {flips['K1'][1]} spikes flipped, "
        f"K2 {flips['K2'][0]} of {flips['K2'][1]}; flow equal to the plain "
        f"path's: {same}")
    del step
    # one float32 train step at this geometry, batch 1
    model, opt, tstep = en4_trainer(torch, dev, config, state)
    batch = train_batch(torch, dev, hw, SEED + 62,
                        bins=config["model"]["num_bins"])
    box = {}
    ms_train = window_counts(torch, model, lambda: box.update(zip(
        ("loss", "k2", "k2b", "sites", "err", "terms", "twin32"),
        k2b_capture(torch, dev, P, tstep, batch, 11))))
    del model, opt, tstep
    torch.cuda.empty_cache()
    steps = sorted({shape[0] for shape, _ in box["sites"]})
    n_sites = sum(box["sites"].values())
    check(np.isfinite(box["loss"]), f"odd-M train step: loss {box['loss']}")
    check(box["k2"] == box["k2b"] == n_sites,
          f"odd-M train step: K2 {box['k2']}, K2b {box['k2b']} launches for "
          f"{n_sites} PSN sites")
    check(steps == [2, T], f"odd-M train step: PSN sites at T = {steps}")
    check(any(m % 2 for m in ms_train), f"odd-M train step: window counts "
          f"{ms_train}")
    check(captured_ok(box["err"], box["terms"]),
          f"odd-M train step: K2b vs its twin {box['err']}; over the sums "
          f"of |terms|: {box['terms']}")
    secs = time.perf_counter() - t0
    log(f"[11] en4 f32 train step at {hw[0]}x{hw[1]}, T={T}: loss "
        f"{box['loss']:.6g}; K2 {box['k2']} and K2b {box['k2b']} launches at "
        f"T = {steps} ({len(box['sites'])} site shapes); each K2b launch vs "
        f"the float64 twin, largest |d| / twin's largest: " + ", ".join(
            f"{k} {v:.3g}" for k, v in box["err"].items())
        + "; / the largest sum of |terms|: " + ", ".join(
            f"{k} {v:.3g}" for k, v in box["terms"].items())
        + f"; phase {secs:.1f} s")
    return dict(window_counts=ms, k1_launches=k1, k2_launches=k2,
                k1_flipped=flips["K1"][0], k2_flipped=flips["K2"][0],
                flow_equal_to_plain=same, train_loss=box["loss"],
                train_k2b_launches=box["k2b"], train_steps=steps,
                train_k2b_rel_err=box["err"],
                train_k2b_terms_rel_err=box["terms"], seconds=secs)


# ----------------------------------------------------------- phase 12
# the DSEC evaluation protocol: eval_dsec.main on a DSEC tree at 480x640

DSEC_VALID, DSEC_TRAIN = 4, 2
DSEC_TIMED = 32                # the timed runs: the valid split cycled
DSEC_SEQ = "zurich_city_01_a"
DSEC_T0_US = 49_000_000_000    # an absolute DSEC-like first timestamp
DSEC_T_STEP_US = 2500          # 36 steps: a 90 ms window
DSEC_ACTIVE = 0.45             # the share of the frame that sees events
# the GT of a valid window: the first pass's flow plus noise of magnitude
# U(0, 4) px where the window has events and U(0, 8) px where it has none
DSEC_NOISE_PX = (4.0, 8.0)
# the card's metric sums (float64, as evaluate computes them) against the
# float64 numpy recompute of the same inputs: summation order only. In
# float32 (printed for information) acos quantizes small angles: AAE moved
# by 1.4e-5 of itself on this tree
DSEC_EVAL_TOL = 1e-9
DSEC_METRICS = ("AEE", "PE1", "PE2", "PE3", "outlier", "AAE")


def active_pixels(torch, rng):
    """Flat indices of the ``DSEC_ACTIVE`` share of the frame where a smooth
    random field is highest: blobs, as edges give a real window's events a
    footprint of part of the frame."""
    import torch.nn.functional as F
    field = F.interpolate(torch.from_numpy(rng.normal(size=(1, 1, 15, 20))),
                          size=SENSOR, mode="bilinear",
                          align_corners=True)[0, 0].numpy().ravel()
    return np.flatnonzero(field >= np.quantile(field, 1 - DSEC_ACTIVE))


def dsec_window(rng, bins, active):
    """A window in DSEC's dtypes (uint16 x/y, int64 us t, uint8 p),
    time-sorted, 0.6-1.0 x 2^20 events at the pixels ``active`` (flat
    indices), whose grid is exact: integer x/y, t on a 2500 us grid with
    both ends present."""
    w = SENSOR[1]
    m = int(rng.uniform(0.6, 1.0) * K3_EVENTS)
    k = np.sort(rng.integers(0, 4 * (bins - 1) + 1, m))
    k[0], k[-1] = 0, 4 * (bins - 1)
    idx = rng.choice(active, m)
    return {"x": (idx % w).astype(np.uint16),
            "y": (idx // w).astype(np.uint16),
            "t": (DSEC_T0_US + DSEC_T_STEP_US * k).astype(np.int64),
            "p": rng.integers(0, 2, m).astype(np.uint8)}


def write_dsec_tree(torch, dev, root, bins):
    """The offline preprocessor's DSEC layout at 480x640: per window the
    raw events (``event_tensors/01lists/left``, a pickled dict), their
    plain-twin grid (``event_tensors/10bins/left/<seq>``), smooth random
    GT flow (|v| up to ~20 px; ``write_dsec_gt`` replaces it inside the
    crop of the valid windows) and a mask (~70% valid); 4 ``valid`` and 2
    ``train`` windows in the split lists. Returns the event counts and,
    per window, a [H, W] map of the pixels that see events."""
    import torch.nn.functional as F
    from sdformerflow_tpu_torch.ops.voxel import voxel_grid_signed
    rng = np.random.default_rng(SEED + 120)
    h, w = SENSOR
    dirs = {"gt": "gt_tensors", "mask": "mask_tensors",
            "lists": "sequence_lists", "ev": "event_tensors/01lists/left",
            "vox": f"event_tensors/{bins:02d}bins/left/{DSEC_SEQ}"}
    for d in dirs.values():
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"{DSEC_SEQ}_{i:06d}.npy" for i in range(DSEC_VALID
                                                      + DSEC_TRAIN)]
    n_events, seen = [], []
    for name in names:
        active = active_pixels(torch, rng)
        seen.append(np.zeros(h * w, bool))
        seen[-1][active] = True
        seen[-1] = seen[-1].reshape(h, w)
        ev = dsec_window(rng, bins, active)
        n_events.append(len(ev["x"]))
        np.save(os.path.join(root, dirs["ev"], name),
                np.array([ev], dtype=object))
        t = torch.from_numpy((ev["t"] - ev["t"][0]).astype(np.float32))
        grid = voxel_grid_signed(
            *(torch.from_numpy(ev[k].astype(np.float32)).to(dev)
              for k in "xy"), t.to(dev),
            torch.from_numpy(ev["p"].astype(np.float32)).to(dev),
            num_bins=bins, height=h, width=w,
            t_range=(0.0, float(t[-1])))
        np.save(os.path.join(root, dirs["vox"], name), grid.cpu().numpy())
        coarse = torch.from_numpy(rng.uniform(-14.0, 14.0, (1, 2, 7, 9)))
        flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=True)[0]
        np.save(os.path.join(root, dirs["gt"], name),
                flow.numpy().astype(np.float32))
        np.save(os.path.join(root, dirs["mask"], name),
                rng.random((h, w)) < 0.7)
    write_valid_split(root, names[:DSEC_VALID])
    with open(os.path.join(root, dirs["lists"], "train_split_seq.csv"),
              "w") as f:
        f.write("\n".join(names[DSEC_VALID:]) + "\n")
    return n_events, names[:DSEC_VALID], seen[:DSEC_VALID]


def write_valid_split(root, rows):
    with open(os.path.join(root, "sequence_lists", "valid_split_seq.csv"),
              "w") as f:
        f.write("\n".join(rows) + "\n")


def write_dsec_gt(root, names, preds, seen, crop):
    """The GT of the valid windows from a first pass, so that the metrics
    are not saturated as they are for random weights against random GT:
    inside the crop, the pass's flow plus noise in a random direction of
    magnitude U(0, 4) px where the window has events and U(0, 8) px where
    it has none (an event mask then moves the metrics), kept 1e-3 px away
    from the thresholds (1, 2, 3 px and 5% of the flow's magnitude) so
    that float32 and float64 put each pixel on the same side."""
    from sdformerflow_tpu_torch.data.augmentation import center_crop
    rng = np.random.default_rng(SEED + 122)
    for name, pred, ev in zip(names, preds, seen):
        path = os.path.join(root, "gt_tensors", name)
        gt = np.load(path)
        _, view, _ = center_crop(gt, gt, gt, crop)
        _, ev, _ = center_crop(ev, ev, ev, crop)
        flow = pred[0].cpu().double().numpy()
        mag = np.hypot(flow[0], flow[1])
        r = rng.uniform(0.0, 1.0, mag.shape) * np.where(
            ev, DSEC_NOISE_PX[0], DSEC_NOISE_PX[1])
        for thr in (1.0, 2.0, 3.0, 0.05 * mag):
            r = np.where(np.abs(r - thr) < 1e-3, r + 2e-3, r)
        a = rng.uniform(0.0, 2 * np.pi, mag.shape)
        view[...] = flow + r * np.stack([np.cos(a), np.sin(a)])
        np.save(path, gt)


@contextlib.contextmanager
def patched(module, name, make_wrapper):
    """``module.name`` replaced by ``make_wrapper(original)`` meanwhile."""
    original = getattr(module, name)
    setattr(module, name, make_wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def eval_run(torch, main, argv):
    """``main(argv)``, the ``main`` of ``eval_dsec`` or of ``eval_mvsec``
    (which runs ``eval_dsec.evaluate``), with its metric inputs recorded,
    its eval step kept and ``evaluate`` timed (host clock) from the end of
    its first batch, the warm-up, to its results; every kernel's launches
    counted from 0 over the run. Returns a dict."""
    import io
    from sdformerflow_tpu_torch import eval_dsec as E
    rec = {"inputs": [], "steps": []}

    def record_metrics(make):
        def make_fn(**kw):
            fn = make(**kw)
            rec["metric_kw"] = kw

            def run(pred, label, mask, chunk=None):
                rec["inputs"].append((pred, label, mask, chunk))
                out = fn(pred, label, mask, chunk)
                if len(rec["inputs"]) == 1:
                    torch.cuda.synchronize()
                    rec["warm"] = (time.perf_counter(), pred.shape[0])
                return out
            return run
        return make_fn

    def keep_step(make):
        def make_step(*args, **kw):
            step = make(*args, **kw)
            rec["steps"].append(step)
            return step
        return make_step

    def timed(evaluate):
        def run(*args, **kw):
            out = evaluate(*args, **kw)
            t_end, n0 = time.perf_counter(), rec["warm"][1]
            rec["windows_per_s"] = (out["num_samples"] - n0) / (
                t_end - rec["warm"][0])
            return out
        return run

    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    with patched(E, "make_metrics_fn", record_metrics), \
            patched(E, "make_eval_step", keep_step), \
            patched(E, "evaluate", timed), \
            contextlib.redirect_stdout(io.StringIO()):
        rec["results"] = main(argv)
    rec["main_s"] = time.perf_counter() - t0
    rec["launches"] = {k: w.launches for k, w in kernel_wrappers().items()}
    return rec


def launches_of(**counts):
    """Every kernel's expected launches: ``counts``, the others 0."""
    return {**dict.fromkeys(kernel_wrappers(), 0), **counts}


def recompute_numpy(rec):
    """The metrics of a run recomputed in float64 numpy from the flows,
    labels, masks and chunks its metrics function received, with the
    reference's formulas written out here: the footprint of the min-max
    encoded chunk (the polarity split, the nonzero minimum mapped to 0,
    a pixel kept where its sum over bins and polarities is not 0), AEE per
    sample, PE1-3 and outlier (EPE > 3 px and > 5% of the flow's
    magnitude) batch-global counts over each sample's valid count, AAE in
    degrees over the batch (cos clipped at 1 - 1e-7) times the batch size;
    the sums divided by the sample count. Returns (metrics, the share of
    the GT-valid pixels that the footprint keeps, or None)."""
    kw = rec["metric_kw"]
    check(not kw["mask_events"] or (
        kw["encoding"] == "voxel" and kw["polarity"]
        and kw["norm_input"] == "minmax" and kw["spike_th"] is None),
        f"the float64 recompute's footprint covers the en4 encoding, not "
        f"{kw}")
    sums, n, kept, valid = dict.fromkeys(kw["metric_names"], 0.0), 0, 0, 0
    sums.update(dict.fromkeys(("PE1", "PE2", "PE3", "outlier"), 0.0))
    for pred, label, mask, chunk in rec["inputs"]:
        f = pred.cpu().double().numpy() * kw["flow_scaling"]
        g = label.cpu().double().numpy()
        m = mask.cpu().double().numpy()[:, 0]
        if kw["mask_events"] and chunk is not None:
            c = chunk.cpu().double().numpy()
            x = np.stack([np.maximum(c, 0), np.maximum(-c, 0)], axis=2)
            nz = x != 0
            lo, hi = x[nz].min(), x[nz].max()
            enc = np.where(nz, (x - lo) / (hi - lo), 0.0)
            valid += m.sum()
            m = m * (enc.sum(axis=(1, 2)) != 0)
            kept += m.sum()
        err = np.sqrt(((f - g) ** 2).sum(axis=1)) * m
        mag = np.sqrt((f ** 2).sum(axis=1)) * m
        gmag = np.sqrt((g ** 2).sum(axis=1)) * m
        nv = m.sum(axis=(1, 2)) + 1e-9
        sums["AEE"] += float(np.sum(err.sum(axis=(1, 2)) / nv))
        for k, thr in (("PE1", 1.0), ("PE2", 2.0), ("PE3", 3.0)):
            sums[k] += float(np.sum((err > thr).sum() / nv))
        sums["outlier"] += float(np.sum(
            ((err > 3.0) & (err > 0.05 * mag)).sum() / nv))
        if "AAE" in sums:
            dot = f[:, 0] * g[:, 0] + f[:, 1] * g[:, 1]
            cos = np.clip((dot + 1e-7) / (mag * gmag + 1e-7), -1 + 1e-7,
                          1 - 1e-7)
            sums["AAE"] += float(np.degrees(
                (np.arccos(cos) * m).sum() / m.sum()) * f.shape[0])
        n += f.shape[0]
    return {k: v / n for k, v in sums.items()}, (kept / valid if valid
                                                 else None)


def float32_sums(rec):
    """The run's metric inputs through the port's metric code in float32 on
    the card (the reference's and JAX's precision), for information."""
    from sdformerflow_tpu_torch.training.evaluate import (MetricsAccumulator,
                                                          make_metrics_fn)
    fn, acc = make_metrics_fn(**rec["metric_kw"]), MetricsAccumulator()
    for parts in rec["inputs"]:
        acc.append(fn(*(None if p is None else p.float() for p in parts)),
                   parts[0].shape[0])
    return acc.results()


def eval_split(torch, dev, config, rec, make_dataset, n=8):
    """Where a batch's time goes: reading (``__getitem__`` + collate, host
    clock, median over the split's items), the host-to-device copy and the
    step with its metrics (CUDA events, back-to-back), and the card's busy
    time per batch (profiler)."""
    from sdformerflow_tpu_torch.data.augmentation import center_crop
    from sdformerflow_tpu_torch.data.dsec import _collate
    from sdformerflow_tpu_torch.training.evaluate import make_metrics_fn
    from sdformerflow_tpu_torch.training.train_loop import _to_device
    ds = make_dataset()
    read_ms = []
    for i in range(len(ds)):
        t0 = time.perf_counter()
        batch = _collate([ds[i]])
        read_ms.append((time.perf_counter() - t0) * 1e3)
    h2d_ms = cuda_time_ms(lambda: _to_device(batch, dev), iters=n)
    b = _to_device(batch, dev)
    crop = tuple(config["loader"]["crop"])
    step = rec["steps"][0]
    fn = make_metrics_fn(**rec["metric_kw"])
    if "events" in b:
        chunk = b["events"]
        _, label, mask = center_crop(b["label"], b["label"], b["mask"], crop)
    else:
        chunk, label, mask = center_crop(b["chunk"], b["label"], b["mask"],
                                         crop)
    metrics_chunk = None if "events" in b else chunk
    step_ms = cuda_time_ms(lambda: fn(step(chunk)[-1], label, mask,
                                      metrics_chunk), iters=n)
    busy = device_ms_per_call(torch, lambda: step(chunk), n)
    arrays = [v for k, v in batch.items() if k != "events"] + list(
        batch.get("events", {}).values())
    return dict(read_ms=float(np.median(read_ms)), h2d_ms=h2d_ms,
                step_ms=step_ms, device_ms=busy,
                h2d_mb=sum(a.nbytes for a in arrays) / 1e6)


def dsec_train(torch, argv, TL, P):
    """``train_dsec.main(argv)`` with each step's loss and K2 / K2b
    launches recorded; returns (steps, seconds, model, optimizer)."""
    from sdformerflow_tpu_torch import train_dsec
    steps = []

    def counted(make):
        def make_step(*args, **kw):
            step = make(*args, **kw)

            def run(batch):
                c0 = (P.fused_affine_psn.launches,
                      P.fused_psn_backward.launches)
                out = step(batch)
                steps.append((out["loss"].item(),
                              P.fused_affine_psn.launches - c0[0],
                              P.fused_psn_backward.launches - c0[1]))
                return out
            run.model = step.model
            return run
        return make_step

    t0 = time.perf_counter()
    with patched(TL, "make_train_step", counted):
        model, opt = train_dsec.main(argv)
    return steps, time.perf_counter() - t0, model, opt


def phase_dsec_eval(torch, dev, config, state_dict, card):
    """The port's DSEC evaluation entry (``eval_dsec.main``) on a DSEC tree
    at 480x640 with the seeded en4 weights as a reference-named ``.pt``:
    the voxel layout in bf16 with ``metrics.mask_events`` off and on, the
    event layout (K3 on the card), the submission PNGs, ``--ckpt`` and
    ``FlowServer(ckpt=...)`` on a trainer checkpoint, and the trainer on
    the tree in both layouts."""
    import shutil
    import yaml
    from sdformerflow_tpu_torch import eval_dsec
    from sdformerflow_tpu_torch.data.dsec import (DSECDatasetLite,
                                                  DSECEventListDataset)
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training import train_loop as TL
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        load_config,
                                                        merge_eval_config)
    from sdformerflow_tpu_torch.training.torch_interop import (
        to_reference_state_dict)
    from sdformerflow_tpu_torch.utils.visualization import read_flow_png
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                        "smoke_dsec")
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "dsec")
    bins = config["data"]["num_frames"]
    t0 = time.perf_counter()
    n_events, valid_names, seen = write_dsec_tree(torch, dev, tree, bins)
    tree_s = time.perf_counter() - t0
    # the seeded en4 weights under the reference's names, as a
    # DataParallel checkpoint with the keys the loader skips
    model = get_model(config["model"]["name"], *build_configs(config))
    model.load_state_dict(state_dict)
    ref = {"module." + k: v for k, v in
           to_reference_state_dict(model).items()}
    ref["module.sttmultires_unet.encoders.swin3d.patch_embed.head."
        "norm_layer.norm_layer.num_batches_tracked"] = torch.tensor(0)
    ref["module.sttmultires_unet.resblocks.0.sn1.spiking_neuron.v"] = \
        torch.zeros(1)
    pt = os.path.join(root, "reference_en4.pt")
    torch.save(ref, pt)
    del model, ref

    valid_cfg = VALID_CONFIG
    with open(valid_cfg) as f:
        eval_raw = yaml.safe_load(f)
    with open(CONFIG) as f:
        train_raw = yaml.safe_load(f)

    def write_yaml(name, raw, section, **kw):
        out = json.loads(json.dumps(raw))
        out.setdefault(section, {}).update(kw)
        path = os.path.join(root, name)
        with open(path, "w") as f:
            yaml.safe_dump(out, f)
        return path

    masked_cfg = write_yaml("valid_masked.yaml", eval_raw, "metrics",
                            mask_events=True)
    # data.events_input: an eval config's merge keeps it (its defaults
    # would reset data.preprocessed)
    events_train = write_yaml("train_events.yaml", train_raw, "data",
                              events_input="list")
    base = ["--eval_config", valid_cfg, "--torch_ckpt", pt, "--path", tree,
            "--bf16"]
    # a first pass gives the flows the valid windows' GT is made from
    first = eval_run(torch, eval_dsec.main, [
        "--train_config", CONFIG] + base + [
        "--run_dir", os.path.join(root, "eval_first")])
    write_dsec_gt(tree, valid_names, [p[0] for p in first["inputs"]], seen,
                  tuple(config["loader"]["crop"]))
    del first
    runs = {
        "voxel": eval_run(torch, eval_dsec.main, [
            "--train_config", CONFIG] + base + [
            "--run_dir", os.path.join(root, "eval_voxel"),
            "--store_submission"]),
        "voxel_masked": eval_run(torch, eval_dsec.main, [
            "--train_config", CONFIG, "--torch_ckpt", pt, "--path", tree,
            "--bf16", "--eval_config", masked_cfg,
            "--run_dir", os.path.join(root, "eval_voxel_masked")]),
        "events": eval_run(torch, eval_dsec.main, [
            "--train_config", events_train] + base + [
            "--run_dir", os.path.join(root, "eval_events")]),
    }
    for name, rec in runs.items():
        res = rec["results"]
        with open(os.path.join(root, f"eval_{name}", "results.json")) as f:
            check(json.load(f) == res, f"[12] {name}: results.json differs "
                  "from the returned results")
        check(set(DSEC_METRICS) <= set(res) and res["num_samples"]
              == DSEC_VALID and res["num_batches"] == DSEC_VALID
              and all(np.isfinite(res[k]) for k in DSEC_METRICS),
              f"[12] {name}: results {res}")
        want, rec["kept"] = recompute_numpy(rec)
        f32 = float32_sums(rec)
        rec["rel_err"], rec["f32_rel_err"] = (
            {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-300)
             for k in DSEC_METRICS} for got in (res, f32))
        check(all(e <= DSEC_EVAL_TOL for e in rec["rel_err"].values()),
              f"[12] {name}: metrics against the float64 recompute: "
              f"{rec['rel_err']}")
        n = DSEC_VALID
        want_l = launches_of(K1=12 * n, K2=45 * n,
                             K3=n if name == "events" else 0)
        check(rec["launches"] == want_l, f"[12] {name}: launches "
              f"{rec['launches']}, expected {want_l}")
        masked = [p[3] is not None for p in rec["inputs"]]
        check(all(masked) == (name != "events") and any(masked) == all(
            masked), f"[12] {name}: chunks given to the metrics {masked}")
    v, vm, e = (runs[k]["results"] for k in ("voxel", "voxel_masked",
                                             "events"))
    check(v != vm, "[12] mask_events on and off gave the same results")
    # the GT's noise: the metrics sit away from 0 and 1, and the event mask
    # drops the pixels without events, whose noise is twice as large
    check(1.0 < v["AEE"] < 5.0 and all(0.05 < v[k] < 0.95 for k in (
        "PE1", "PE2", "PE3", "outlier")), f"[12] voxel: metrics {v} are "
        "saturated")
    kept = runs["voxel_masked"]["kept"]
    check(0.2 < kept < 0.8 and vm["AEE"] < 0.8 * v["AEE"],
          f"[12] mask_events: the footprint keeps {kept} of the valid "
          f"pixels, AEE {vm['AEE']} against {v['AEE']} without it")
    check(e == v, f"[12] event layout {e} != voxel layout {v} on the "
          "plain twin's grids of the same windows")
    # the submission PNGs read back within 1/128 px of the flows
    sub_dir = os.path.join(root, "eval_voxel", "vis", "submission")
    subs = sorted(os.listdir(sub_dir))
    check(len(subs) == DSEC_VALID, f"[12] {len(subs)} submission PNGs")
    png_err = 0.0
    for name, (pred, *_rest) in zip(subs, runs["voxel"]["inputs"]):
        back, _ = read_flow_png(os.path.join(sub_dir, name))
        png_err = max(png_err, float(np.abs(back - pred[0].cpu().numpy())
                                     .max()))
    check(png_err < 1 / 128, f"[12] submission PNGs vs the flows: max|d| "
          f"{png_err}")
    for name, rec in runs.items():
        log(f"[12] eval_dsec {name} (bf16, {DSEC_VALID} windows, "
            f"batch 1): " + ", ".join(f"{k} {rec['results'][k]:.6g}"
                                      for k in DSEC_METRICS)
            + "; largest relative difference to the float64 numpy "
            f"recompute {max(rec['rel_err'].values()):.3g} (the same sums "
            "in float32, for information: " + ", ".join(
                f"{k} {v:.3g}" for k, v in rec["f32_rel_err"].items())
            + f"); launches "
            f"{rec['launches']}; main {rec['main_s']:.2f} s on {card}")
    log(f"[12] tree at {SENSOR[0]}x{SENSOR[1]} written in {tree_s:.2f} s "
        f"({min(n_events)}-{max(n_events)} events a window on "
        f"{DSEC_ACTIVE:.0%} of the frame); the event footprint keeps "
        f"{kept:.4f} of the GT-valid pixels; event layout == voxel layout; "
        f"submission PNGs within {png_err:.3g} px of the flows")

    # the timed runs: the valid split cycled to DSEC_TIMED windows, the
    # first batch left out as the warm-up
    write_valid_split(tree, [valid_names[i % DSEC_VALID]
                             for i in range(DSEC_TIMED)])
    timed = {}
    for name, train_cfg in (("voxel", CONFIG), ("events", events_train)):
        rec = eval_run(torch, eval_dsec.main, [
            "--train_config", train_cfg] + base + [
            "--run_dir", os.path.join(root, f"timed_{name}")])
        res, ref = rec["results"], runs[name]["results"]
        n = DSEC_TIMED
        want_l = launches_of(K1=12 * n, K2=45 * n,
                             K3=n if name == "events" else 0)
        check(res["num_samples"] == res["num_batches"] == n
              and rec["launches"] == want_l, f"[12] timed {name}: "
              f"{res}, launches {rec['launches']}, expected {want_l}")
        check(all(abs(res[k] - ref[k]) <= DSEC_EVAL_TOL * abs(ref[k])
                  for k in DSEC_METRICS), f"[12] timed {name}: {res} is "
              f"not the {DSEC_VALID}-window run's {ref}")
        timed[name] = rec["windows_per_s"]
        log(f"[12] eval_dsec {name} timed (bf16, batch 1, {n} windows: "
            f"the valid split cycled): {timed[name]:.2f} windows/s over the "
            f"{n - 1} after the first (host clock from the end of the "
            f"first batch to the results; the files were just written, so "
            f"reads hit the page cache) on {card}; results those of the "
            f"{DSEC_VALID}-window run")
        del rec

    # where a batch's time goes, each layout
    merged = merge_eval_config(load_config(CONFIG), load_config(valid_cfg))
    merged["data"]["path"] = tree
    merged_ev = json.loads(json.dumps(merged))
    merged_ev["data"]["events_input"] = "list"
    split = {
        "voxel": eval_split(torch, dev, merged, runs["voxel"],
                            lambda: DSECDatasetLite(merged, "valid")),
        "events": eval_split(torch, dev, merged_ev, runs["events"],
                             lambda: DSECEventListDataset(merged_ev,
                                                          "valid")),
    }
    for name, s in split.items():
        log(f"[12] {name} batch on {card}: read (np.load"
            + (" + pack_window" if name == "events" else "")
            + f" + collate) median over {DSEC_TIMED} reads "
            f"{s['read_ms']:.2f} ms; H2D "
            f"{s['h2d_mb']:.1f} MB {s['h2d_ms']:.3f} ms; step + metrics "
            f"{s['step_ms']:.2f} ms (CUDA events, back-to-back); device busy "
            + ("not measured: the profiler recorded no kernel"
               if s["device_ms"] is None else f"{s['device_ms']:.3f} ms")
            + " a batch (profiler)")
    write_valid_split(tree, valid_names)
    for rec in runs.values():
        rec["inputs"].clear()
        rec["steps"].clear()
    torch.cuda.empty_cache()

    # the trainer on the tree, both layouts: 2 float32 steps each
    train = {}
    for name, cfg_path in (("voxel", CONFIG), ("events", events_train)):
        run_dir = os.path.join(root, f"train_{name}")
        steps, wall, model, _ = dsec_train(torch, [
            "--config", cfg_path, "--path", tree, "--max_steps", "2",
            "--run_dir", run_dir], TL, P)
        del model
        torch.cuda.empty_cache()
        losses = [s[0] for s in steps]
        check(len(steps) == 2 and all(np.isfinite(losses)),
              f"[12] train {name}: steps {steps}")
        check(all(s[1] == s[2] > 0 for s in steps)
              and len({s[2] for s in steps}) == 1,
              f"[12] train {name}: K2 / K2b launches per step {steps}")
        if name == "voxel":
            check(steps[0][2] == 93, f"[12] train voxel: K2b launched "
                  f"{steps[0][2]} times a step, expected 93")
        train[name] = dict(losses=losses, k2b_per_step=steps[0][2],
                           seconds=wall)
        log(f"[12] train_dsec on the tree ({name} layout, f32, TF32 off, "
            f"2 steps, validation on {DSEC_VALID} windows): losses "
            f"{losses}, K2 and K2b {steps[0][2]} launches a step, "
            f"{wall:.1f} s")
    # a trainer checkpoint through --ckpt and FlowServer(ckpt=...)
    ckpt = os.path.join(root, "train_voxel", "ckpt")
    rec = eval_run(torch, eval_dsec.main, [
        "--train_config", CONFIG, "--eval_config", valid_cfg, "--ckpt", ckpt,
        "--path", tree, "--bf16", "--max_batches", "2", "--run_dir",
        os.path.join(root, "eval_ckpt")])
    res = rec["results"]
    check(res["num_batches"] == 2 and all(np.isfinite(res[k])
                                          for k in DSEC_METRICS),
          f"[12] eval_dsec --ckpt: {res}")
    with FlowServer(config, ckpt=ckpt, device=dev, bf16=True) as server:
        hw = tuple(config["loader"]["crop"])
        flow = server.infer(voxel_requests(1, bins, hw, SEED + 121)[0])
    check(flow.shape == (2,) + hw and np.isfinite(flow).all(),
          f"[12] FlowServer(ckpt=...): flow {flow.shape}")
    del rec
    shutil.rmtree(root, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[12] eval_dsec --ckpt (trainer checkpoint, 2 batches): AEE "
        f"{res['AEE']:.6g}; FlowServer(ckpt=...) flow {list(flow.shape)} "
        f"finite; phase {secs:.1f} s")
    return dict(
        metrics={k: {m: r["results"][m] for m in DSEC_METRICS}
                 for k, r in runs.items()},
        rel_err_vs_f64={k: max(r["rel_err"].values())
                        for k, r in runs.items()},
        float32_rel_err_vs_f64={k: r["f32_rel_err"] for k, r in runs.items()},
        launches={k: r["launches"] for k, r in runs.items()},
        windows_per_s=timed, timed_windows=DSEC_TIMED, footprint_kept=kept,
        main_s={k: r["main_s"] for k, r in runs.items()},
        split=split, png_max_err=png_err, train=train,
        events_per_window=n_events, seconds=secs)


# ----------------------------------------------------------- phase 13
# the ANN family: STTFlowNet (the DSEC STT config at full width), its
# 4-encoder variant at the MDR geometry, and the plain conv MultiResUNet

STT_CONFIG = os.path.join(ROOT, "configs", "train_dsec_stt_voxel.yaml")
STT_MDR_CONFIG = os.path.join(ROOT, "configs", "train_mdr_stt_voxel.yaml")
ANN_TRAIN_STEPS = 14       # 2 warm-up + 12 timed, as phase 9
# the float32 forward on the card against the float64 forward of the same
# weights and input: the largest |d| over the largest |flow| of the float64
# forward (the ANN is not chaotic: no threshold flips)
ANN_F32_TOL = 1e-4
# the bf16 server against the float32 forward of the same weights: the
# mean end-point error over the mean |flow| of the float32 forward
ANN_BF16_EPE = 0.05
# remat against the plain step, the same drop-path generator seed: in
# float32, each gradient's largest |d| over the largest |gradient| of the
# step; in float64, each leaf's largest |d| over that leaf's own largest
# |gradient| (on the H100, float32 moved a leaf whose gradient cancels by
# 3.55e-5 of itself, cuDNN held to its deterministic algorithms; float64's
# rounding is 2^29 times finer, a fault of the recompute is not)
ANN_REMAT_TOL = 1e-5
ANN_REMAT_F64_TOL = 1e-9


def kernel_wrappers():
    """Every kernel wrapper (its ``launches`` is the count), by name."""
    from sdformerflow_tpu_torch.ops import (hopper_attn, hopper_embed,
                                            hopper_psn, hopper_voxel)
    return {"K1": hopper_attn.qk_attn_interior,
            "K2": hopper_psn.fused_affine_psn,
            "K2b": hopper_psn.fused_psn_backward,
            "K2c": hopper_psn.psn_spike_tm,
            "K3": hopper_voxel.voxel_k3,
            "K4": hopper_embed.conv3x3_affine_cs,
            "K4a": hopper_embed.psn_spike_cs}


def ann_model(torch, dev, path, seed, train=False):
    """(config, model on ``dev``) of an ANN config, seeded random weights."""
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        chunk_bins,
                                                        load_config)
    config = load_config(path)
    model = get_model(config["model"]["name"], *build_configs(config),
                      train=train, input_bins=chunk_bins(config))
    randomize_(model, torch.Generator().manual_seed(seed))
    return config, model.to(dev)


def f64_rel_err(torch, model, x):
    """(float32 flows, largest |f32 - f64| over the largest |f64 flow|):
    ``model`` (float32, eval) and a float64 copy on the same input."""
    import copy
    with torch.no_grad():
        f32 = model(x)["flow"]
        f64 = copy.deepcopy(model).double()(x.double())["flow"]
    top = max(float(b.abs().max()) for b in f64)
    err = max(float((a.double() - b).abs().max()) for a, b in zip(f32, f64))
    return f32, err / top


def leaf_errors(grads, want):
    """Each leaf's largest |d| of ``grads`` against ``want`` over that
    leaf's largest |gradient| in ``want`` (a leaf whose gradient is 0 must
    stay exactly 0): (the worst ratio, its leaf)."""
    worst = (-1.0, None)
    for n, g in want.items():
        d = float((grads[n] - g).abs().max())
        top = float(g.abs().max())
        r = d / top if top > 0 else (0.0 if d == 0 else float("inf"))
        worst = max(worst, (r, n), key=lambda e: e[0])
    return worst


def epe_share(a, b):
    """Mean end-point error of flows ``a`` against ``b`` ([..., 2, H, W])
    over the mean |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).sum(-3)).mean()
                 / np.sqrt((b ** 2).sum(-3)).mean())


def ann_step(torch, dev, config, model, gen_seed, **kw):
    """(optimizer, the config's train step on ``model``) with drop-path
    drawn from a generator seeded ``gen_seed``."""
    from sdformerflow_tpu_torch.training.optim import build_optimizer
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    oc = config["optimizer"]
    opt = build_optimizer(model.named_parameters(), lr=oc["lr"],
                          weight_decay=oc["wd"], milestones=oc["milestones"],
                          clip_grad=config["loss"]["clip_grad"])
    step = make_train_step(
        model, opt, polarity=False, norm_input=config["model"]["norm_input"],
        generator=torch.Generator(dev).manual_seed(gen_seed), **kw)
    return opt, step


def ann_trainer(torch, root, name, raw, **changes):
    """``train_dsec.main --synthetic`` on the STT config with ``changes``
    (section -> keys): (step ms, losses, peak GiB, model, optimizer)."""
    import shutil
    import yaml
    from sdformerflow_tpu_torch import train_dsec
    from sdformerflow_tpu_torch.training import train_loop as TL
    cfg = json.loads(json.dumps(raw))
    for section, kw in changes.items():
        cfg.setdefault(section, {}).update(kw)
    path = os.path.join(root, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    run_dir = os.path.join(root, f"run_{name}")
    shutil.rmtree(run_dir, ignore_errors=True)
    records = []

    def timed(make):
        def make_step(*args, **kw):
            step = make(*args, **kw)

            def run(batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(batch)
                torch.cuda.synchronize()
                records.append(((time.perf_counter() - t0) * 1e3,
                                out["loss"].item()))
                return out
            run.model = step.model
            return run
        return make_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with patched(TL, "make_train_step", timed):
        model, opt = train_dsec.main(["--config", path, "--synthetic",
                                      "--max_steps", str(ANN_TRAIN_STEPS),
                                      "--run_dir", run_dir])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, losses = [r[0] for r in records], [r[1] for r in records]
    check(len(records) == ANN_TRAIN_STEPS and all(np.isfinite(losses))
          and int(opt.count) == ANN_TRAIN_STEPS
          and int(opt.notfinite_count) == 0,
          f"[13] trainer {name}: {len(records)} steps, losses {losses}, "
          f"{int(opt.count)} updates")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        names = {json.loads(line)["name"] for line in f}
    check({"train_loss", "valid_loss"} <= names,
          f"[13] trainer {name}: metrics.jsonl {names}")
    shutil.rmtree(run_dir, ignore_errors=True)
    return ms, losses, peak, model, opt


def write_doubleseq(tree, rows):
    with open(os.path.join(tree, "sequence_lists",
                           "valid_split_doubleseq.csv"), "w") as f:
        f.write("\n".join(f"{a},{b}" for a, b in rows) + "\n")


def stt_eval(torch, dev, root, raw, state_dict):
    """``eval_dsec.main`` with the STT config (two 10-bin chunks a window)
    on a 480x640 DSEC tree written by phase 12's writer with a doubleseq
    split, from a reference-named ``.pt``, bf16; the metrics against the
    float64 recompute; a first pass makes the valid GT; timed as phase 12
    times the en4's, over the split cycled to ``DSEC_TIMED`` windows."""
    import shutil
    import yaml
    from sdformerflow_tpu_torch import eval_dsec
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        chunk_bins,
                                                        load_config)
    from sdformerflow_tpu_torch.training.torch_interop import (
        to_reference_state_dict)
    tree = os.path.join(root, "dsec")
    shutil.rmtree(tree, ignore_errors=True)
    bins = raw["data"]["num_frames"]
    n_events, valid, seen = write_dsec_tree(torch, dev, tree, bins)
    names = sorted(os.listdir(os.path.join(tree, "gt_tensors")))
    # the first chunk of each row is the window before it (a train window
    # before the first): the GT is each valid window's
    rows = [(names[-1], valid[0])] + list(zip(valid[:-1], valid[1:]))
    write_doubleseq(tree, rows)
    cfg = json.loads(json.dumps(raw))
    cfg["metrics"]["name"] = ["AEE", "AAE"]
    cfg["loader"]["batch_size"] = 1     # windows/s after the first batch
    path = os.path.join(root, "stt_eval.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    config = load_config(path)
    model = get_model(config["model"]["name"], *build_configs(config),
                      input_bins=chunk_bins(config))
    model.load_state_dict(state_dict)
    pt = os.path.join(root, "reference_stt.pt")
    torch.save({"module." + k: v for k, v in
                to_reference_state_dict(model).items()}, pt)
    del model
    argv = ["--train_config", path, "--torch_ckpt", pt, "--path", tree,
            "--bf16"]
    first = eval_run(torch, eval_dsec.main, argv + [
        "--run_dir", os.path.join(root, "eval_first")])
    preds = [p[0][i:i + 1] for p in first["inputs"]
             for i in range(p[0].shape[0])]
    write_dsec_gt(tree, valid, preds, seen, tuple(config["loader"]["crop"]))
    rec = eval_run(torch, eval_dsec.main, argv + [
        "--run_dir", os.path.join(root, "eval_voxel")])
    res = rec["results"]
    check(set(DSEC_METRICS) <= set(res) and res["num_samples"] == DSEC_VALID
          and all(np.isfinite(res[k]) for k in DSEC_METRICS),
          f"[13] STT eval_dsec: results {res}")
    want, _ = recompute_numpy(rec)
    rel = {k: abs(res[k] - want[k]) / max(abs(want[k]), 1e-300)
           for k in DSEC_METRICS}
    check(all(e <= DSEC_EVAL_TOL for e in rel.values()),
          f"[13] STT eval_dsec against the float64 recompute: {rel}")
    check(all(v == 0 for v in rec["launches"].values()),
          f"[13] STT eval_dsec launched kernels: {rec['launches']}")
    # the timed run: the doubleseq split cycled to DSEC_TIMED windows, the
    # first batch left out as the warm-up
    write_doubleseq(tree, [rows[i % DSEC_VALID] for i in range(DSEC_TIMED)])
    timed = eval_run(torch, eval_dsec.main, argv + [
        "--run_dir", os.path.join(root, "eval_timed")])
    t_res = timed["results"]
    check(t_res["num_samples"] == t_res["num_batches"] == DSEC_TIMED
          and all(abs(t_res[k] - res[k]) <= DSEC_EVAL_TOL * abs(res[k])
                  for k in DSEC_METRICS)
          and not any(timed["launches"].values()),
          f"[13] STT eval_dsec timed: {t_res} (the {DSEC_VALID}-window run "
          f"{res}), launches {timed['launches']}")
    shutil.rmtree(tree, ignore_errors=True)
    return dict(metrics={k: res[k] for k in DSEC_METRICS},
                rel_err_vs_f64=max(rel.values()),
                windows_per_s=timed["windows_per_s"],
                timed_windows=DSEC_TIMED, main_s=timed["main_s"],
                events_per_window=n_events)


def phase_ann(torch, dev, card):
    """STTFlowNet at the DSEC STT config's full width: the f32 forward
    against float64, FlowServer in bf16 (latency, throughput, busy, the
    bf16 EPE), the trainer at batch 8 and 1 with and without remat, remat's
    gradients against the plain step's, eval_dsec on a doubleseq tree;
    STTFlowNet_4en at the MDR geometry (a bf16 forward, an f32 train
    step); MultiResUNet's f32 forward against float64. No kernel of the
    port lies on these paths: every launch count, set to 0 at the start,
    must still be 0 at the end."""
    import copy
    import shutil
    import yaml
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    t_phase = time.perf_counter()
    for wrapper in kernel_wrappers().values():     # counted from 0
        wrapper.launches = 0
    root = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build", "smoke_ann")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}

    # --- STTFlowNet, 20 bins at 288x384: f32 against float64
    config, model = ann_model(torch, dev, STT_CONFIG, SEED + 130)
    hw, bins = tuple(config["loader"]["crop"]), config["model"]["num_bins"]
    state_dict = {k: v.cpu() for k, v in model.state_dict().items()}
    x = torch.from_numpy(np.stack(voxel_requests(1, bins, hw,
                                                 SEED + 131))).to(dev)
    f32, err = f64_rel_err(torch, model, x)
    check(len(f32) == 3 and all(f.shape == (1, 2) + hw for f in f32)
          and err <= ANN_F32_TOL,
          f"[13] STTFlowNet f32 vs float64: {err:.3g} of the largest flow "
          f"(bound {ANN_F32_TOL})")
    out["stt_f32_vs_f64"] = err
    log(f"[13] STTFlowNet (base 96, depths (2,2,6), swin-v2, PatchEmbedLocal"
        f", patch (10,4,4), window (2,9,9)) at {hw[0]}x{hw[1]}, {bins} bins: "
        f"f32 (TF32 off) vs float64 forward on the card, largest |d| "
        f"{err:.3g} of the largest |flow| "
        f"({max(float(f.abs().max()) for f in f32):.4g}); bound {ANN_F32_TOL}")

    # --- FlowServer in bf16: voxel requests of 20 bins
    requests = voxel_requests(N_LATENCY + N_QUEUED, bins, hw, SEED + 132)
    eval32 = make_eval_step(model, polarity=False,
                            norm_input=config["model"]["norm_input"])
    with torch.no_grad():
        want = [eval32(torch.from_numpy(r)[None].to(dev))[-1][0].cpu()
                .numpy() for r in requests[:4]]
    with FlowServer(config, state_dict, device=dev, bf16=True) as server:
        server.warmup()
        latencies, flows = [], []
        for r in requests[:N_LATENCY]:
            t0 = time.perf_counter()
            flows.append(server.infer(r))
            latencies.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in requests[N_LATENCY:]]
        flows += [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        dev_ms = device_ms_per_call(torch,
                                    lambda: server.infer(requests[0]), 8)
        try:
            server.infer({k: np.zeros(4096, np.float32) for k in "xytp"})
            refused = False
        except ValueError:
            refused = True
    check(all(f.shape == (2,) + hw and np.isfinite(f).all() for f in flows),
          "[13] STT server: flow shapes / finiteness")
    check(refused, "[13] STT server: an events request (10 bins) was not "
          "refused")
    bf16_epe = max(epe_share(f, w) for f, w in zip(flows[:4], want))
    check(bf16_epe <= ANN_BF16_EPE, f"[13] STT bf16 vs f32: EPE "
          f"{bf16_epe:.3g} of the mean |flow| (bound {ANN_BF16_EPE})")
    p50, p90 = (float(v) for v in np.percentile(latencies, [50, 90]))
    out["serving"] = dict(p50_ms=p50, p90_ms=p90,
                          windows_per_s=N_QUEUED / wall,
                          device_ms_per_request=dev_ms,
                          bf16_epe_share=bf16_epe)
    log(f"[13] STT FlowServer bf16 on {card}: {N_LATENCY} requests one at a "
        f"time p50 {p50:.2f} ms, p90 {p90:.2f}; {N_QUEUED} queued "
        f"{N_QUEUED / wall:.2f} windows/s; device busy per request "
        + ("not measured" if dev_ms is None else f"{dev_ms:.3f} ms")
        + f"; bf16 vs f32 mean EPE {bf16_epe:.3g} of the mean |flow| "
        f"(bound {ANN_BF16_EPE}); an events request refused (ValueError)")
    del eval32, flows, requests

    # --- remat: the same gradients as the plain step, batch 1
    from sdformerflow_tpu_torch.training.remat import Remat
    batch = train_batch(torch, dev, hw, SEED + 133, bins=bins)
    grads, memory = {}, {}
    for remat in (None, "dots", "all"):
        m = copy.deepcopy(model).train()
        # what the forward keeps for the backward (memory held after it)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        with (contextlib.nullcontext() if remat is None else Remat(
                m, remat, torch.Generator(dev).manual_seed(SEED))):
            flows = m(batch["chunk"])["flow"]
        torch.cuda.synchronize()
        kept = (torch.cuda.memory_allocated() - base) / 2 ** 30
        del flows
        _, step = ann_step(torch, dev, config, m, SEED + 134, remat=remat)
        torch.cuda.reset_peak_memory_stats()
        if remat is None:     # the step's largest allocation, and its caller
            torch.cuda.memory._record_memory_history(max_entries=100000,
                                                     stacks="all")
        step(batch)
        torch.cuda.synchronize()
        memory[str(remat)] = dict(
            forward_kept_gib=kept, model_gib=base / 2 ** 30,
            step_peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if remat is None:
            trace = torch.cuda.memory._snapshot()["device_traces"][0]
            torch.cuda.memory._record_memory_history(enabled=None)
            big = max((e for e in trace if e["action"] == "alloc"),
                      key=lambda e: e["size"])
            memory["largest_alloc"] = dict(gib=big["size"] / 2 ** 30, by=next(
                (f["name"].split("(")[0] for f in big.get("frames", [])
                 if "cudnn_convolution" in f["name"]), "not a cuDNN call"))
        grads[remat] = {n: p.grad.detach().clone()
                        for n, p in m.named_parameters()}
        del m, step
    out["memory_b1"] = memory
    big = memory["largest_alloc"]
    log(f"[13] batch-1 memory (GiB): the model {memory['None']['model_gib']:.3f}; "
        + "; ".join(f"remat {k}: the forward keeps {v['forward_kept_gib']:.3f},"
                    f" step peak {v['step_peak_gib']:.3f}"
                    for k, v in memory.items() if k != "largest_alloc")
        + f"; the plain step's largest allocation {big['gib']:.3f} GiB by "
        f"{big['by']}")
    # the gradients: float32 against the step's largest, then the same
    # steps in float64, each leaf against its own largest
    top = max(float(g.abs().max()) for g in grads[None].values())
    remat_err = max(float((grads[r][n] - g).abs().max())
                    for n, g in grads[None].items()
                    for r in ("dots", "all")) / top
    check(remat_err <= ANN_REMAT_TOL, f"[13] remat vs plain gradients, f32: "
          f"{remat_err:.3g} of the largest (bound {ANN_REMAT_TOL})")
    f32_leaf = max((leaf_errors(grads[r], grads[None])
                    for r in ("dots", "all")), key=lambda e: e[0])
    f64 = {}
    for remat in (None, "dots", "all"):
        m = copy.deepcopy(model).double().train()
        _, step = ann_step(torch, dev, config, m, SEED + 134, remat=remat)
        step(batch)
        f64[remat] = {n: p.grad.detach().clone()
                      for n, p in m.named_parameters()}
        del m, step
    f64_leaf = max((leaf_errors(f64[r], f64[None]) for r in ("dots", "all")),
                   key=lambda e: e[0])
    check(f64_leaf[0] <= ANN_REMAT_F64_TOL, f"[13] remat vs plain gradients, "
          f"float64: {f64_leaf[0]:.3g} of the leaf's own largest at "
          f"{f64_leaf[1]} (bound {ANN_REMAT_F64_TOL})")
    out["remat_grad_err"] = dict(
        f32_of_largest=remat_err, f32_worst_leaf=f32_leaf[0],
        f32_leaf=f32_leaf[1], f64_worst_leaf=f64_leaf[0],
        f64_leaf=f64_leaf[1])
    log(f"[13] remat dots and all vs the plain step, batch 1, drop-path from "
        f"one seed: f32, largest |d| {remat_err:.3g} of the largest gradient "
        f"{top:.4g} (bound {ANN_REMAT_TOL}), the worst of {len(f64[None])} "
        f"leaves {f32_leaf[0]:.3g} of its own largest ({f32_leaf[1]}); "
        f"float64, the worst leaf {f64_leaf[0]:.3g} of its own largest "
        f"({f64_leaf[1]}; bound {ANN_REMAT_F64_TOL})")
    del grads, f64, batch, model
    torch.cuda.empty_cache()

    # --- the trainer at the config's batch 8, with and without remat
    with open(STT_CONFIG) as f:
        raw = yaml.safe_load(f)
    train = {}
    for name, batch_size, remat in (("b8", 8, None), ("b8_remat", 8, "dots"),
                                    ("b1_remat", 1, "dots"), ("b1", 1, None)):
        ms, losses, peak, model, opt = ann_trainer(
            torch, root, name, raw,
            loader={"batch_size": batch_size, "n_workers": 4},
            optimizer={"remat": remat})
        p50, p90 = (float(v) for v in np.percentile(ms[2:], [50, 90]))
        dev_step = None
        if name == "b8":
            b = train_batch(torch, dev, hw, SEED + 135, batch=batch_size,
                            bins=bins)
            _, step = ann_step(torch, dev, config, model, SEED + 136)
            step(b)
            dev_step = device_ms_per_call(torch, lambda: step(b), 3)
            del step, b
        train[name] = dict(p50_ms=p50, p90_ms=p90, peak_mem_gib=peak,
                           device_ms_per_step=dev_step,
                           losses=[losses[0], losses[-1]])
        log(f"[13] trainer STT {name} (f32, TF32 off, batch {batch_size}, "
            f"remat {remat}) on {card}: step p50 {p50:.2f} ms, p90 "
            f"{p90:.2f} (after 2 warm-up); peak memory {peak:.2f} GiB"
            + ("" if dev_step is None else
               f"; device busy per step {dev_step:.2f} ms")
            + f"; losses {losses[0]:.4g} -> {losses[-1]:.4g}")
        del model, opt
        torch.cuda.empty_cache()
    out["train"] = train

    # --- eval_dsec on a doubleseq tree
    out["eval"] = stt_eval(torch, dev, root, raw, state_dict)
    log(f"[13] STT eval_dsec (doubleseq, 480x640 tree, bf16, a reference-"
        f"named .pt): {out['eval']['metrics']}, within "
        f"{out['eval']['rel_err_vs_f64']:.3g} of the float64 recompute; "
        f"{out['eval']['windows_per_s']:.2f} windows/s over the "
        f"{DSEC_TIMED - 1} after the first (batch 1, the split cycled to "
        f"{DSEC_TIMED} windows; host clock) on {card}; results those of the "
        f"{DSEC_VALID}-window run")

    # --- STTFlowNet_4en at the MDR geometry: bf16 forward, f32 train step
    config, model = ann_model(torch, dev, STT_MDR_CONFIG, SEED + 137)
    hw4, bins4 = tuple(config["loader"]["crop"]), config["model"]["num_bins"]
    x = torch.from_numpy(np.stack(voxel_requests(1, bins4, hw4,
                                                 SEED + 138))).to(dev)
    kw = dict(polarity=False, norm_input=config["model"]["norm_input"])
    with torch.no_grad():
        f32 = make_eval_step(model, **kw)(x)
        bf16 = make_eval_step(model, **kw, compute_dtype=torch.bfloat16)(x)
    check(len(bf16) == 4 and all(f.shape == (1, 2) + hw4
                                 and bool(torch.isfinite(f).all())
                                 for f in bf16), "[13] STT_4en bf16 flows")
    epe4 = epe_share(bf16[-1].cpu(), f32[-1].cpu())
    check(epe4 <= ANN_BF16_EPE, f"[13] STT_4en bf16 vs f32 EPE {epe4:.3g}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, step = ann_step(torch, dev, config, model, SEED + 139)
    loss = float(step(train_batch(torch, dev, hw4, SEED + 140,
                                  bins=bins4))["loss"])
    moved = sum(not torch.equal(before[k], v)
                for k, v in model.state_dict().items())
    check(np.isfinite(loss) and moved > 0.9 * len(before),
          f"[13] STT_4en train step: loss {loss}, {moved} of {len(before)} "
          "entries moved")
    out["stt_4en"] = dict(bf16_epe_share=epe4, train_loss=loss)
    log(f"[13] STTFlowNet_4en (depths (2,2,6,2), window (2,8,8), patch "
        f"(5,4,4)) at {hw4[0]}x{hw4[1]}, {bins4} bins: bf16 forward, 4 flows "
        f"finite, EPE {epe4:.3g} of the mean |flow| against f32; f32 train "
        f"step loss {loss:.4g}, {moved} of {len(before)} entries moved")
    del model, step, before

    # --- MultiResUNet: f32 against float64
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs
    unet = get_model("MultiResUNet", {"num_bins": 10, "base_num_channels": 32,
                                      "num_encoders": 4, "kernel_size": 5},
                     *build_configs(config)[1:])
    randomize_(unet, torch.Generator().manual_seed(SEED + 141))
    x = torch.from_numpy(np.stack(voxel_requests(1, 10, hw, SEED + 142)))
    f32, err = f64_rel_err(torch, unet.to(dev), x.to(dev))
    check(len(f32) == 4 and err <= ANN_F32_TOL,
          f"[13] MultiResUNet f32 vs float64: {err:.3g}")
    out["unet_f32_vs_f64"] = err
    log(f"[13] MultiResUNet (base 32, 4 encoders, kernel 5) at {hw[0]}x"
        f"{hw[1]}: f32 vs float64 largest |d| {err:.3g} of the largest "
        f"|flow|")
    del unet
    launched = {k: w.launches for k, w in kernel_wrappers().items()}
    check(not any(launched.values()),
          f"[13] the ANN paths launched kernels: {launched}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["kernel_launches"] = launched
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[13] no kernel of the port launched on the ANN paths ({launched}); "
        f"phase {out['seconds']:.1f} s")
    return out


# ----------------------------------------------------------- phase 14
# the MDR / MVSEC slice: train_mdr and eval_mvsec on trees written here

MDR_CONFIG = os.path.join(ROOT, "configs", "train_mdr_sdformerflow.yaml")
MVSEC_EVAL_CONFIG = os.path.join(ROOT, "configs", "eval_mvsec.yaml")
MDR_SENSOR = (260, 346)        # MDR's and MVSEC's DAVIS346 frame
MDR_SCENES = 8                 # two batches of 4 an epoch
MDR_EVENTS = 2 ** 15           # events of every .npz and .h5 file
MDR_WINDOW_NS = 30_000_000     # the span of an MDR event file
MVSEC_FRAME_S = 0.032          # the span of an MVSEC event file
# in-training validation on outdoor_day1 (dt1): test.sample 4 at batch 4,
# 2 batches; the batcher reads the batch after the last it yields
MDR_VALID_SAMPLE = 4
MDR_TIMED_STEPS = 8            # timed on one batch after the run
# eval_mvsec --max_batches (batch 1): 31 timed after the first, as the
# timed runs of phase 12
MVSEC_EVAL = 32
# samples the trees hold GT and event files for: the validation's and the
# eval's reads, one batch past the last
MVSEC_GT = {"outdoor_day1": (MDR_VALID_SAMPLE // 4 + 2) * 4,
            "indoor_flying1": MVSEC_EVAL + 1}
MVSEC_EVAL_TOL = 1e-9          # as phase 12: summation order only


def write_mdr_tree(root, rng):
    """MDR's ``dt1/train`` layout at 260x346: per scene the events of both
    windows and their best-density variants (``.npz``, ns timestamps over
    30 ms, x/y uniform over the frame, polarity 0/1) and a ``.flo`` GT (a
    per-scene motion of up to 6 px plus N(0, 0.5) px)."""
    h, w = MDR_SENSOR
    base = os.path.join(root, "dt1", "train")
    for i in range(MDR_SCENES):
        scene = f"scene_{i:03d}"
        paths = [os.path.join(base, sub, scene, f"{scene}_{sub}.npz")
                 for sub in ("events1", "events2")]
        paths += [os.path.join(base, sub, f"{scene}_{sub}.npz")
                  for sub in ("best_density_events1", "best_density_events2")]
        for path in paths:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            t0 = rng.uniform(0, 1e12)
            np.savez(path, t=t0 + np.sort(rng.uniform(0, MDR_WINDOW_NS,
                                                      MDR_EVENTS)),
                     x=rng.integers(0, w, MDR_EVENTS).astype(np.float64),
                     y=rng.integers(0, h, MDR_EVENTS).astype(np.float64),
                     p=rng.integers(0, 2, MDR_EVENTS).astype(np.float64))
        flow = (rng.uniform(-6, 6, (1, 1, 2))
                + rng.normal(0, 0.5, (h, w, 2))).astype(np.float32)
        os.makedirs(os.path.join(base, "flow"), exist_ok=True)
        with open(os.path.join(base, "flow", f"{scene}_flow.flo"), "wb") as f:
            np.asarray([202021.25], np.float32).tofile(f)
            np.asarray([w, h], np.int32).tofile(f)
            flow.tofile(f)


def write_mvsec_sequence(root, seq, n, rng):
    """MVSEC's layout at 260x346 for ``n`` dt4 samples: ``n + 7`` event
    files (``event/NNNNNN.h5``, the port's writer: 2^15 events over 32 ms,
    ts in seconds) and ``n`` GT frames a interval (``flowgt_dt1|dt4/N.npy``,
    [2, H, W]: a smooth field of up to 8 px, 0.1% of the pixels at 2000 px,
    outside the |flow| < 1000 mask). Every .h5 is read back and compared
    bit for bit. Returns the bytes written."""
    from sdformerflow_tpu_torch.data.loader_utils import (get_events_h5,
                                                          write_events_h5)
    from sdformerflow_tpu_torch.data.mvsec import VALID_TIME_INDEX
    first = VALID_TIME_INDEX[seq][0][0]
    h, w = MDR_SENSOR
    os.makedirs(os.path.join(root, seq, "event"))
    nbytes = 0
    for k in range(n + 7):
        t = k * MVSEC_FRAME_S + np.sort(rng.uniform(0, MVSEC_FRAME_S,
                                                    MDR_EVENTS))
        ev = np.stack([t, rng.integers(0, w, MDR_EVENTS).astype(np.float64),
                       rng.integers(0, h, MDR_EVENTS).astype(np.float64),
                       rng.integers(0, 2, MDR_EVENTS).astype(np.float64)], 1)
        path = os.path.join(root, seq, "event", f"{first + 1 + k:06d}.h5")
        write_events_h5(path, ev)
        check(get_events_h5(path).tobytes() == ev.tobytes(),
              f"[14] {path}: the .h5 reads back other values")
        nbytes += os.path.getsize(path)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    for dt in ("dt1", "dt4"):
        os.makedirs(os.path.join(root, seq, f"flowgt_{dt}"))
        for k in range(n):
            a = rng.uniform(-8, 8, 4)
            flow = np.stack([a[0] * xx + a[1] * yy, a[2] * xx - a[3] * yy])
            flow.reshape(2, -1)[:, rng.random(h * w) < 1e-3] = 2000.0
            np.save(os.path.join(root, seq, f"flowgt_{dt}",
                                 f"{first + k}.npy"), flow.astype(np.float32))
    return nbytes


def mdr_train(torch, argv, TL, P):
    """``train_mdr.main(argv)`` with each step's host ms (synced), loss and
    K2 / K2b launches recorded, the loop's train step, last batch and
    optimizer kept, its eval step and the first chunk the validation gave
    it, the peak memory, and every kernel's launches over the run from
    0."""
    from sdformerflow_tpu_torch import train_mdr
    rec = {"steps": []}

    def keep_eval(make):
        def make_step(*args, **kw):
            step = make(*args, **kw)
            rec["eval_step"] = step

            def run(chunk):
                rec.setdefault("valid_chunk", chunk)
                return step(chunk)
            return run
        return make_step

    def counted(make):
        def make_step(*args, **kw):
            step = make(*args, **kw)
            rec["step"] = step

            def run(batch):
                rec["batch"] = batch
                c0 = (P.fused_affine_psn.launches,
                      P.fused_psn_backward.launches)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(batch)
                loss = out["loss"].item()
                rec["steps"].append(((time.perf_counter() - t0) * 1e3, loss,
                                     P.fused_affine_psn.launches - c0[0],
                                     P.fused_psn_backward.launches - c0[1]))
                return out
            run.model = step.model
            return run
        return make_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    with patched(TL, "make_train_step", counted), \
            patched(TL, "make_eval_step", keep_eval):
        rec["opt"] = train_mdr.main(argv)[1]
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {k: w.launches for k, w in kernel_wrappers().items()}
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(argv[argv.index("--run_dir") + 1],
                           "metrics.jsonl")) as f:
        rec["metrics"] = [json.loads(line) for line in f]
    return rec


def phase_mdr(torch, dev, card):
    """The MDR / MVSEC slice through its entry points on trees written
    here: ``train_mdr`` with the en4 config (full width, f32, batch 4, the
    augmentor, validation on outdoor_day1 every epoch) with its validation
    step's K1 / K2 launches and a train step's K2b launches held against
    their twins, ``train_mdr`` with the STT config (no kernel),
    ``eval_mvsec`` on indoor_flying1 at dt1 and dt4 from the en4 run's
    checkpoint with its first window's K1 / K2 launches held against their
    twins."""
    import shutil
    import yaml
    from torch.utils.data import Subset
    from sdformerflow_tpu_torch import eval_mvsec
    from sdformerflow_tpu_torch.data.adapters import MvsecChunkAdapter
    from sdformerflow_tpu_torch.data.mvsec import (MvsecEventFlow,
                                                   MvsecEventFlow_dt4)
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training import train_loop as TL
    from sdformerflow_tpu_torch.training.config import (load_config,
                                                        merge_eval_config)
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                        "smoke_mdr")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    rng = np.random.default_rng(SEED + 140)
    t0 = time.perf_counter()
    write_mdr_tree(data, rng)
    h5_bytes = sum(write_mvsec_sequence(data, seq, n, rng)
                   for seq, n in MVSEC_GT.items())
    tree_s = time.perf_counter() - t0
    n_h5 = sum(n + 7 for n in MVSEC_GT.values())
    log(f"[14] trees at {MDR_SENSOR[0]}x{MDR_SENSOR[1]} written in "
        f"{tree_s:.2f} s: MDR dt1/train {MDR_SCENES} scenes x 4 .npz of "
        f"{MDR_EVENTS} events + .flo; MVSEC {n_h5} .h5 files of "
        f"{MDR_EVENTS} events ({h5_bytes / 2 ** 20:.1f} MiB by the port's "
        f"writer, each read back bit for bit) + flowgt_dt1/dt4 "
        f"({MVSEC_GT})")

    def write_yaml(name, path, **sections):
        with open(path) as f:
            raw = yaml.safe_load(f)
        for section, kw in sections.items():
            raw.setdefault(section, {}).update(kw)
        out = os.path.join(root, name)
        with open(out, "w") as f:
            yaml.safe_dump(raw, f)
        return out

    out = {"launches": {}}
    # the en4: 2 epochs of 2 steps, each ending with a validation
    en4_cfg = write_yaml("mdr_en4.yaml", MDR_CONFIG,
                         loader={"n_epochs": 2},
                         test={"n_valid": 1, "sample": MDR_VALID_SAMPLE})
    run_dir = os.path.join(root, "train_en4")
    rec = mdr_train(torch, ["--config", en4_cfg, "--path", data,
                            "--run_dir", run_dir], TL, P)
    steps, launched = rec["steps"], rec["launches"]
    losses = [s[1] for s in steps]
    names = [m["name"] for m in rec["metrics"]]
    check(len(steps) == 2 * MDR_SCENES // 4 and all(np.isfinite(losses))
          and int(rec["opt"].notfinite_count) == 0,
          f"[14] train_mdr en4: steps {steps}")
    check(all(s[2] == s[3] > 0 for s in steps)
          and len({s[3] for s in steps}) == 1,
          f"[14] train_mdr en4: K2 / K2b launches per step {steps}")
    # the validations (batch 4, eval mode) run K1 and K2; training no K1
    check(launched["K1"] > 0 and launched["K2b"] == sum(s[3] for s in steps)
          and launched["K2"] > launched["K2b"],
          f"[14] train_mdr en4: launches {launched}")
    check(names.count("train_loss") == 2 and names.count("valid_loss") == 2
          and all(np.isfinite(m["value"]) for m in rec["metrics"]),
          f"[14] train_mdr en4: metrics.jsonl {rec['metrics']}")
    valid = [m["value"] for m in rec["metrics"] if m["name"] == "valid_loss"]
    out["launches"]["train_en4"] = launched
    log(f"[14] train_mdr en4 (configs/train_mdr_sdformerflow.yaml: base 96, "
        f"depths (2,2,6,2), window (2,8,8), T=5, batch 4, f32, TF32 off, "
        f"20-bin chunks of the augmented best-density volumes, 256x256; "
        f"2 epochs of {len(steps) // 2} steps, each validated on "
        f"outdoor_day1 dt1): losses {[round(v, 4) for v in losses]}, "
        f"valid {[round(v, 4) for v in valid]}; per step K2 {steps[0][2]} "
        f"and K2b {steps[0][3]} launches; the run's launches {launched}; "
        f"{rec['seconds']:.1f} s with the host's reads on {card}")

    # the step timed on the loop's last batch, the trained model going on
    step, batch = rec["step"], rec["batch"]
    ms = []
    for _ in range(2 + MDR_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
    p50, p90 = (float(v) for v in np.percentile(ms[2:], [50, 90]))
    dev_ms = device_ms_per_call(torch, lambda: step(batch), 3)
    out["train_step"] = dict(p50_ms=p50, p90_ms=p90, step_ms=ms,
                             device_ms=dev_ms, peak_gib=rec["peak_gib"],
                             run_step_ms=[s[0] for s in steps],
                             losses=losses, valid_losses=valid,
                             launches_per_step={"K2": steps[0][2],
                                                "K2b": steps[0][3]})
    log(f"[14] MDR en4 train step (batch 4, f32, 256x256) on {card}: p50 "
        f"{p50:.2f} ms, p90 {p90:.2f} over {MDR_TIMED_STEPS} steps after 2 "
        f"warm-up (host clock, a sync a step; the run's own steps "
        f"{[round(s[0], 1) for s in steps]} ms); device busy per step "
        + ("not measured: the profiler recorded no kernel" if dev_ms is None
           else f"{dev_ms:.2f} ms ({100 * dev_ms / p50:.1f}% of the p50)")
        + f" (profiler, 3 steps); peak memory {rec['peak_gib']:.2f} GiB "
        f"(max_memory_allocated over the train_mdr run)")

    # the run's validation step (batch 4, eval mode) on the first chunk
    # the validation read: every K1 and K2 launch against its plain twin
    chunk = rec["valid_chunk"]
    val = checked_forward(torch, rec["eval_step"], chunk,
                          "[14] train_mdr validation")
    check(chunk.shape[0] == 4 and val["k1"] > 0 and val["k2"] > 0
          and bool(torch.isfinite(val["flow"]).all()),
          f"[14] train_mdr validation: chunk {list(chunk.shape)}, K1 "
          f"{val['k1']}, K2 {val['k2']} launches")
    # one more train step on the loop's last batch (batch 4): every K2b
    # launch against its float64 twin
    cap = dict(zip(("loss", "k2", "k2b", "sites", "err", "terms", "twin32"),
                   k2b_capture(torch, dev, P, step, batch, 14)))
    n_sites = sum(cap["sites"].values())
    check(batch["chunk"].shape[0] == 4 and np.isfinite(cap["loss"])
          and cap["k2"] == cap["k2b"] == n_sites == steps[0][3],
          f"[14] train step: batch {list(batch['chunk'].shape)}, loss "
          f"{cap['loss']}, K2 {cap['k2']} and K2b {cap['k2b']} launches for "
          f"{n_sites} PSN sites")
    check(captured_ok(cap["err"], cap["terms"]),
          f"[14] train step: K2b vs its twin {cap['err']}; over the sums of "
          f"|terms|: {cap['terms']}")
    out["checked"] = dict(
        valid_k1=val["k1"], valid_k2=val["k2"],
        valid_flipped={k: v[0] for k, v in val["flips"].items()},
        valid_flow_equal_to_plain=val["same"], train_k2b=cap["k2b"],
        train_k2b_rel_err=cap["err"], train_k2b_terms_rel_err=cap["terms"])
    log(f"[14] train_mdr's validation step on its chunk "
        f"{list(chunk.shape)} (f32, eval mode): K1 {val['k1']} and K2 "
        f"{val['k2']} launches, each vs its twin: K1 "
        f"{val['flips']['K1'][0]} of {val['flips']['K1'][1]} spikes "
        f"flipped, K2 {val['flips']['K2'][0]} of {val['flips']['K2'][1]}; "
        f"flow equal to the plain path's: {val['same']}. Its train step on "
        f"the last batch {list(batch['chunk'].shape)}: K2b {cap['k2b']} "
        f"launches, each vs the float64 twin, largest |d| / twin's largest: "
        + ", ".join(f"{k} {v:.3g}" for k, v in cap["err"].items())
        + "; / the largest sum of |terms|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in cap["terms"].items()))
    ckpt = os.path.join(run_dir, "ckpt")
    del rec, step, batch, chunk, val, cap
    torch.cuda.empty_cache()

    # the STT (ANN): 2 steps, no kernel
    stt_cfg = write_yaml("mdr_stt.yaml", STT_MDR_CONFIG, test={"sample": 2})
    rec = mdr_train(torch, ["--config", stt_cfg, "--path", data,
                            "--max_steps", "2", "--run_dir",
                            os.path.join(root, "train_stt")], TL, P)
    losses = [s[1] for s in rec["steps"]]
    check(len(losses) == 2 and all(np.isfinite(losses))
          and not any(rec["launches"].values())
          and {"train_loss", "valid_loss"} <= {m["name"]
                                               for m in rec["metrics"]},
          f"[14] train_mdr STT: losses {losses}, launches "
          f"{rec['launches']}, metrics {rec['metrics']}")
    out["launches"]["train_stt"] = rec["launches"]
    out["stt"] = dict(losses=losses, seconds=rec["seconds"],
                      peak_gib=rec["peak_gib"])
    log(f"[14] train_mdr STT (configs/train_mdr_stt_voxel.yaml: "
        f"STTFlowNet_4en, batch 1, f32, 2 steps, validation on "
        f"outdoor_day1): losses {losses}, launches {rec['launches']} (none "
        f"expected), {rec['seconds']:.1f} s, peak {rec['peak_gib']:.2f} GiB "
        f"on {card}")
    del rec
    torch.cuda.empty_cache()

    # eval_mvsec on indoor_flying1, dt1 and dt4, from the en4 checkpoint
    out["eval"] = {}
    for dt in ("dt1", "dt4"):
        ev_cfg = write_yaml(f"eval_{dt}.yaml", MVSEC_EVAL_CONFIG,
                            data={"event_interval": dt})
        rec = eval_run(torch, eval_mvsec.main, [
            "--train_config", MDR_CONFIG, "--eval_config", ev_cfg,
            "--ckpt", ckpt, "--path", data, "--sequence", "indoor_flying1",
            "--max_batches", str(MVSEC_EVAL), "--run_dir",
            os.path.join(root, f"eval_{dt}")])
        res = rec["results"]
        with open(os.path.join(root, f"eval_{dt}", "results.json")) as f:
            check(json.load(f) == res, f"[14] eval_mvsec {dt}: results.json "
                  "differs from the returned results")
        check(res["num_samples"] == res["num_batches"] == MVSEC_EVAL
              and res["sequence"] == "indoor_flying1"
              and all(np.isfinite(res[k]) for k in DSEC_METRICS),
              f"[14] eval_mvsec {dt}: {res}")
        want, kept = recompute_numpy(rec)
        err = {k: abs(res[k] - want[k]) / max(abs(want[k]), 1e-300)
               for k in DSEC_METRICS}
        check(all(e <= MVSEC_EVAL_TOL for e in err.values()),
              f"[14] eval_mvsec {dt}: metrics against the float64 "
              f"recompute {err}")
        # batch 1 at 256x256: K1 at stages 1-3, stage 4's odd window count
        # takes the raw-refold form (phase 11)
        n = MVSEC_EVAL
        want_l = launches_of(K1=10 * n, K2=53 * n)
        check(rec["launches"] == want_l, f"[14] eval_mvsec {dt}: launches "
              f"{rec['launches']}, expected {want_l}")
        # the run's eval step on its first window's chunk: every K1 and K2
        # launch against its plain twin
        chunk = rec["inputs"][0][3]
        fwd = checked_forward(torch, rec["steps"][0], chunk,
                              f"[14] eval_mvsec {dt}")
        check(chunk.shape[0] == 1 and fwd["k1"] == 10 and fwd["k2"] == 53,
              f"[14] eval_mvsec {dt}: chunk {list(chunk.shape)}, K1 "
              f"{fwd['k1']}, K2 {fwd['k2']} launches in the checked window")
        check(all(p[3] is not None for p in rec["inputs"])
              and kept is not None and 0 < kept < 1,
              f"[14] eval_mvsec {dt}: the event footprint keeps {kept}")
        merged = merge_eval_config(load_config(MDR_CONFIG),
                                   load_config(ev_cfg))
        merged["data"].update(path=data, test_sequence="indoor_flying1")
        cls = MvsecEventFlow if dt == "dt1" else MvsecEventFlow_dt4
        split = eval_split(torch, dev, merged, rec, lambda: Subset(
            MvsecChunkAdapter(cls(merged), 1), range(MVSEC_EVAL)))
        out["eval"][dt] = dict(
            metrics={k: res[k] for k in DSEC_METRICS},
            rel_err_vs_f64=max(err.values()), launches=rec["launches"],
            checked_flipped={k: v[0] for k, v in fwd["flips"].items()},
            checked_flow_equal_to_plain=fwd["same"],
            footprint_kept=kept, windows_per_s=rec["windows_per_s"],
            main_s=rec["main_s"], **split)
        log(f"[14] eval_mvsec indoor_flying1 {dt} (f32, batch 1, "
            f"{n} windows, configs/eval_mvsec.yaml: event footprint mask): "
            + ", ".join(f"{k} {res[k]:.6g}" for k in DSEC_METRICS)
            + f"; largest relative difference to the float64 numpy "
            f"recompute {max(err.values()):.3g}; the footprint keeps "
            f"{kept:.4f} of the GT-valid pixels; launches {rec['launches']}"
            f"; its first window with each launch vs its twin: K1 "
            f"{fwd['flips']['K1'][0]} of {fwd['flips']['K1'][1]} spikes "
            f"flipped, K2 {fwd['flips']['K2'][0]} of "
            f"{fwd['flips']['K2'][1]}, flow equal to the plain path's: "
            f"{fwd['same']}"
            f"; {rec['windows_per_s']:.2f} windows/s over the {n - 1} after "
            f"the first (host clock, reads included) on {card}; a window: "
            f"read (h5 + host voxelizer + collate, median of {n}) "
            f"{split['read_ms']:.2f} ms, H2D {split['h2d_mb']:.1f} MB "
            f"{split['h2d_ms']:.3f} ms, step + metrics {split['step_ms']:.2f}"
            f" ms (CUDA events), device busy "
            + ("not measured" if split["device_ms"] is None
               else f"{split['device_ms']:.3f} ms") + " (profiler)")
        out["launches"][f"eval_{dt}"] = rec["launches"]
        rec["inputs"].clear()
        rec["steps"].clear()
        del rec, chunk, fwd
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["tree_s"] = tree_s
    log(f"[14] phase {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ phase 15
# the deployment surface: export_model, a fresh-process reload of its
# programs, the HTTP front and its client, bench_serving, and what the
# kernels' custom ops cost the eager path

N_DEPLOY = 8          # voxel and event requests each, through every route
N_DEPLOY_TIMED = 32   # one at a time: the live and the reloaded p50
N_DISPATCH = 32       # eager voxel requests a route, the routes interleaved
DISPATCH_CALLS = 200  # back-to-back calls a route at one K1 and one K2 site
DEPLOY_TIMEOUT_S = 600
# the eager path would take the custom ops only if they cost a request at
# most this much; above it the wrappers launch straight and take the ops
# only while traced (ops/hopper_*.py)
DISPATCH_BUDGET_MS = 0.5

RELOAD_PROBE = r"""
import json, sys, time
import torch
t0 = time.perf_counter()
from sdformerflow_tpu_torch.training.export import load_exported
meta, fns = load_exported(sys.argv[1])
load_s = time.perf_counter() - t0
dev = torch.device(meta["device"])
loaded = sorted(m for m in sys.modules if m.startswith((
    "sdformerflow_tpu_torch.models", "sdformerflow_tpu_torch.serving",
    "sdformerflow_tpu_torch.training.train_step", "jax", "sdformerflow_tpu.")))
import chip_smoke as S
from sdformerflow_tpu_torch.ops import hopper_attn as A, hopper_psn as P
from sdformerflow_tpu_torch.ops import voxel as VP

def twin(*a, **kw):
    raise RuntimeError("a plain twin ran in the exported program")

if dev.type == "cuda":   # a program on the card runs no plain twin
    A.qk_attn_interior_plain = P.psn_spike = VP.voxel_grid_signed = twin
voxel, raw = S.deploy_inputs(meta["num_bins"], meta["crop"])
requests = {"voxel": [torch.from_numpy(c)[None].to(dev) for c in voxel],
            "events": [S.packed_events(torch, r, dev) for r in raw]}
programs = {"voxel": fns["voxel"], "events": fns[f"events_{S.K3_EVENTS}"]}
counts = lambda: {k: w.launches for k, w in S.kernel_wrappers().items()}
flows, per_request, totals = {}, [], dict.fromkeys(S.kernel_wrappers(), 0)
for kind, reqs in requests.items():
    flows[kind] = []
    for r in reqs:
        c0 = counts()
        flows[kind].append(programs[kind](r).cpu())
        c1 = counts()
        per_request.append([kind] + [c1[k] - c0[k] for k in ("K1", "K2", "K3")])
        for k in totals:
            totals[k] += c1[k] - c0[k]
torch.save(flows, sys.argv[2])
timed = {kind: S.request_p50(torch, programs[kind], reqs, S.N_DEPLOY_TIMED)
         for kind, reqs in requests.items()}
busy = {kind: S.device_ms_per_call(torch, lambda: programs[kind](reqs[0]), 8)
        for kind, reqs in requests.items()}
print(json.dumps({"load_s": load_s, "loaded": loaded,
                  "per_request": per_request, "launches": totals,
                  "p50_ms": timed, "device_ms": busy}))
"""


def deploy_inputs(bins, hw):
    """The phase's requests, the same in every process: N_DEPLOY sparse
    voxel chunks [bins, h, w] and N_DEPLOY exact (dyadic) windows of
    0.6-1.0 x 2^20 events at 480x640, so that K3's sums, and the flows,
    do not depend on the order of its atomics."""
    rng = np.random.default_rng(SEED + 150)
    raw = [dyadic_window(rng, bins, int(rng.uniform(0.6, 1.0) * K3_EVENTS))
           for _ in range(N_DEPLOY)]
    return voxel_requests(N_DEPLOY, bins, hw, SEED + 151), raw


def packed_events(torch, request, dev):
    """A raw window packed as the server packs it (``native.pack_window``,
    t taken as it comes) into the exported events program's input:
    {x, y, t, p: [1, 2^20] float32, valid: [1, 2^20] bool} on ``dev``."""
    from sdformerflow_tpu_torch import native
    buf = np.empty((5, K3_EVENTS), np.float32)
    native.pack_window(request["x"], request["y"], request["t"],
                       request["p"], K3_EVENTS, t0=0.0, out=buf)
    b = torch.from_numpy(buf).to(dev)
    return {"x": b[None, 0], "y": b[None, 1], "t": b[None, 2],
            "p": b[None, 3], "valid": b[None, 4] != 0}


def request_p50(torch, fn, requests, n):
    """The p50 (host clock, ms) of ``fn`` on ``requests`` cycled, one at a
    time, each ending in a sync."""
    fn(requests[0])
    lat = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(requests[i % len(requests)])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50))


def op_sites():
    """Site functions that reach K1 and K2 through their custom ops, as a
    traced program does, in place of the wrappers' straight launch."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P

    def psn(x, w, b, *, scale=None, shift=None, **_):   # forward only
        return P.fused_affine_psn_op(x, w, b, scale, shift, x.dtype)

    def attend(x, p, nh):
        a = A.qk_attn_interior_op(x, list(p[:A.N_INTERIOR]), nh)
        return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)
    return psn, attend


def host_ms_per_call(torch, fn, n=DISPATCH_CALLS):
    """Host ms a call over ``n`` back-to-back calls ending in one sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def dispatch_cost(torch, dev, server, voxel):
    """What reaching K1 and K2 through their custom ops costs the eager
    voxel request: its p50 with the ops against the straight launches, the
    routes interleaved, and each wrapper's host time a call at the
    smallest K1 and K2 site of the request, both routes."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    chunks = [torch.from_numpy(c)[None].to(dev) for c in voxel]
    lat = {"launch": [], "op": []}
    for i in range(N_DISPATCH):
        for route in ("launch", "op")[::1 if i % 2 else -1]:
            ctx = (site_functions(*op_sites()) if route == "op"
                   else contextlib.nullcontext())
            with ctx:
                lat[route].append(request_p50(
                    torch, server._step, [chunks[i % len(chunks)]], 1))
    p50 = {k: float(np.percentile(v, 50)) for k, v in lat.items()}
    attn, psn = capture_sites(torch, server.model, lambda: server.infer(
        voxel[0]))
    mod, x = min(attn, key=lambda a: a[1].numel())
    shape, dtype, _ = min(psn, key=lambda s: int(np.prod(s[0])))
    neuron = next(m for m in server.model.modules()
                  if isinstance(m, SpikingNeuron)
                  and m.weight.shape[0] == shape[0])
    gen = torch.Generator(dev).manual_seed(SEED + 152)
    xs = torch.randn(shape, generator=gen, device=dev).to(dtype)
    scale = torch.ones(shape[-1], device=dev)
    shift = torch.zeros(shape[-1], device=dev)
    with torch.inference_mode():
        p = mod.kernel_params()
        per_call = {
            "K1": {"launch": host_ms_per_call(torch, lambda: (
                      A.qk_attn_interior(x, p, mod.num_heads))),
                   "op": host_ms_per_call(torch, lambda: (
                      A.qk_attn_interior_op(x, list(p[:A.N_INTERIOR]),
                                            mod.num_heads)))},
            "K2": {"launch": host_ms_per_call(torch, lambda: (
                      P.fused_affine_psn(xs, neuron.weight, neuron.bias,
                                         scale=scale, shift=shift))),
                   "op": host_ms_per_call(torch, lambda: (
                      P.fused_affine_psn_op(xs, neuron.weight, neuron.bias,
                                            scale, shift, xs.dtype)))}}
    sites = {"K1": len(attn), "K2": len(psn)}
    per_request = sum(sites[k] * (v["op"] - v["launch"])
                      for k, v in per_call.items())
    return dict(p50_ms=p50, p50_delta_ms=p50["op"] - p50["launch"],
                per_call_ms=per_call, sites=sites,
                k1_site=list(x.shape), k2_site=list(shape),
                per_request_ms=per_request)


def serve_process(config_path, ckpt, dev):
    """``python -m sdformerflow_tpu_torch.serve`` on a free port: returns
    the process, its URL and a queue of its output lines."""
    import queue
    import threading
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdformerflow_tpu_torch.serve",
         "--train_config", config_path, "--ckpt", ckpt, "--port", "0",
         "--device", str(dev), "--warmup_events", str(K3_EVENTS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    deadline = time.perf_counter() + DEPLOY_TIMEOUT_S
    out = []
    while time.perf_counter() < deadline and proc.poll() is None:
        try:
            line = lines.get(timeout=1)
        except queue.Empty:
            continue
        out.append(line)
        if line.startswith("serving on "):
            return proc, line.split()[-1], lines
    proc.kill()
    proc.wait(timeout=30)
    raise SmokeFailure("serve did not start: " + "".join(out[-20:]))


def phase_deploy(torch, dev, config, state_dict, card):
    """Phase 15: the deployment surface at full en4 width."""
    import io
    import shutil
    import signal
    import urllib.request
    from sdformerflow_tpu_torch import bench_serving, export_model, flow_client
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training import export as X
    from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
    from sdformerflow_tpu_torch.training.config import build_configs
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                        "smoke_deploy")
    shutil.rmtree(root, ignore_errors=True)
    ckpt, out = os.path.join(root, "ckpt"), os.path.join(root, "export")
    model = get_model(config["model"]["name"], *build_configs(config))
    model.load_state_dict(state_dict)
    save_checkpoint(ckpt, model, torch.optim.SGD(model.parameters(), lr=0),
                    epoch=0, step=0)
    del model
    bins, hw = config["data"]["num_frames"], tuple(config["loader"]["crop"])

    # export_model --event_buckets 2^20 --verify; the export timed alone
    timing = {}

    def timed(export):
        def run(*args, **kw):
            t0 = time.perf_counter()
            meta = export(*args, **kw)
            timing["export_s"] = time.perf_counter() - t0
            return meta
        return run

    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    text = io.StringIO()
    t0 = time.perf_counter()
    with patched(X, "export_flow_model", timed), \
            contextlib.redirect_stdout(text):
        meta = export_model.main(["--train_config", CONFIG, "--ckpt", ckpt,
                                  "--out", out, "--device", str(dev),
                                  "--event_buckets", str(K3_EVENTS),
                                  "--verify"])
    main_s = time.perf_counter() - t0
    log("[15] export_model: " + " | ".join(text.getvalue().splitlines()))
    mb = {name: os.path.getsize(os.path.join(out, name + ".pt2")) / 1e6
          for name in meta["artifacts"]}
    check(meta["device"] == dev.type and meta["bf16"]
          and set(meta["verify"]) == {"voxel", f"events_{K3_EVENTS}"}
          and not any(meta["verify"].values()),
          f"export_model --verify: {meta.get('verify')}")
    log(f"[15] exported {sorted(mb)} in {timing['export_s']:.1f} s "
        f"({', '.join(f'{k} {v:.1f} MB' for k, v in mb.items())}); "
        f"export_model with --verify {main_s:.1f} s")

    # the live step: an in-process FlowServer on the same checkpoint
    voxel, raw = deploy_inputs(bins, hw)
    events = [packed_events(torch, r, dev) for r in raw]
    server = FlowServer(config, ckpt=ckpt, device=dev, bf16=True)
    try:
        chunks = [torch.from_numpy(c)[None].to(dev) for c in voxel]
        live = {"voxel": [server._step(c)[-1].cpu() for c in chunks],
                "events": [server._events_step(e)[-1].cpu()
                           for e in events]}
        infer = {"voxel": [server.infer(c) for c in voxel],
                 "events": [server.infer(r) for r in raw]}
        for kind in live:
            check(all(np.array_equal(a, b[0].numpy())
                      for a, b in zip(infer[kind], live[kind])),
                  f"FlowServer.infer differs from its own {kind} step")
        live_p50 = {"voxel": request_p50(torch, lambda c: server._step(c),
                                         chunks, N_DEPLOY_TIMED),
                    "events": request_p50(torch,
                                          lambda e: server._events_step(e),
                                          events, N_DEPLOY_TIMED)}
        live_busy = {
            "voxel": device_ms_per_call(
                torch, lambda: server._step(chunks[0]), 8),
            "events": device_ms_per_call(
                torch, lambda: server._events_step(events[0]), 8)}
        dispatch = dispatch_cost(torch, dev, server, voxel)
    finally:
        server.close()
    del events
    torch.cuda.empty_cache()

    # the programs reloaded in a fresh process that imports export.py only
    flows_path = os.path.join(root, "reloaded_flows.pt")
    t0 = time.perf_counter()
    probe = subprocess.run([sys.executable, "-c", RELOAD_PROBE, out,
                            flows_path], cwd=ROOT, capture_output=True,
                           text=True, timeout=DEPLOY_TIMEOUT_S)
    reload_s = time.perf_counter() - t0
    check(probe.returncode == 0, f"reload probe failed:\n{probe.stderr}")
    rel = json.loads(probe.stdout.strip().splitlines()[-1])
    check(rel["loaded"] == [], f"the reload imported {rel['loaded']}")
    for kind, k1, k2, k3 in rel["per_request"]:
        check((k1, k2, k3) == (12, 45, int(kind == "events")),
              f"reloaded {kind} request launched K1 {k1}, K2 {k2}, K3 {k3}")
    check(all(v == 0 for k, v in rel["launches"].items()
              if k not in ("K1", "K2", "K3")),
          f"reloaded programs launched {rel['launches']}")
    reloaded = torch.load(flows_path)
    equal = {kind: sum(torch.equal(a, b) for a, b in
                       zip(reloaded[kind], live[kind])) for kind in live}
    diff = {kind: max(float((a - b).abs().max()) for a, b in
                      zip(reloaded[kind], live[kind])) for kind in live}
    log(f"[15] reloaded in a fresh process ({reload_s:.1f} s, load "
        f"{rel['load_s']:.1f} s, no model module imported): launches a "
        f"request K1 12, K2 45 (+K3 1 events), no twin; flows equal to the "
        f"live step: voxel {equal['voxel']}/{N_DEPLOY}, events "
        f"{equal['events']}/{N_DEPLOY} (max |d| {diff})")
    check(all(v == N_DEPLOY for v in equal.values()),
          f"reloaded flows differ from the live step: {diff}")
    log(f"[15] p50 one at a time ({N_DEPLOY_TIMED}) on {card}: live voxel "
        f"{live_p50['voxel']:.2f} ms / reloaded {rel['p50_ms']['voxel']:.2f}"
        f", live events {live_p50['events']:.2f} / reloaded "
        f"{rel['p50_ms']['events']:.2f}; device busy a request: live "
        f"{live_busy} / reloaded {rel['device_ms']}")
    d = dispatch
    log(f"[15] eager dispatch through the custom ops (voxel request, "
        f"{N_DISPATCH} a route, interleaved): p50 launch "
        f"{d['p50_ms']['launch']:.3f} ms, op {d['p50_ms']['op']:.3f} "
        f"(+{d['p50_delta_ms']:.3f}); a call: K1 {d['per_call_ms']['K1']}, "
        f"K2 {d['per_call_ms']['K2']} ms at {d['k1_site']} / "
        f"{d['k2_site']}; x {d['sites']} sites = "
        f"+{d['per_request_ms']:.3f} ms a request; the eager path "
        + ("launches straight (over the "
           if d["per_request_ms"] > DISPATCH_BUDGET_MS else
           "could take the ops (within the ")
        + f"{DISPATCH_BUDGET_MS} ms budget)")

    # the HTTP front: serve on a free port, the same requests through the
    # client, /stats, /healthz, SIGTERM
    proc, url, lines = serve_process(CONFIG, ckpt, dev)
    try:
        t0 = time.perf_counter()
        http = {"voxel": [flow_client.post_flow(url, chunk=c)
                          for c in voxel],
                "events": [flow_client.post_flow(url, events=r)
                           for r in raw]}
        http_s = time.perf_counter() - t0
        for kind in http:
            check(all(np.array_equal(a, b)
                      for a, b in zip(http[kind], infer[kind])),
                  f"HTTP {kind} flows differ from FlowServer.infer")
        stats = flow_client.get_stats(url)
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = r.read()
        check(health == b"ok" and stats["served"] == 2 * N_DEPLOY + 2
              and stats["pending"] == 0, f"serve: /healthz {health!r}, "
              f"/stats {stats}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    tail = []
    while not lines.empty():
        tail.append(lines.get())
    check(rc == 0 and any("server closed" in ln for ln in tail),
          f"serve exited {rc} on SIGTERM: {''.join(tail[-10:])}")
    log(f"[15] serve --port 0 at {url}: {2 * N_DEPLOY} requests over HTTP "
        f"in {http_s:.1f} s, equal to FlowServer.infer; /stats {stats}; "
        f"/healthz ok; SIGTERM -> exit 0, server closed")

    # bench_serving --requests 32
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        bench = bench_serving.main(["--requests", "32", "--device",
                                    str(dev)])
    log("[15] bench_serving: " + " | ".join(text.getvalue().splitlines()))
    check(all(bench[k]["windows_per_s"] > 0
              for k in ("voxel@crop", "events@2^20")),
          f"bench_serving: {bench}")
    phase_s = time.perf_counter() - t_phase
    log(f"[15] phase 15: {phase_s:.1f} s")
    return dict(
        export_s=timing["export_s"], export_model_s=main_s,
        artifact_mb=mb, verify=meta["verify"], reload_s=reload_s,
        load_s=rel["load_s"], launches_export=rel["launches"],
        equal=equal, max_abs_diff=diff, live_p50_ms=live_p50,
        reloaded_p50_ms=rel["p50_ms"], live_device_ms=live_busy,
        reloaded_device_ms=rel["device_ms"], dispatch=dispatch,
        http_s=http_s, stats=stats,
        bench={k: v["windows_per_s"] for k, v in bench.items()
               if isinstance(v, dict)},
        phase_s=phase_s)


# ----------------------------------------------------------- phase 16
# the rest of the train slice and the re-expressions: the folded serving
# forward (K1 and K2 on folded weights), the s2d_train step (K2 / K2b in
# block space at 4 x 48 channels) and train_dsec with the optimizers,
# num_acc, Rotation and the prefetcher

N_FOLD_REQUESTS = 16     # interleaved latency requests per path
N_S2D_STEPS = 6          # timed train steps per model, the first 2 warm-up
N_OPTION_STEPS = 4       # train_dsec --max_steps of each optimizer run
BLOCK_HEAD = (10, 1, 144, 192, 192)   # the s2d_train head's fused site


def fold_serving(torch, dev, config, state_dict, hw, card):
    """The seeded en4 folded (``fold_model``, float32) and served in bf16
    through ``make_eval_step``, beside the unfolded model: K1 and K2
    launches a request, each launch against its twin, the spike sites of
    the two models against each other, p50 and device busy."""
    from sdformerflow_tpu_torch.losses import aee_metrics
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.models.spiking_layers import FoldedNorm
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training.bn_folding import fold_model
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, cfg)
    model.load_state_dict(state_dict)
    folded = fold_model(model)
    n_folded = sum(isinstance(m, FoldedNorm) for m in folded.modules())
    check(folded.cfg.fold_bn and n_folded > 0
          and not any("running" in k for k in folded.state_dict()),
          f"fold_model left BN entries ({n_folded} sites folded)")
    steps = {name: make_eval_step(m.to(dev), compute_dtype=torch.bfloat16)
             for name, m in (("unfolded", model), ("folded", folded))}
    chunks = [torch.from_numpy(r)[None].to(dev)
              for r in voxel_requests(N_FOLD_REQUESTS, 10, hw, SEED + 60)]
    A.qk_attn_interior.launches = P.fused_affine_psn.launches = 0
    flow = steps["folded"](chunks[0])[-1]
    torch.cuda.synchronize()
    k1, k2 = A.qk_attn_interior.launches, P.fused_affine_psn.launches
    check(k1 == 12 and k2 == 45, f"folded forward: K1 {k1}, K2 {k2} "
          "launches, expected 12 and 45")
    check(flow.shape == (1, 2) + tuple(hw)
          and bool(torch.isfinite(flow).all()), "folded flow")
    checked = checked_forward(torch, steps["folded"], chunks[0], "[16] "
                              "folded")
    recs = {name: [] for name in steps}
    for name, step in steps.items():
        psn, attend, _ = spike_recorders(recs[name])
        with site_functions(psn, attend):
            out = step(chunks[0])[-1].double()
        recs[name + "_flow"] = out
    n_flip, n, first, share = path_flips(recs["unfolded"], recs["folded"])
    check(share <= MAX_FLIP_SHARE, f"folded vs unfolded: {share:.3g} of the "
          f"first differing site's spikes flipped (site {first})")
    ones = torch.ones_like(recs["folded_flow"][:, :1])
    aee = aee_metrics(recs["folded_flow"], recs["unfolded_flow"],
                      ones)["AEE"].item()
    lat = {name: [] for name in steps}
    for c in chunks:
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(c)
            torch.cuda.synchronize()
            lat[name].append((time.perf_counter() - t0) * 1e3)
    busy = {name: device_ms_per_call(torch, lambda: step(chunks[0]), 4)
            for name, step in steps.items()}
    p50 = {name: float(np.percentile(v, 50)) for name, v in lat.items()}
    log(f"[16] folded serving forward (en4 bf16 288x384, batch 1, "
        f"{n_folded} BN sites folded): K1 {k1}, K2 {k2} launches a "
        f"request; against the twins K1 {checked['flips']['K1'][0]} of "
        f"{checked['flips']['K1'][1]} and K2 {checked['flips']['K2'][0]} of "
        f"{checked['flips']['K2'][1]} spikes flipped; folded vs unfolded: "
        f"{n_flip} of {n} spikes differ (first at site {first}, "
        f"{share:.3g} of it), AEE {aee:.6g} (information only)")
    log(f"[16] on {card}, {N_FOLD_REQUESTS} requests interleaved: p50 "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in p50.items())
        + "; device busy per request " + ", ".join(
            f"{k} " + ("not measured" if v is None else f"{v:.3f} ms")
            for k, v in busy.items()))
    del steps, model, folded
    torch.cuda.empty_cache()
    return dict(launches={"K1": k1, "K2": k2}, sites_folded=n_folded,
                twin_flips={k: v[0] for k, v in checked["flips"].items()},
                twin_spikes={k: v[1] for k, v in checked["flips"].items()},
                path_flipped=n_flip, path_spikes=n, first_site=first,
                first_site_share=share, aee_vs_unfolded=aee, p50_ms=p50,
                device_ms=busy)


def block_site_times(torch, x, g, w, b, kw):
    """K2 and K2b alone at the block-space head site beside their twins
    and bounds (float32)."""
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    T, n_col, C = x.shape[0], x.numel() // x.shape[0], x.shape[-1]
    launch_f = P.prepare_k2(x, w, b, **kw)[0]
    launch_b = P.prepare_k2b(x, g, w, b, **kw)[0]
    fwd_bound = bound(2 * nbytes(x) + (T * T + T) * 4 + 2 * C * 4,
                      (2 * T * T + 2 * T) * n_col, F32_FLOP_S)
    bwd_bound = bound(3 * nbytes(x) + 2 * (T * T + T) * 4 + 4 * C * 4,
                      (6 * T * T + 10 * T) * n_col, F32_FLOP_S)
    return dict(
        k2_ms=cuda_time_ms(launch_f),
        k2_plain_ms=cuda_time_ms(lambda: P.psn_spike(x, w, b, **kw)),
        k2_bound_ms=fwd_bound[0], k2_bound_by=fwd_bound[1],
        k2b_ms=cuda_time_ms(launch_b),
        k2b_plain_ms=cuda_time_ms(
            lambda: P.psn_backward_plain(x, g, w, b, **kw)),
        k2b_bound_ms=bwd_bound[0], k2b_bound_by=bwd_bound[1])


def s2d_train_step(torch, dev, config, state_dict, card):
    """One en4 float32 train step with ``cfg.s2d_train`` (the seeded base
    weights, loaded unchanged): K2 and K2b 93 launches each, every K2
    launch against its twin, K2b's dx at the block-space head against the
    float64 twin, the loss against the plain twins' step from the same
    state; then p50 / p90, device busy and peak memory beside the base
    model's step."""
    import copy
    import functools
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.optim import build_optimizer
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    model_cfg, swin, cfg = build_configs(config)
    batch = train_batch(torch, dev, TRAIN_HW, SEED + 61)

    def trainer(spiking_cfg):
        model = get_model(config["model"]["name"], model_cfg, swin,
                          spiking_cfg, train=True)
        model.load_state_dict(state_dict)
        model.float().to(dev)
        opt = build_optimizer(model.named_parameters(), lr=1e-4)
        return model, opt, make_train_step(
            model, opt, norm_input="minmax",
            generator=torch.Generator(dev).manual_seed(SEED))

    model, opt, step = trainer(cfg.replace(s2d_train=True))
    state0 = copy.deepcopy(model.state_dict())
    flips, block = [0, 0], {}

    def checked_fwd(x, w, b, *, scale=None, shift=None):
        y = P.fused_affine_psn(x, w, b, scale=scale, shift=shift)
        flips[0] += int((y != P.psn_spike(x, w, b, scale=scale,
                                          shift=shift)).sum())
        flips[1] += y.numel()
        return y

    def checked_bwd(x, g, w, b, **kw):
        got = P.fused_psn_backward(x, g, w, b, **kw)
        if tuple(x.shape) == BLOCK_HEAD:
            want = plain64(P, x, g, w, b, **kw)
            block.update(errors=k2b_errors(got, want), affine=kw.get(
                "scale") is not None, site=(
                    x.detach().clone(), g.detach().clone(), w.detach(),
                    b.detach(), {k: kw[k].detach() for k in ("scale", "shift")
                                 if kw.get(k) is not None}))
        return got

    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    impl = P.PSNImpl(checked_fwd, checked_bwd)
    with site_functions(functools.partial(P.affine_psn, impl=impl)):
        loss_k = step(batch)["loss"].item()
    k2, k2b = P.fused_affine_psn.launches, P.fused_psn_backward.launches
    check(k2 == 93 and k2b == 93, f"s2d_train step: K2 {k2}, K2b {k2b} "
          "launches, expected 93 each")
    check(block.get("affine") and block["errors"]["dx"] <= K2B_TOL,
          f"K2b at the block-space head {BLOCK_HEAD}: {block}")
    check(flips[0] <= MAX_FLIP_SHARE * flips[1],
          f"s2d_train step: K2 flipped {flips[0]} of {flips[1]} spikes")
    times = block_site_times(torch, *block.pop("site"))
    # the plain twins' step from the same state, batch and drop-path draws
    model.load_state_dict(state0)
    opt = build_optimizer(model.named_parameters(), lr=1e-4)
    plain_step = make_train_step(
        model, opt, norm_input="minmax",
        generator=torch.Generator(dev).manual_seed(SEED))
    with site_functions(functools.partial(P.affine_psn, impl=P.PLAIN)):
        loss_p = plain_step(batch)["loss"].item()
    if flips[0] == 0:
        check(loss_k == loss_p, f"s2d_train: no spike flipped, yet the "
              f"losses differ: {loss_k} vs {loss_p}")
    check(np.isfinite(loss_k), f"s2d_train loss {loss_k}")
    del plain_step, step
    # the s2d_train step beside the base step, interleaved
    runs = {"base": trainer(cfg), "s2d_train": (model, opt, make_train_step(
        model, opt, norm_input="minmax",
        generator=torch.Generator(dev).manual_seed(SEED)))}
    # peak: the card's peak during the step (both models resident) and
    # its rise above what was allocated before the step
    ms, peak, rise = {k: [] for k in runs}, {}, {}
    counts = {k: [] for k in runs}
    for i in range(N_S2D_STEPS):
        for name, (_, _, st) in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            c0 = (P.fused_affine_psn.launches, P.fused_psn_backward.launches)
            t0 = time.perf_counter()
            st(batch)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            top = torch.cuda.max_memory_allocated()
            peak[name] = max(peak.get(name, 0.0), top / 2 ** 30)
            rise[name] = max(rise.get(name, 0.0), (top - before) / 2 ** 30)
            counts[name].append((P.fused_affine_psn.launches - c0[0],
                                 P.fused_psn_backward.launches - c0[1]))
    check(all(c == (93, 93) for v in counts.values() for c in v),
          f"K2 / K2b launches per step: {counts}")
    busy = {name: device_ms_per_call(torch, lambda: st(batch), 2)
            for name, (_, _, st) in runs.items()}
    pct = {name: [float(x) for x in np.percentile(v[2:], [50, 90])]
           for name, v in ms.items()}
    log(f"[16] s2d_train step (en4 f32, TF32 off, 288x384, batch 1, the "
        f"base weights): K2 {k2}, K2b {k2b} launches; K2 flipped {flips[0]} "
        f"of {flips[1]} spikes against its twin; K2b at the block-space "
        f"head {list(BLOCK_HEAD)} against the float64 twin: "
        + ", ".join(f"{k} {v:.3g}" for k, v in block["errors"].items())
        + f"; loss kernels {loss_k!r}, plain twins {loss_p!r}")
    log(f"[16] block-space head alone (f32): K2 {times['k2_ms']:.4f} ms "
        f"(twin {times['k2_plain_ms']:.4f}, bound {times['k2_bound_ms']:.4f}"
        f" {times['k2_bound_by']}), K2b {times['k2b_ms']:.4f} ms (twin "
        f"{times['k2b_plain_ms']:.4f}, bound {times['k2b_bound_ms']:.4f} "
        f"{times['k2b_bound_by']})")
    log(f"[16] on {card}, {N_S2D_STEPS} steps each interleaved (2 warm-up): "
        + "; ".join(f"{k} p50 {pct[k][0]:.2f} ms, p90 {pct[k][1]:.2f}, "
                    f"device busy " + ("not measured" if busy[k] is None
                                       else f"{busy[k]:.2f} ms")
                    + f", peak {peak[k]:.3f} GiB ({rise[k]:.3f} above "
                    "the resident state)" for k in runs))
    del runs, model, opt
    torch.cuda.empty_cache()
    return dict(launches={"K2": k2, "K2b": k2b}, k2_flipped=flips[0],
                k2_spikes=flips[1], block_k2b_errors=block["errors"],
                loss_kernels=loss_k, loss_plain=loss_p, block_site=times,
                p50_ms={k: v[0] for k, v in pct.items()},
                p90_ms={k: v[1] for k, v in pct.items()},
                device_ms=busy, peak_gib=peak, peak_rise_gib=rise)


def trainer_options(torch, dev, card):
    """``train_dsec --synthetic --max_steps`` on the en4 config written
    anew with Adam, SGD + one_cycle and AdamW + num_acc 2, each with
    Rotation first in ``loader.augment``: finite losses, one update per
    ``num_acc`` steps, and the median wait of a step for its batch."""
    import copy
    import shutil
    import tempfile
    import yaml
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training import train_loop as TL
    from sdformerflow_tpu_torch.training.config import load_config
    base = load_config(CONFIG)
    options = {"Adam": dict(name="Adam"),
               "SGD_one_cycle": dict(name="SGD", scheduler="one_cycle"),
               "AdamW_num_acc_2": dict(name="AdamW", num_acc=2)}
    out = {}
    tmp = tempfile.mkdtemp(prefix="smoke_options_")
    try:
        for label, opt_kw in options.items():
            config = copy.deepcopy(base)
            config["optimizer"].update(opt_kw)
            config["loader"].update(
                augment=["Rotation", "Horizontal", "Vertical"],
                augment_prob=[0.5, 0.5, 0.5], rotation_degrees=[-30, 30])
            path = os.path.join(tmp, label + ".yaml")
            with open(path, "w") as f:
                yaml.safe_dump(config, f)
            run_dir = os.path.join(tmp, label)
            steps, wall, model, opt = dsec_train(torch, [
                "--config", path, "--synthetic", "--max_steps",
                str(N_OPTION_STEPS), "--run_dir", run_dir, "--device",
                str(dev)], TL, P)
            num_acc = opt_kw.get("num_acc", 1)
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                recs = {r["name"]: r["value"] for r in map(json.loads, f)}
            losses = [s[0] for s in steps]
            check(len(steps) == N_OPTION_STEPS and all(np.isfinite(losses))
                  and np.isfinite(recs["train_loss"]),
                  f"{label}: losses {losses}, metrics {recs}")
            check(type(opt).__name__ == opt_kw["name"]
                  and opt.gradient_step == N_OPTION_STEPS // num_acc
                  and int(opt.count) == N_OPTION_STEPS // num_acc
                  and int(opt.notfinite_count) == 0,
                  f"{label}: {type(opt).__name__}, {opt.gradient_step} "
                  f"updates, {int(opt.count)} applied, "
                  f"{int(opt.notfinite_count)} skipped")
            out[label] = dict(losses=losses, updates=opt.gradient_step,
                              seconds=wall,
                              batch_wait_ms_p50=recs["batch_wait_ms_p50"],
                              launches_per_step={"K2": steps[0][1],
                                                 "K2b": steps[0][2]})
            log(f"[16] train_dsec --synthetic --max_steps {N_OPTION_STEPS}, "
                f"{label} (Rotation, flips): losses "
                + ", ".join(f"{v:.4g}" for v in losses)
                + f"; {opt.gradient_step} updates; a step waited "
                f"{recs['batch_wait_ms_p50']:.3f} ms (median) for its batch;"
                f" {wall:.1f} s with validation, on {card}")
            del model, opt
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_train_slice(torch, dev, config, state_dict, card):
    t_phase = time.perf_counter()
    hw = tuple(config["loader"]["crop"])
    folded = fold_serving(torch, dev, config, state_dict, hw, card)
    s2d = s2d_train_step(torch, dev, config, state_dict, card)
    options = trainer_options(torch, dev, card)
    phase_s = time.perf_counter() - t_phase
    log(f"[16] phase 16: {phase_s:.1f} s")
    return dict(folded=folded, s2d_train=s2d, trainer_options=options,
                phase_s=phase_s)


# ----------------------------------------------------------- phase 17
# the rest of the SNN zoo at full width (the en4 config cut to 3 stages):
# the SEW SpikingformerFlowNet served in bf16 (K2 at every PSN site) and
# trained in float32 (K2 and K2b at every site), MS_SpikingformerFlowNet
# (K1 at its 10 blocks and K2), the SEW model with LIF (no kernel at its
# neuron sites) and SpikingMultiResUNet with its registry defaults (K2)

ZOO_EMBED = "Spiking_PatchEmbed_Conv_sfn"
N_ZOO_REQUESTS = 16     # served requests of the SEW model, one at a time
N_ZOO_FORWARDS = 6      # timed forwards of the other zoo models
N_ZOO_STEPS = 6         # timed train steps, the first 2 warm-up


def zoo_config(name, embed=ZOO_EMBED, **spiking):
    """The en4 config with ``model.name``, the patch embed, depths
    (2, 2, 6), heads (3, 6, 12), out_indices (0, 1, 2) and ``spiking``
    over its ``spiking_neuron`` section; all else as the en4 config."""
    from sdformerflow_tpu_torch.training.config import load_config
    config = load_config(CONFIG)
    config["model"]["name"] = name
    sw = config["swin_transformer"]
    sw.update(use_arc=[sw["use_arc"][0], embed], swin_depths=[2, 2, 6],
              swin_num_heads=[3, 6, 12], swin_out_indices=[0, 1, 2])
    config["model"]["spiking_neuron"].update(spiking)
    return config


def zoo_model(torch, config, model_cfg=None):
    """The config's model (``model_cfg`` in place of the config's model
    section if given) in float32 eval mode with seeded random weights."""
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training.config import build_configs
    mcfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg or mcfg, swin, cfg)
    return randomize_(model, torch.Generator().manual_seed(SEED + 70))


@contextlib.contextmanager
def psn_calls(model, calls):
    """Count in ``calls[0]`` the PSN-site calls of ``model`` (each must
    launch K2 once on the card)."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron

    def hook(mod, args):
        calls[0] += 1
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, SpikingNeuron) and m.kind == "psn"]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def zoo_counted(torch, step, model, chunk):
    """One forward of ``step`` with the launch counts set to 0 just before
    and read just after: (finest flow, K1, K2, PSN-site calls)."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    calls = [0]
    with psn_calls(model, calls):
        A.qk_attn_interior.launches = P.fused_affine_psn.launches = 0
        flow = step(chunk)[-1]
        torch.cuda.synchronize()
        k1, k2 = A.qk_attn_interior.launches, P.fused_affine_psn.launches
    return flow, k1, k2, calls[0]


def zoo_checked(torch, step, chunk, label, kernels):
    """One forward of ``step`` with every K1 and K2 launch held against its
    plain twin on the same input (no more than MAX_FLIP_SHARE of the output
    spikes flipped, for each of ``kernels``) and each K2 site's firing
    rate inside (0, 1). Returns the flips and the rates."""
    flips = {"K1": [0, 0], "K2": [0, 0]}
    rates = []
    psn, attend = checked_kernels(flips)

    def psn_rate(x, w, b, **kw):
        y = psn(x, w, b, **kw)
        rates.append(float(y.float().mean()))
        return y

    with site_functions(psn_rate, attend):
        flow = step(chunk)[-1]
    check(bool(torch.isfinite(flow).all()), f"{label}: non-finite flow")
    for key in kernels:
        n_flip, n = flips[key]
        check(n > 0 and n_flip <= MAX_FLIP_SHARE * n,
              f"{label}: {key} flipped {n_flip} of {n} spikes")
    check(rates and all(0.0 < r < 1.0 for r in rates),
          f"{label}: a K2 site fires all-0 or all-1 (rates "
          f"{min(rates or [0]):.3g}-{max(rates or [0]):.3g}): the check "
          "would be vacuous")
    return flips, rates


def forward_p50(torch, step, chunks):
    """Host ms per forward (to the finest flow on the host), p50 / p90."""
    ms = []
    for c in chunks:
        t0 = time.perf_counter()
        step(c)[-1].cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
    return [float(v) for v in np.percentile(ms, [50, 90])]


def zoo_serving(torch, dev, hw, card):
    """(a) the SEW model served in bf16 through FlowServer on voxel
    requests: K2 once at every PSN site, each launch against its twin."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    config = zoo_config("SpikingformerFlowNet")
    model = zoo_model(torch, config)
    state = model.state_dict()
    requests = voxel_requests(N_ZOO_REQUESTS, 10, hw, SEED + 71)
    calls = [0]
    with FlowServer(config, state, device=dev, bf16=True) as server:
        server.infer(requests[0])                    # warm-up
        with psn_calls(server.model, calls):
            A.qk_attn_interior.launches = P.fused_affine_psn.launches = 0
            lat, flows = [], []
            for r in requests:
                t0 = time.perf_counter()
                flows.append(server.infer(r))
                lat.append((time.perf_counter() - t0) * 1e3)
            k1, k2 = A.qk_attn_interior.launches, P.fused_affine_psn.launches
        busy = device_ms_per_call(torch, lambda: server.infer(requests[0]),
                                  4)
    n = len(requests)
    check(k1 == 0 and k2 == calls[0] and k2 > 0 and k2 % n == 0,
          f"SEW serving: K2 {k2} launches for {calls[0]} PSN-site calls "
          f"over {n} requests (K1 {k1})")
    check(all(f.shape == (2,) + tuple(hw) and np.isfinite(f).all()
              for f in flows), "SEW serving: flows")
    step = make_eval_step(model.to(dev), compute_dtype=torch.bfloat16)
    chunk = torch.from_numpy(requests[0])[None].to(dev)
    flips, rates = zoo_checked(torch, step, chunk, "[17] SEW bf16", ("K2",))
    p50, p90 = (float(v) for v in np.percentile(lat, [50, 90]))
    log(f"[17] SEW SpikingformerFlowNet ({ZOO_EMBED}, depths (2,2,6), "
        f"{hw[0]}x{hw[1]}, bf16) served: K2 {k2 // n} launches a request (one at "
        f"each PSN site), K1 0; against the twin {flips['K2'][0]} of "
        f"{flips['K2'][1]} spikes flipped; site firing rates "
        f"{min(rates):.3f}-{max(rates):.3f}")
    log(f"[17] on {card}, {n} requests one at a time: p50 {p50:.2f} ms, "
        f"p90 {p90:.2f}; device busy per request "
        + ("not measured" if busy is None else f"{busy:.2f} ms"))
    del step
    return state, dict(k2_per_request=k2 // n, p50_ms=p50, p90_ms=p90,
                       device_ms=busy, k2_flipped=flips["K2"][0],
                       k2_spikes=flips["K2"][1], rate_min=min(rates),
                       rate_max=max(rates))


def zoo_train(torch, dev, state, hw, card):
    """(b) the SEW model's float32 train step at batch 1 (TF32 off): K2 and
    K2b once at every PSN site, each K2 launch against its twin, each K2b
    launch's dx within K2B_TOL of the float64 twin's largest; p50 / p90,
    device busy and peak memory."""
    import functools
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    config = zoo_config("SpikingformerFlowNet")
    model, opt, step = en4_trainer(torch, dev, config, state)
    batch = train_batch(torch, dev, hw, SEED + 72)
    flips, dx_err = [0, 0], [0.0]

    def checked_fwd(x, w, b, *, scale=None, shift=None):
        y = P.fused_affine_psn(x, w, b, scale=scale, shift=shift)
        flips[0] += int((y != P.psn_spike(x, w, b, scale=scale,
                                          shift=shift)).sum())
        flips[1] += y.numel()
        return y

    def checked_bwd(x, g, w, b, **kw):
        got = P.fused_psn_backward(x, g, w, b, **kw)
        want = plain64(P, x, g, w, b, **kw)
        dx_err[0] = max(dx_err[0], rel_err(got[0], want[0])[1])
        return got

    calls = [0]
    impl = P.PSNImpl(checked_fwd, checked_bwd)
    with psn_calls(model, calls):
        P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
        with site_functions(functools.partial(P.affine_psn, impl=impl)):
            loss = step(batch)["loss"].item()
        torch.cuda.synchronize()
        k2, k2b = P.fused_affine_psn.launches, P.fused_psn_backward.launches
    check(np.isfinite(loss), f"SEW train step: loss {loss}")
    check(k2 == k2b == calls[0] > 0, f"SEW train step: K2 {k2}, K2b {k2b} "
          f"launches for {calls[0]} PSN-site calls")
    check(flips[0] <= MAX_FLIP_SHARE * flips[1],
          f"SEW train step: K2 flipped {flips[0]} of {flips[1]} spikes")
    check(dx_err[0] <= K2B_TOL, f"SEW train step: K2b dx {dx_err[0]:.3g} "
          "of the float64 twin's largest")
    ms, counts = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(N_ZOO_STEPS):
        c0 = (P.fused_affine_psn.launches, P.fused_psn_backward.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_i = step(batch)["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.append((P.fused_affine_psn.launches - c0[0],
                       P.fused_psn_backward.launches - c0[1]))
        check(np.isfinite(loss_i), f"SEW train step: loss {loss_i}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(c == (k2, k2b) for c in counts),
          f"K2 / K2b launches per step: {counts}")
    busy = device_ms_per_call(torch, lambda: step(batch), 2)
    p50, p90 = (float(v) for v in np.percentile(ms[2:], [50, 90]))
    log(f"[17] SEW train step (f32, TF32 off, {hw[0]}x{hw[1]}, batch 1): "
        f"K2 {k2}, "
        f"K2b {k2b} launches a step (one each at every PSN site); K2 "
        f"flipped {flips[0]} of {flips[1]} spikes against its twin; K2b dx "
        f"{dx_err[0]:.3g} of the float64 twin's largest; loss {loss:.6g}")
    log(f"[17] on {card}, {N_ZOO_STEPS} steps (2 warm-up): p50 {p50:.2f} "
        f"ms, p90 {p90:.2f}, device busy "
        + ("not measured" if busy is None else f"{busy:.2f} ms")
        + f", peak {peak:.3f} GiB")
    del model, opt, step
    torch.cuda.empty_cache()
    return dict(k2_per_step=k2, k2b_per_step=k2b, k2_flipped=flips[0],
                k2_spikes=flips[1], k2b_dx_err=dx_err[0], loss=loss,
                p50_ms=p50, p90_ms=p90, device_ms=busy, peak_gib=peak)


def zoo_forward(torch, dev, hw, card, label, config, kernels,
                model_cfg=None):
    """A bf16 forward of the config's model: the counted run (K1 and K2
    launches, PSN-site calls), the launches held against their twins if
    ``kernels``, and the p50 / p90 of N_ZOO_FORWARDS forwards."""
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    model = zoo_model(torch, config, model_cfg).to(dev)
    step = make_eval_step(model, compute_dtype=torch.bfloat16)
    chunks = [torch.from_numpy(r)[None].to(dev)
              for r in voxel_requests(N_ZOO_FORWARDS, 10, hw, SEED + 73)]
    step(chunks[0])                                   # warm-up
    flow, k1, k2, calls = zoo_counted(torch, step, step.model, chunks[0])
    check(flow.shape == (1, 2) + tuple(hw)
          and bool(torch.isfinite(flow).all()), f"{label}: flow")
    check(k2 == calls, f"{label}: K2 {k2} launches for {calls} PSN-site "
          "calls")
    out = dict(k1=k1, k2=k2)
    if kernels:
        flips, rates = zoo_checked(torch, step, chunks[0], f"[17] {label}",
                                   kernels)
        out.update(flipped={k: flips[k][0] for k in kernels},
                   spikes={k: flips[k][1] for k in kernels},
                   rate_min=min(rates), rate_max=max(rates))
    p50, p90 = forward_p50(torch, step, chunks)
    out.update(p50_ms=p50, p90_ms=p90)
    log(f"[17] {label} ({hw[0]}x{hw[1]}, bf16): K1 {k1}, K2 {k2} launches a "
        "forward" + "".join(f"; {k} flipped {out['flipped'][k]} of "
                            f"{out['spikes'][k]} spikes against its twin"
                            for k in kernels)
        + f"; on {card}, {len(chunks)} forwards: p50 {p50:.2f} ms, p90 "
        f"{p90:.2f}")
    del model, step
    torch.cuda.empty_cache()
    return out


def phase_zoo(torch, dev, card):
    t_phase = time.perf_counter()
    from sdformerflow_tpu_torch.training.config import load_config
    hw = tuple(load_config(CONFIG)["loader"]["crop"])
    state, serving = zoo_serving(torch, dev, hw, card)
    train = zoo_train(torch, dev, state, hw, card)
    del state
    ms = zoo_forward(torch, dev, hw, card, "MS_SpikingformerFlowNet "
                     "(MS_Spiking_PatchEmbed_Conv_sfn, depths (2,2,6))",
                     zoo_config("MS_SpikingformerFlowNet",
                                "MS_Spiking_PatchEmbed_Conv_sfn"),
                     ("K1", "K2"))
    check(ms["k1"] == 10 and ms["k2"] > 0, f"MS_SpikingformerFlowNet: K1 "
          f"{ms['k1']}, K2 {ms['k2']} launches, expected K1 10")
    lif = zoo_forward(torch, dev, hw, card, "SEW SpikingformerFlowNet "
                      "with LIF", zoo_config("SpikingformerFlowNet",
                                             neuron_type="lif"), ())
    check(lif["k1"] == lif["k2"] == 0, f"LIF model: K1 {lif['k1']}, K2 "
          f"{lif['k2']} launches, expected none")
    unet = zoo_forward(torch, dev, hw, card, "SpikingMultiResUNet (base "
                       "32, 4 encoders, k 5, upsample-conv)",
                       zoo_config("SpikingMultiResUNet"), ("K2",),
                       model_cfg={"num_bins": 10})
    check(unet["k1"] == 0 and unet["k2"] > 0, f"SpikingMultiResUNet: K1 "
          f"{unet['k1']}, K2 {unet['k2']} launches")
    phase_s = time.perf_counter() - t_phase
    log(f"[17] phase 17: {phase_s:.1f} s")
    return dict(
        sew_serving=serving, sew_train=train, ms=ms, sew_lif=lif, unet=unet,
        launches={"K1": ms["k1"],
                  "K2": {"sew_request": serving["k2_per_request"],
                         "sew_train_step": train["k2_per_step"],
                         "ms_forward": ms["k2"],
                         "unet_forward": unet["k2"]},
                  "K2b": train["k2b_per_step"]},
        phase_s=phase_s)


# ----------------------------------------------------------- phase 18
# the neuron telemetry and the energy report at full en4 width

TELEMETRY_FLAGS = ("--store_spike_rates", "--energy_report",
                   "--store_membrane", "--log_attn")
TELEMETRY_ARTEFACTS = ("results.json", "spike_rates.json", "energy.json",
                       "membrane_stats.json", "attention_maps.npz")
H_TOL = 1e-6          # K2's potential against the twin's, of its largest |h|
SITE_RATE_TOL = 1e-3  # a site's rate, kernel path against the plain twins'
N_TELEMETRY_BUSY = 8  # forwards a device-busy measurement


def telemetry_model(torch, dev, config, state_dict):
    """The en4 model with the membrane monitor on (``store_v_seq``), the
    seeded weights, float32 on the card."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin,
                      cfg.replace(store_v_seq=True))
    model.load_state_dict(state_dict)
    return model.to(dev).eval()


@contextlib.contextmanager
def psn_signatures(model):
    """Yields a list that gets the (shape, dtype, affine) of every PSN call
    of ``model`` meanwhile, attention sites included."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    sigs = []

    def hook(mod, args, kwargs):
        x = args[0]
        sigs.append((tuple(x.shape), x.dtype,
                     kwargs.get("affine") is not None))
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules()
               if isinstance(m, SpikingNeuron) and m.kind == "psn"]
    try:
        yield sigs
    finally:
        for h in handles:
            h.remove()


def k2_membrane(torch, dev, sigs):
    """K2 with its potential output at every PSN site shape of a collecting
    forward, against ``psn_neuron(return_v=True)`` (``psn_spike``), float32
    and bfloat16: spikes and h bit for bit on dyadic inputs; on Gaussian
    inputs at most MAX_FLIP_SHARE of the spikes flipped and h within H_TOL
    of the twin's largest |h|; the spikes always those of the launch
    without h. Then, in the site's dtype with W and b in the model's, K2
    with and without h timed alone (prepared launches, in turns: without,
    with, with, without) and in a CUDA graph, the twin with h, and the
    bound with h (x read, the spikes and h written). Sums per forward."""
    from sdformerflow_tpu_torch.ops.hopper_psn import (fused_affine_psn,
                                                       prepare_k2, psn_spike)
    gen = torch.Generator().manual_seed(SEED + 18)
    sites = {}
    for sig in sigs:
        sites[sig] = sites.get(sig, 0) + 1
    out = dict(max_abs_err=0.0, h_max_rel_err=0.0, flip_share=0.0,
               device_ms=0.0, h_device_ms=0.0, graph_ms=0.0, h_graph_ms=0.0,
               h_plain_ms=0.0, h_bound_ms=0.0, bound_ms=0.0)
    by = {"bytes": 0.0, "operations": 0.0}
    for (shape, sdt, affine), count in sites.items():
        T, C = shape[0], shape[-1]
        for dt in (torch.float32, torch.bfloat16):
            for exact in (True, False):
                if exact:
                    w = dyadic((T, T), 0.125, -1.0, 1.0, gen, dev,
                               torch.float32)
                    b = dyadic((T, 1), 0.25, -1.0, 1.0, gen, dev,
                               torch.float32)
                    kw = (dict(scale=dyadic((C,), 0.25, 0.25, 2.0, gen, dev,
                                            torch.float32),
                               shift=dyadic((C,), 0.25, -1.0, 1.0, gen, dev,
                                            torch.float32))
                          if affine else {})
                    x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dt)
                else:
                    w = torch.randn(T, T, generator=gen).to(dev) * 0.4
                    b = torch.randn(T, 1, generator=gen).to(dev) * 0.4
                    kw = (dict(scale=torch.rand(C, generator=gen).to(dev)
                               + 0.5,
                               shift=torch.randn(C, generator=gen).to(dev))
                          if affine else {})
                    x = torch.randn(shape, generator=gen).to(dev, dt)
                s, h = fused_affine_psn(x, w, b, return_v=True, **kw)
                ws, wh = psn_spike(x, w, b, return_v=True, **kw)
                check(torch.equal(s, fused_affine_psn(x, w, b, **kw)),
                      f"K2 {shape} {dt}: the spikes with h differ from "
                      "those without")
                check(h.dtype == torch.float32 and h.shape == x.shape,
                      f"K2 {shape}: h {h.dtype} {tuple(h.shape)}")
                h_err = (h - wh).abs().max().item()
                scale = wh.abs().max().item()
                if exact:
                    err = (s.float() - ws.float()).abs().max().item()
                    out["max_abs_err"] = max(out["max_abs_err"], err, h_err)
                    check(err == 0.0 and h_err == 0.0,
                          f"K2+h {shape} {dt} dyadic: spikes {err}, h "
                          f"{h_err}")
                    check(0.0 < s.float().mean().item() < 1.0,
                          f"K2+h {shape} {dt} dyadic: degenerate output")
                else:
                    flip = (s != ws).float().mean().item()
                    out["flip_share"] = max(out["flip_share"], flip)
                    out["h_max_rel_err"] = max(out["h_max_rel_err"],
                                               h_err / scale)
                    check(flip <= MAX_FLIP_SHARE,
                          f"K2+h {shape} {dt}: flipped share {flip}")
                    check(h_err <= H_TOL * scale, f"K2+h {shape} {dt}: "
                          f"max|h - twin| {h_err} > {H_TOL} x {scale}")
        xt = torch.randn(shape, generator=gen).to(dev, sdt)
        wt, bt = w.to(sdt), b.to(sdt)
        launch_0 = prepare_k2(xt, wt, bt, **kw)[0]
        launch_h = prepare_k2(xt, wt, bt, return_v=True, **kw)[0]
        d0 = cuda_time_ms(launch_0)
        dh = (cuda_time_ms(launch_h) + cuda_time_ms(launch_h)) / 2
        d0 = (d0 + cuda_time_ms(launch_0)) / 2
        g0, gh = cuda_graph_ms(launch_0), cuda_graph_ms(launch_h)
        tp = cuda_time_ms(lambda: psn_spike(xt, wt, bt, return_v=True, **kw))
        n_col = xt.numel() // T
        site_bytes = (2 * nbytes(xt) + (T * T + T) * xt.element_size()
                      + (2 * C * 4 if affine else 0))
        flops = 2 * T * T * n_col + (2 * T * n_col if affine else 0)
        b0 = bound(site_bytes, flops, F32_FLOP_S)[0]
        bh, bh_by = bound(site_bytes + 4 * xt.numel(), flops, F32_FLOP_S)
        for key, v in (("device_ms", d0), ("h_device_ms", dh),
                       ("graph_ms", g0), ("h_graph_ms", gh),
                       ("h_plain_ms", tp), ("h_bound_ms", bh),
                       ("bound_ms", b0)):
            out[key] += v * count
        by[bh_by] += bh * count
        log(f"[18] K2 {list(shape)} {str(sdt)[6:]} affine={affine} "
            f"x{count}/collecting forward: alone {d0:.4f} ms, with h "
            f"{dh:.4f}; graph {g0:.4f}, with h {gh:.4f}; twin with h "
            f"{tp:.4f}; bound with h {bh:.4f} ({bh_by}): with h alone at "
            f"{100 * bh / dh:.1f}%, graph {100 * bh / gh:.1f}%")
    out.update(n_sites=len(sigs), n_shapes=len(sites),
               h_bound_by=max(by, key=by.get))
    log(f"[18] K2 per collecting forward ({len(sigs)} sites, "
        f"{len(sites)} shapes): alone {out['device_ms']:.4f} ms, with h "
        f"{out['h_device_ms']:.4f}; graphs {out['graph_ms']:.4f}, with h "
        f"{out['h_graph_ms']:.4f}; twin with h {out['h_plain_ms']:.4f}; "
        f"bound {out['bound_ms']:.4f}, with h {out['h_bound_ms']:.4f} ms "
        f"({out['h_bound_by']}); dyadic max|d| {out['max_abs_err']}, "
        f"gaussian flips {out['flip_share']:.2e}, h rel err "
        f"{out['h_max_rel_err']:.2e}")
    return out


def rate_stats(rates):
    v = np.asarray(sorted(rates))
    return dict(min=float(v[0]), median=float(np.median(v)),
                max=float(v[-1]))


def phase_telemetry(torch, dev, config, state_dict, card):
    """Phase 18: the neuron telemetry at full en4 width (see the module
    docstring). Returns the ``{"telemetry": ...}`` record."""
    import tempfile
    t_phase = time.perf_counter()
    from sdformerflow_tpu_torch import eval_dsec as E
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    hw = tuple(config["loader"]["crop"])
    model = telemetry_model(torch, dev, config, state_dict)
    kw = dict(encoding=config["model"].get("encoding", "voxel"),
              polarity=config["loader"].get("polarity", True),
              norm_input=config["model"].get("norm_input"),
              spike_th=config["data"].get("spike_th"))
    collect = make_eval_step(model, **kw, compute_dtype=torch.bfloat16,
                             collect_spike_rates=True)
    plain = make_eval_step(collect.model, **kw,
                           compute_dtype=torch.bfloat16)
    chunk = torch.from_numpy(voxel_requests(1, 10, hw, SEED + 18)[0])[
        None].to(dev)

    def counted(run):
        for wrapper in kernel_wrappers().values():
            wrapper.launches = 0
        out = run()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in kernel_wrappers().items()}

    # one collecting and one plain request, counted from 0
    with psn_signatures(collect.model) as sigs:
        (flows_c, sites), launches_c = counted(lambda: collect(chunk))
    flows_p, launches_p = counted(lambda: plain(chunk))
    check(launches_c == launches_of(K2=len(sigs)) and len(sigs) > 0,
          f"collecting forward: launches {launches_c}, {len(sigs)} PSN "
          "calls; expected K1 0 and K2 once a PSN call")
    check(launches_p == launches_of(K1=12, K2=45),
          f"plain en4 request: launches {launches_p}, expected K1 12, K2 45")
    rate_keys = [k for k in sites if "spike_rate" in k]
    mem_keys = [k for k in sites if "membrane" in k]
    check(len(rate_keys) == len(mem_keys) > 0
          and sum("attn/attn_sn/" in k for k in rate_keys) == 12,
          f"{len(rate_keys)} rate and {len(mem_keys)} membrane records, "
          "expected one each a site and 12 attn_sn")
    rates_k = {k: float(sites[k]) for k in rate_keys}
    check(all(torch.isfinite(sites[k]).all() for k in mem_keys),
          "non-finite membrane statistics")
    d_flow = max((a - b).abs().max().item() for a, b in zip(flows_c, flows_p))
    log(f"[18] a collecting en4 request (bf16, 288x384): K1 "
        f"{launches_c['K1']}, K2 {launches_c['K2']} launches ({len(sigs)} "
        f"PSN calls); the plain request K1 {launches_p['K1']}, K2 "
        f"{launches_p['K2']}; {len(rate_keys)} sites, rates "
        f"{rate_stats(rates_k.values())}; max|flow collecting - plain| "
        f"{d_flow:.4g} (module-form attention vs K1, bf16)")
    # (c) the same forward on the plain twins
    with site_functions(*plain_twins()):
        _, sites_t = collect(chunk)
    check(set(sites_t) == set(sites), "the twins' forward records other "
          "sites")
    d_rate = max(abs(float(sites_t[k]) - rates_k[k]) for k in rate_keys)
    d_mem = max(((sites_t[k] - sites[k]).abs().max()
                 / sites[k].abs().max().clamp(min=1e-30)).item()
                for k in mem_keys)
    check(d_rate <= SITE_RATE_TOL, f"a site's rate differs by {d_rate} "
          f"between the kernels and the plain twins (> {SITE_RATE_TOL})")
    log(f"[18] kernels vs plain twins, the same collecting forward: max "
        f"|rate difference| {d_rate:.3g} over {len(rate_keys)} sites, max "
        f"membrane difference {d_mem:.3g} of the site's largest")
    # (a) K2 with h at every PSN shape of the collecting forward
    k2h = k2_membrane(torch, dev, sigs)
    busy_c = device_ms_per_call(torch, lambda: collect(chunk),
                                N_TELEMETRY_BUSY)
    busy_p = device_ms_per_call(torch, lambda: plain(chunk),
                                N_TELEMETRY_BUSY)
    log(f"[18] device busy per request: collecting {busy_c:.3f} ms, plain "
        f"{busy_p:.3f} ms ({card})")
    del collect, plain
    # (b) eval_dsec.main with the four flags, and without, bf16
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, model, torch.optim.SGD(model.parameters(),
                                                     lr=0.0), 0, 0)
        del model
        argv = ["--train_config", CONFIG, "--ckpt", ckpt, "--synthetic",
                "--bf16", "--max_batches", "2"]
        runs = {}
        for label, extra in (("flags", list(TELEMETRY_FLAGS)),
                             ("plain", [])):
            run_dir = os.path.join(tmp, label)
            runs[label] = eval_run(torch, E.main,
                                   argv + extra + ["--run_dir", run_dir])
            runs[label]["dir"] = run_dir
        rf, rp = runs["flags"], runs["plain"]
        missing = [n for n in TELEMETRY_ARTEFACTS
                   if not os.path.exists(os.path.join(rf["dir"], n))]
        check(not missing, f"eval_dsec --flags wrote no {missing}")
        # batch 0 collecting, batch 1 as usual, the log forward (the model's
        # float32, collecting) once, which re-runs each stage's last
        # attention (5 PSN sites) for its map
        n_stages = len(config["swin_transformer"]["swin_depths"])
        want_f = launches_of(K1=launches_p["K1"],
                             K2=2 * launches_c["K2"] + launches_p["K2"]
                             + 5 * n_stages)
        want_p = launches_of(K1=2 * launches_p["K1"],
                             K2=2 * launches_p["K2"])
        check(rf["launches"] == want_f and rp["launches"] == want_p,
              f"eval_dsec launches: flags {rf['launches']} (expected "
              f"{want_f}), plain {rp['launches']} (expected {want_p})")
        with open(os.path.join(rf["dir"], "spike_rates.json")) as f:
            rates = json.load(f)
        with open(os.path.join(rf["dir"], "membrane_stats.json")) as f:
            membrane = json.load(f)
        with open(os.path.join(rf["dir"], "energy.json")) as f:
            energy = json.load(f)
        maps = np.load(os.path.join(rf["dir"], "attention_maps.npz"))
        shapes = {k: list(maps[k].shape) for k in sorted(maps.files)}
        res = rf["results"]
        check(len(rates) == len(membrane) == len(rate_keys)
              and len(shapes) == 4
              and all(np.isfinite(res[k]) for k in
                      ("mean_firing_rate", "energy_mj", "snn_vs_ann_ratio"))
              and res["energy_mj"] == energy["energy_mj"]
              and 0.0 < res["snn_vs_ann_ratio"] < 1.0,
              f"eval_dsec artefacts: {len(rates)} rates, {len(membrane)} "
              f"membranes, maps {shapes}, results {res}")
    tel = dict(
        card=card, collecting_launches=launches_c,
        plain_launches=launches_p, n_sites=len(rate_keys),
        rates=rate_stats(rates.values()),
        mean_firing_rate=res["mean_firing_rate"],
        energy_mj=res["energy_mj"], snn_vs_ann_ratio=res["snn_vs_ann_ratio"],
        attention_shapes=shapes,
        windows_per_s={"flags": rf["windows_per_s"],
                       "plain": rp["windows_per_s"]},
        main_s={"flags": rf["main_s"], "plain": rp["main_s"]},
        eval_launches={"flags": rf["launches"], "plain": rp["launches"]},
        device_ms_per_request={"collecting": busy_c, "plain": busy_p},
        twin_max_rate_diff=d_rate, twin_max_membrane_rel_diff=d_mem,
        flow_collecting_vs_plain=d_flow, k2_h=k2h,
        aee={"flags": rf["results"]["AEE"], "plain": rp["results"]["AEE"]})
    log(f"[18] eval_dsec.main, en4 bf16 288x384, 2 synthetic windows, "
        f"{' '.join(TELEMETRY_FLAGS)}: {len(rates)} sites, rates "
        f"{tel['rates']}, mean_firing_rate {res['mean_firing_rate']:.5f}, "
        f"energy {res['energy_mj']:.4f} mJ, {res['snn_vs_ann_ratio']:.4f}x "
        f"ANN; attention maps {shapes}; windows/s {rf['windows_per_s']:.2f} "
        f"(without the flags {rp['windows_per_s']:.2f}); main "
        f"{rf['main_s']:.1f} s ({rp['main_s']:.1f} s)")
    log(f"[18] phase 18: {time.perf_counter() - t_phase:.1f} s")
    return tel


# ----------------------------------------------------------- phase 19
# data parallelism: the en4 float32 step of a global batch of 2 over two
# gloo ranks on the one card (one row each) against one process taking
# the batch of 2; the trainer under torchrun (one rank, NCCL) against the
# plain trainer; FlowServer batching queued requests over two entries of
# the one card

DP_WORLD = 2
DP_TIMED_STEPS = 3        # timed DP steps after the checked and counted ones
DP_TIMEOUT_S = 600
DP_TRAIN_STEPS = 4        # train_dsec --max_steps of the torchrun A/B
# SGD: an update moves each parameter by lr x its (momentum) gradient, so
# the post-step parameters compare the gradients
DP_OPT = dict(name="SGD", lr=1e-3, scheduler="constant", clip_grad=100.0)
# the one-process step is taken with the DP step's spikes at every neuron
# call (see forced_spikes), so that only the float32 summation order
# differs: its loss, relative
DP_LOSS_TOL = 1e-4
# the largest difference of a parameter's move over the largest move, and
# of a running statistic over its largest value
DP_DELTA_TOL = 1e-3
DP_STATS_TOL = 1e-4
DP_PSN_SITES = 93         # K2 and K2b launches of an en4 train step
DP_COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "barrier")
# deterministic kernels for a bit-for-bit comparison of two trainer runs:
# cuDNN's deterministic algorithms and a sorted index_add (the nearest
# upsample's backward); the trainer module itself runs as __main__
DETERMINISTIC_TRAINER = r"""
import runpy, sys, warnings
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
warnings.simplefilter("once")
sys.argv = ["train_dsec"] + sys.argv[1:]
runpy.run_module("sdformerflow_tpu_torch.train_dsec", run_name="__main__")
"""


class CollectiveLog:
    """While entered, every ``torch.distributed`` collective of the
    process is counted and timed (host clock, a device sync either side),
    by name."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        import torch.distributed as dist
        self.saved = {n: getattr(dist, n) for n in DP_COLLECTIVES}

        def wrap(name, fn):
            def timed(*args, **kw):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                self.torch.cuda.synchronize()
                t = next((a for a in args if hasattr(a, "numel")), None)
                self.calls.append((name, (time.perf_counter() - t0) * 1e3,
                                   0 if t is None
                                   else t.numel() * t.element_size()))
                return out
            return timed
        for name, fn in self.saved.items():
            setattr(dist, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)

    def summary(self):
        out = {}
        for name, ms, nbytes_ in self.calls:
            c = out.setdefault(name, {"count": 0, "ms": 0.0, "bytes": 0})
            c["count"] += 1
            c["ms"] += ms
            c["bytes"] += nbytes_
        return out


def spike_record(model, store):
    """Forward hooks that append each neuron call's spikes (output != 0,
    bool, on the device) to ``store``; returns the handles."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    return [m.register_forward_hook(
        lambda mod, args, out: store.append(out.detach() != 0))
        for m in model.modules() if isinstance(m, SpikingNeuron)]


def rank_spikes(torch, spikes, group, world):
    """Every rank's recorded spikes on the host, ``[rank][call]`` bool
    tensors: one all-gather of each rank's calls packed as bytes (every
    rank records calls of the same shapes)."""
    import torch.distributed as dist
    flat = torch.cat([s.reshape(-1) for s in spikes]).to(torch.uint8).cpu()
    parts = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(parts, flat, group=group)
    out = []
    for part in parts:
        calls, at = [], 0
        for s in spikes:
            calls.append(part[at:at + s.numel()].view(s.shape).bool())
            at += s.numel()
        out.append(calls)
    return out


def forced_spikes(torch, model, records, sites):
    """Forward hooks that give each neuron call of ``model`` (one process,
    the global batch) the DP run's spikes at that call: the ranks' rows
    (``records[rank][call]``) joined on the batch axis, or rank 0's where
    each rank computed the whole batch (the gathered attention). The
    gradient still flows through the neuron's own surrogate (straight
    through), so the step differs from the DP step by the float32
    summation order alone, and a wrong gradient reduction shows in the
    parameters' moves. Each call's (flipped, spikes, shape) of its own
    spikes against the DP run's goes to ``sites``. Returns the handles."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    world = len(records)

    def hook(mod, args, out):
        i = len(sites)
        check(i < len(records[0]), f"the one-process step fires more than "
              f"the DP step's {len(records[0])} neuron calls")
        parts = [rec[i] for rec in records]
        if parts[0].shape == out.shape:
            want = parts[0]
        else:
            axes = [a for a, (p, o) in enumerate(zip(parts[0].shape,
                                                     out.shape)) if p != o]
            check(len(axes) == 1 and parts[0].dim() == out.dim()
                  and parts[0].shape[axes[0]] * world == out.shape[axes[0]],
                  f"neuron call {i}: the DP run's spikes "
                  f"{tuple(parts[0].shape)} against {tuple(out.shape)}")
            want = torch.cat(parts, axes[0])
        want = want.to(out.device)
        own = out.detach() != 0
        check(torch.equal(out.detach(), own.to(out.dtype)),
              f"neuron call {i} fires values other than 0 and 1")
        sites.append((int((own != want).sum()), own.numel(), list(out.shape)))
        return want.to(out.dtype) + (out - out.detach())
    return [m.register_forward_hook(hook) for m in model.modules()
            if isinstance(m, SpikingNeuron)]


def checked_psn(P, flips, errs):
    """PSNImpl that launches K2 and K2b and holds each launch against its
    plain twin on the same input: K2's flipped spikes, K2b's largest |d|
    over the twin's largest |value| per output."""
    def fwd(x, w, b, *, scale=None, shift=None, **kw):
        y = P.fused_affine_psn(x, w, b, scale=scale, shift=shift)
        want = P.psn_spike(x, w, b, scale=scale, shift=shift)
        flips[0] += int((y != want).sum())
        flips[1] += y.numel()
        return y

    def bwd(x, g, w, b, **kw):
        got = P.fused_psn_backward(x, g, w, b, **kw)
        for name, e in k2b_errors(got, P.psn_backward_plain(
                x, g, w, b, **kw)).items():
            errs[name] = max(errs.get(name, 0.0), e)
        return got
    return P.PSNImpl(fwd, bwd)


def dp_trainer(torch, dev, config, state_dict, group, **step_kw):
    """(model, optimizer, train step) of the en4 config in float32 with
    DP_OPT and ``group`` (and ``step_kw`` for the step)."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.optim import build_optimizer
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    model_cfg, swin, cfg = build_configs(config)
    model = get_model(config["model"]["name"], model_cfg, swin, cfg,
                      train=True)
    model.load_state_dict(state_dict)
    model.float().to(dev)
    opt = build_optimizer(model.named_parameters(), **DP_OPT)
    step = make_train_step(model, opt,
                           norm_input=config["model"]["norm_input"],
                           generator=torch.Generator(dev).manual_seed(SEED),
                           group=group, **step_kw)
    return model, opt, step


def dp_rank_work(torch, dev, rank, world, config, state_dict, hw):
    """One rank's share of phase 19's DP step, checked against one process
    on the same card (which this rank runs too, on the whole batch)."""
    import functools
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.parallel import multihost
    group = multihost.world_group()
    batch = train_batch(torch, dev, hw, SEED + 40, batch=world)
    rows = {k: v[rank:rank + 1] for k, v in batch.items()}
    start = {k: v.to(dev) for k, v in state_dict.items()}

    # the checked DP step: K2 / K2b against their twins, spikes recorded
    model, opt, step = dp_trainer(torch, dev, config, state_dict, group)
    dp_spikes, k2_flips, k2b_errs = [], [0, 0], {}
    handles = spike_record(model, dp_spikes)
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    impl = checked_psn(P, k2_flips, k2b_errs)
    with site_functions(functools.partial(P.affine_psn, impl=impl)):
        dp_loss = step(rows)["loss"].item()
    launches = {"K2": P.fused_affine_psn.launches,
                "K2b": P.fused_psn_backward.launches}
    for h in handles:
        h.remove()
    n_calls = len(dp_spikes)
    after_dp = {k: v.detach().clone() for k, v in model.state_dict().items()}
    records = rank_spikes(torch, dp_spikes, group, world)
    del dp_spikes

    # the counted step: the collectives and their time
    with CollectiveLog(torch) as coll:
        step(rows)
    collectives = coll.summary()
    # the timed steps, the card's busy time and the peak memory
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(DP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(rows)["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy = device_ms_per_call(torch, lambda: step(rows), 1,
                              f"smoke_dp_rank{rank}_trace")
    del model, opt, step
    torch.cuda.empty_cache()

    # one process on the whole batch, from the same state, its neurons
    # given the DP step's spikes
    model, opt, step = dp_trainer(torch, dev, config, state_dict, None)
    site = []
    handles = forced_spikes(torch, model, records, site)
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    one_loss = step(batch)["loss"].item()
    one_launches = {"K2": P.fused_affine_psn.launches,
                    "K2b": P.fused_psn_backward.launches}
    for h in handles:
        h.remove()
    after_one = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, opt, step, records
    check(len(site) == n_calls > 0,
          f"rank {rank}: {n_calls} neuron calls in the DP step against "
          f"{len(site)} in one process")
    flipped, total = sum(s[0] for s in site), sum(s[1] for s in site)
    first = [[i] + list(s) for i, s in enumerate(site) if s[0]][:6]

    def moved(after):
        return {k: after[k].double() - start[k].double() for k in start
                if after[k].is_floating_point()}
    d_dp, d_one = moved(after_dp), moved(after_one)
    params = [k for k in d_one if not k.endswith(("running_mean",
                                                  "running_var"))]
    top = max(d_one[k].abs().max().item() for k in params)
    delta_rel = max((d_dp[k] - d_one[k]).abs().max().item()
                    for k in params) / max(top, 1e-300)
    stats_rel = max(rel_err(after_dp[k], after_one[k])[1] for k in start
                    if k.endswith(("running_mean", "running_var")))
    torch.cuda.empty_cache()
    return dict(
        rank=rank, loss=dp_loss, one_process_loss=one_loss,
        loss_rel=abs(dp_loss - one_loss) / max(abs(one_loss), 1e-300),
        spikes_flipped=flipped, spikes=total, spike_sites=len(site),
        sites_with_flips=sum(s[0] > 0 for s in site), first_flips=first,
        param_delta_rel=delta_rel, running_stats_rel=stats_rel,
        launches=launches, one_process_launches=one_launches,
        k2_twin_flips=k2_flips, k2b_twin_err=k2b_errs,
        collectives=collectives, step_ms=ms,
        p50_ms=float(np.percentile(ms, 50)), device_ms=busy,
        peak_mem_gib=peak)


def run_rank(index, world, out_dir, config_path, hw, work):
    """A spawned rank (``torch.multiprocessing``): joins the gloo group
    through a file in ``out_dir`` on ``cuda:0`` (two ranks on one card:
    NCCL refuses that), runs ``work`` and writes its results there."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sdformerflow_tpu_torch.parallel import multihost
    from sdformerflow_tpu_torch.training.config import load_config
    out = os.path.join(out_dir, f"rank{index}.json")
    try:
        multihost.initialize(backend="gloo",
                             init_method=f"file://{out_dir}/rendezvous",
                             world_size=world, rank=index,
                             timeout_s=DP_TIMEOUT_S)
        dev = multihost.local_device("cuda:0")
        multihost.establish_collectives(multihost.world_group())
        _, state_dict = load_en4(torch)
        res = work(torch, dev, index, world, load_config(config_path),
                   state_dict, hw)
        res["foreign_modules"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "sdformerflow_tpu"))
        with open(out, "w") as f:
            json.dump(res, f)
    except BaseException as e:
        with open(out + ".err", "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise
    finally:
        multihost.leave()


def dp_rank(index, world, out_dir, config_path, hw):
    """A spawned rank of phase 19's DP step (:func:`dp_rank_work`)."""
    run_rank(index, world, out_dir, config_path, hw, dp_rank_work)


def spawn_ranks(target, world, name, hw):
    """Run ``target(index, world, out_dir, CONFIG, hw)`` on ``world``
    spawned ranks (out_dir ``_build/<name>``), killing them after
    DP_TIMEOUT_S; a rank that fails fails the run. Returns (seconds with
    start-up, each rank's results)."""
    import shutil
    import torch.multiprocessing as mp
    out_dir = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build", name)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    ctx = mp.start_processes(target, args=(world, out_dir, CONFIG, hw),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + DP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise SmokeFailure(f"the {name} ranks did not finish in "
                                   f"{DP_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errs = [open(os.path.join(out_dir, n)).read()
                for n in sorted(os.listdir(out_dir)) if n.endswith(".err")]
        raise SmokeFailure(f"a {name} rank failed: {errs or e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(30)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return wall, ranks


def dp_step(torch, card):
    """The two-rank en4 DDP step against one process (see dp_rank_work)."""
    wall, ranks = spawn_ranks(dp_rank, DP_WORLD, "smoke_dp", TRAIN_HW)
    coll = ranks[0]["collectives"]
    log(f"[19] en4 DDP step, float32 (TF32 off), global batch {DP_WORLD} "
        f"at {TRAIN_HW[0]}x{TRAIN_HW[1]}, one row a rank, {DP_WORLD} gloo "
        f"ranks on cuda:0 ({wall:.1f} s with start-up), against one process "
        f"at batch {DP_WORLD} on the same card given the DP step's spikes at "
        f"every neuron call, on {card}:")
    for r in ranks:
        log(f"[19]   rank {r['rank']}: loss {r['loss']:.7g} (one process "
            f"{r['one_process_loss']:.7g}, rel {r['loss_rel']:.2e}); the "
            f"one process's own spikes differ from the DP step's at "
            f"{r['spikes_flipped']} of {r['spikes']} ({r['sites_with_flips']}"
            f" of {r['spike_sites']} neuron calls); parameter moves "
            f"{r['param_delta_rel']:.2e} of the largest away, running "
            f"statistics {r['running_stats_rel']:.2e}; K2 "
            f"{r['launches']['K2']}, K2b {r['launches']['K2b']} launches a "
            f"step (one process {r['one_process_launches']['K2']}, "
            f"{r['one_process_launches']['K2b']}), K2 flipped "
            f"{r['k2_twin_flips'][0]} of {r['k2_twin_flips'][1]} against its "
            f"twin, K2b largest |d| / twin's largest "
            f"{max(r['k2b_twin_err'].values()):.2e}; step p50 "
            f"{r['p50_ms']:.1f} ms ({DP_TIMED_STEPS} steps: "
            + ", ".join(f"{v:.1f}" for v in r["step_ms"])
            + f"), device busy " + ("not measured" if r["device_ms"] is None
                                    else f"{r['device_ms']:.1f} ms")
            + f", peak {r['peak_mem_gib']:.2f} GiB; the first neuron calls "
            f"with a flip [call, flipped, spikes, shape]: {r['first_flips']}")
    log(f"[19]   collectives a step (rank 0; host clock with a sync either "
        f"side, in a separate step): " + ", ".join(
            f"{k} {v['count']} ({v['ms']:.1f} ms, {v['bytes'] / 2 ** 20:.1f}"
            f" MiB)" for k, v in sorted(coll.items())) + f" [{card}]")
    for r in ranks:
        rk = r["rank"]
        check(r["foreign_modules"] == [], f"rank {rk} imported "
              f"{r['foreign_modules']}")
        want = {"K2": DP_PSN_SITES, "K2b": DP_PSN_SITES}
        check(r["launches"] == want and r["one_process_launches"] == want,
              f"rank {rk}: DP step launches {r['launches']}, one process "
              f"{r['one_process_launches']}, expected {want}")
        check(r["spikes_flipped"] <= MAX_FLIP_SHARE * r["spikes"],
              f"rank {rk}: {r['spikes_flipped']} of {r['spikes']} spikes "
              f"of one process differ from the DP step's")
        check(r["loss_rel"] <= DP_LOSS_TOL,
              f"rank {rk}: the DP loss {r['loss']} against one process's "
              f"{r['one_process_loss']} (rel {r['loss_rel']:.3g})")
        check(r["param_delta_rel"] <= DP_DELTA_TOL,
              f"rank {rk}: the parameters moved {r['param_delta_rel']:.3g} "
              "of the largest move away from one process's moves")
        check(r["running_stats_rel"] <= DP_STATS_TOL,
              f"rank {rk}: the running statistics "
              f"{r['running_stats_rel']:.3g} away from one process's")
        f, n = r["k2_twin_flips"]
        check(n > 0 and f <= MAX_FLIP_SHARE * n,
              f"rank {rk}: K2 flipped {f} of {n} spikes against its twin")
        check(r["k2b_twin_err"].get("dx", 1.0) <= K2B_TOL,
              f"rank {rk}: K2b against its twin {r['k2b_twin_err']}")
    check(ranks[0]["loss"] == ranks[1]["loss"],
          f"the ranks' global losses differ: {[r['loss'] for r in ranks]}")
    return dict(ranks=ranks, wall_s=wall, world=DP_WORLD)


def torchrun_ab(torch, card):
    """``train_dsec --synthetic --max_steps 4`` on the en4 config twice,
    at once: plainly and under ``torch.distributed.run`` (one rank,
    NCCL); both with deterministic kernels. Their metrics.jsonl (all but
    the clocks) and checkpoints must be equal bit for bit."""
    import shutil
    base = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                        "smoke_torchrun")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    launcher = os.path.join(base, "deterministic_train_dsec.py")
    with open(launcher, "w") as f:
        f.write(DETERMINISTIC_TRAINER)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    args = ["--config", CONFIG, "--synthetic", "--max_steps",
            str(DP_TRAIN_STEPS), "--run_dir"]
    cmds = {"plain": [sys.executable, launcher] + args + [
                os.path.join(base, "plain")],
            "torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--standalone", "--nproc_per_node", "1", launcher]
            + args + [os.path.join(base, "torchrun")]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, c in cmds.items()}
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(timeout=DP_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
    wall = time.perf_counter() - t0
    for k, p in procs.items():
        check(p.returncode == 0, f"{k} trainer exit {p.returncode}: "
              + outs[k][-3000:])
    runs = {}
    for k in cmds:
        d = os.path.join(base, k)
        with open(os.path.join(d, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        with open(os.path.join(d, "model_info.json")) as f:
            info = json.load(f)
        runs[k] = dict(values=[(r["name"], r["step"], r["value"])
                               for r in recs
                               if r["name"] in ("train_loss", "valid_loss",
                                                "skipped_updates")],
                       info=info,
                       ckpt=torch.load(os.path.join(d, "ckpt",
                                                    "epoch_000000.pt"),
                                       map_location="cpu",
                                       weights_only=True))
    check(runs["torchrun"]["info"]["backend"] == "nccl"
          and runs["torchrun"]["info"]["processes"] == 1
          and runs["plain"]["info"]["backend"] is None,
          f"model_info: {runs['torchrun']['info']}, {runs['plain']['info']}")
    a, b = runs["plain"], runs["torchrun"]
    check(a["values"] and a["values"] == b["values"],
          f"metrics.jsonl differ: {a['values']} against {b['values']}")
    sd_a, sd_b = a["ckpt"]["model"], b["ckpt"]["model"]
    same_model = all(torch.equal(v, sd_b[k]) for k, v in sd_a.items())
    check(same_model and a["ckpt"]["step"] == b["ckpt"]["step"],
          "the two trainers' checkpoints differ")
    warned = [ln for ln in outs["plain"].splitlines()
              if "deterministic" in ln.lower()][:3]
    log(f"[19] train_dsec --synthetic --max_steps {DP_TRAIN_STEPS} (en4, "
        "deterministic kernels) plainly and under torch.distributed.run "
        f"--nproc_per_node 1 (backend {b['info']['backend']}), at once, "
        f"{wall:.1f} s: metrics.jsonl equal bit for bit ("
        + ", ".join(f"{n}[{s}] {v!r}" for n, s, v in a["values"])
        + f"), checkpoints equal bit for bit; warnings {warned} [{card}]")
    return dict(values=a["values"], seconds=wall,
                backend=b["info"]["backend"])


def dp_serving(torch, dev, config, state_dict, card):
    """FlowServer(devices=[cuda:0] * 2) on en4 bf16: queued voxel and
    events requests coalesced two a batch, each flow against batch-1
    serving (every spike of a batched forward against the batch-1
    forwards' of its rows), launches a batched forward, windows/s beside
    devices=None."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.ops import hopper_voxel as V
    from sdformerflow_tpu_torch.serving import FlowServer
    from sdformerflow_tpu_torch.training.train_step import voxelize_batch
    hw = tuple(config["loader"]["crop"])
    voxels = voxel_requests(N_QUEUED, 10, hw, SEED + 60)
    windows = event_windows(8, 0.6, 1.0, SEED + 61)
    out = {}
    with FlowServer(config, state_dict, device=dev, bf16=True) as one, \
            FlowServer(config, state_dict, device=dev, bf16=True,
                       devices=[dev] * 2, max_pending=2 * N_QUEUED,
                       batch_window_s=0.05) as batched:
        for s in (one, batched):
            s.warmup(K3_EVENTS)
        pair0 = batched_pair(torch, dev, batched, one, voxels[:2])
        check(pair0["spikes"] > 0
              and pair0["flipped"] <= MAX_FLIP_SHARE * pair0["spikes"],
              f"batched serving flipped {pair0['flipped']} of "
              f"{pair0['spikes']} spikes against batch-1 serving")
        # K3 a row of an events group, against its plain twin
        buf = torch.cat([batched.pack_events(w) for w in windows[:2]])
        ev = {k: buf[:, i] for i, k in enumerate("xytp")}
        ev["valid"] = buf[:, 4] != 0
        vox_kw = dict(num_bins=10, height=SENSOR[0], width=SENSOR[1])
        k3_before = V.voxel_k3.launches
        grid = voxelize_batch({k: v.to(dev) for k, v in ev.items()},
                              **vox_kw)
        check(V.voxel_k3.launches == k3_before + 2,
              f"K3 launched {V.voxel_k3.launches - k3_before} times for 2 "
              "rows")
        k3_err = (grid.cpu() - voxelize_batch(ev, **vox_kw)).abs().max()
        check(float(k3_err) <= 1e-4, f"K3 against its twin: {k3_err}")
        # queued requests: windows/s, launches a batched forward, flows
        for label, server in (("devices=None", one),
                              (f"devices=[{dev}] * 2", batched)):
            for kind, reqs in (("voxel", voxels), ("events", windows * 8)):
                A.qk_attn_interior.launches = 0
                P.fused_affine_psn.launches = V.voxel_k3.launches = 0
                t0 = time.perf_counter()
                futs = [server.submit(r) for r in reqs]
                flows = [f.result(timeout=600) for f in futs]
                wall = time.perf_counter() - t0
                counts = dict(K1=A.qk_attn_interior.launches,
                              K2=P.fused_affine_psn.launches,
                              K3=V.voxel_k3.launches)
                for fl in flows:
                    check(fl.shape == (2,) + hw and np.isfinite(fl).all(),
                          f"{label} {kind}: flow {fl.shape}")
                out.setdefault(label, {})[kind] = dict(
                    requests=len(reqs), windows_per_s=len(reqs) / wall,
                    launches=counts, flows=flows)
        plain, bat = out["devices=None"], out[f"devices=[{dev}] * 2"]
        n_vox, n_ev = len(voxels), len(windows) * 8
        forwards = {"voxel": n_vox // 2, "events": n_ev // 2}
        for kind, n in forwards.items():
            c = bat[kind]["launches"]
            check(c["K1"] == 12 * n and c["K2"] == 45 * n,
                  f"batched {kind}: {c} for {n} forwards of 2 rows")
        check(bat["events"]["launches"]["K3"] == n_ev,
              f"batched events: K3 {bat['events']['launches']['K3']} for "
              f"{n_ev} rows")
        epe = {kind: [float(np.sqrt(((a - b) ** 2).sum(0)).mean())
                      for a, b in zip(bat[kind]["flows"],
                                      plain[kind]["flows"])]
               for kind in forwards}
        # a queued voxel request whose flow is not its batch-1 flow: its
        # pair (the groups are queued pairs) again, spike by spike; the
        # forward is chaotic, so the first differing call is held to the
        # rounding rule
        redo = {}
        for i in sorted({i // 2 for i, e in enumerate(epe["voxel"]) if e}):
            r = batched_pair(torch, dev, batched, one,
                             voxels[2 * i:2 * i + 2])
            rows = r.pop("batched_rows")
            r["queued_equal_direct"] = [
                bool(np.array_equal(bat["voxel"]["flows"][2 * i + k],
                                    rows[k])) for k in (0, 1)]
            redo[f"requests {2 * i}, {2 * i + 1}"] = r
            if r["flipped"]:
                _, f, n, shape = r["first_flip"]
                check(f <= MAX_FLIP_SHARE * n,
                      f"queued pair {i}: the first differing neuron call "
                      f"{shape} flipped {f} of {n} spikes against batch-1")
        same = {kind: sum(e == 0.0 for e in v) for kind, v in epe.items()}
        epe = {kind: float(np.mean(v)) for kind, v in epe.items()}
        scale = float(np.mean([np.abs(f).mean()
                               for f in plain["voxel"]["flows"]]))
        for d in (plain, bat):
            for v in d.values():
                v.pop("flows")
    log(f"[19] FlowServer(devices=[{dev}] * 2), en4 bf16 at {hw[0]}x{hw[1]}: "
        f"a batched forward's spikes against its rows' batch-1 forwards: "
        f"{pair0['flipped']} of {pair0['spikes']} flipped (K1 and K2 "
        f"outputs); K3 a row "
        f"of an events group against its twin {float(k3_err):.2e}; "
        f"launches a batched forward of 2 rows: voxel "
        f"{bat['voxel']['launches']} over {forwards['voxel']}, events "
        f"{bat['events']['launches']} over {forwards['events']}; the "
        f"checked pair's flows against batch-1: max |d| "
        f"{pair0['max_abs_diff']:.3g}; the queued flows against "
        f"devices=None: mean EPE {epe}, equal bit for bit {same} of {n_vox}"
        f" / {n_ev} (mean |flow| {scale:.3g}); the pairs of the voxel "
        f"requests that differ, again spike by spike: {redo} [{card}]")
    for label, d in out.items():
        log(f"[19]   {label}: " + "; ".join(
            f"{k} {v['requests']} queued, {v['windows_per_s']:.2f} "
            f"windows/s, launches {v['launches']}" for k, v in d.items()))
    pair0.pop("batched_rows")
    return dict(servers=out, checked_pair=pair0,
                k3_max_abs_err=float(k3_err), epe_vs_batch1=epe,
                bitwise_equal_flows=same, mean_abs_flow=scale,
                differing_pairs=redo)


def batched_pair(torch, dev, batched, one, pair):
    """Two voxel requests through the batched server's step as one batch
    and through the one-request server's step one by one, every K1 and K2
    output recorded: the spikes flipped (in all, and at the first call
    that differs: [call, flipped, spikes, shape]), the flows' largest
    |d| and the batched rows' flows."""
    from sdformerflow_tpu_torch.ops import hopper_attn as A
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    records = {}

    def recorder(key):
        def psn(x, w, b, *, scale=None, shift=None, **_):
            y = P.fused_affine_psn(x, w, b, scale=scale, shift=shift)
            records.setdefault(key, []).append(y)
            return y

        def attend(x, p, nh):
            a = A.qk_attn_interior(x, p, nh)
            records.setdefault(key, []).append(a)
            return A.qk_attn_tail(a, p, nh, x.shape, x.dtype)
        return psn, attend
    pair = np.stack(pair)
    with torch.inference_mode():
        with site_functions(*recorder("batched")):
            fb = batched._step(torch.from_numpy(pair).to(dev))[-1]
        f1 = []
        for r in range(2):
            with site_functions(*recorder(r)):
                f1.append(one._step(
                    torch.from_numpy(pair[r:r + 1]).to(dev))[-1])
    check(len(records["batched"]) == len(records[0]),
          f"{len(records['batched'])} sites batched, {len(records[0])} at "
          "batch 1")
    flipped = total = 0
    first = None
    for i, y in enumerate(records["batched"]):
        for r in range(2):
            want = records[r][i]
            if y.shape[1] == 2 * want.shape[1] and y.dim() == 4:
                m = want.shape[1]   # K1: the rows' windows stacked
                got = y[:, r * m:(r + 1) * m]
            else:                   # K2: time-major [T, B, ...]
                got = y[:, r:r + 1]
            f = int((got != want).sum())
            if f and first is None:
                first = [i, f, want.numel(), list(want.shape)]
            flipped += f
            total += want.numel()
    return dict(flipped=flipped, spikes=total, first_flip=first,
                max_abs_diff=float((fb - torch.cat(f1)).abs().max()),
                batched_rows=[f.float().cpu().numpy() for f in fb])


def phase_dp(torch, dev, config, state_dict, card):
    t_phase = time.perf_counter()
    serving = dp_serving(torch, dev, config, state_dict, card)
    torch.cuda.empty_cache()
    step = dp_step(torch, card)
    trainer = torchrun_ab(torch, card)
    phase_s = time.perf_counter() - t_phase
    log(f"[19] phase 19: {phase_s:.1f} s")
    return dict(step=step, torchrun=trainer, serving=serving,
                phase_s=phase_s)


# ----------------------------------------------------------- phase 20
# the raw-data preparation: preprocess_dsec and encode_mvsec on raw trees
# the port's own HDF5 writer makes here (the card's host has no h5py),
# chained into eval_dsec and eval_mvsec

PREP_WINDOWS = 3               # DSEC GT windows of 100 ms (flow at 10 Hz)
PREP_WINDOW_US = 100_000
PREP_CHUNK_ROWS = 1 << 16      # events a chunk of events/{p,x,y,t}
PREP_DEFLATE = 4               # the zlib level of every chunked dataset
PREP_EDGE = 0.05               # the share of events on the sensor's edges
PREP_K3_TOL = 1e-4             # K3 against its twin: K3's bound (phase 4)
PREP_EVAL_BATCHES = 2
MVSEC_PREP_SEQ = "indoor_flying4"   # its valid range starts at frame 196
MVSEC_PREP_FRAMES = 212        # image frames: frame 198 + dt4 + 8 past it
MVSEC_PREP_EVENTS = 1 << 13    # events an image frame (~32 ms)
MVSEC_GT_S = 0.05              # the distorted GT flow at 20 Hz


def rectify_map(rng):
    """A DSEC rectify map [480, 640, 2] that is not the identity: x' =
    1.004 x - 0.6 plus a wave of 0.3 px and 0.05 px of jitter, y' alike.
    The first column and row land in (-1, 0), where truncation toward zero
    gives the corner past them a negative weight; the last ones land at
    640 / 480 and past, outside the grid."""
    h, w = SENSOR
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    rx = 1.004 * gx - 0.6 + 0.3 * np.sin(gy / 37.0)
    ry = 1.005 * gy - 0.55 + 0.3 * np.cos(gx / 41.0)
    return (np.stack([rx, ry], -1)
            + rng.uniform(-0.05, 0.05, (h, w, 2))).astype(np.float32)


def write_raw_dsec(torch, root, seq, rng):
    """A raw DSEC sequence at 480x640 (``train_events/<seq>/events/left``
    and ``train_optical_flow/<seq>/flow``) by the port's HDF5 writer:
    ``events.h5`` with ``events/{p,x,y,t}`` in DSEC's dtypes (u8, u16, u16,
    i64 us from ``t_offset``), ``ms_to_idx`` (u64) and ``t_offset``,
    chunked (``PREP_CHUNK_ROWS``) with shuffle and deflate; PREP_WINDOWS GT
    windows of 0.6-1.0 x 2^20 events on 45% of the frame plus PREP_EDGE on
    its first and last columns and rows; ``rectify_map.h5``
    (:func:`rectify_map`); a 16-bit RGB flow PNG a window (a smooth field of
    up to 14 px, ~70% valid) and ``forward_timestamps.txt``. Returns the
    events a window, the GT flows and masks as the PNGs hold them, and the
    files' bytes."""
    import torch.nn.functional as F
    from sdformerflow_tpu_torch.data import hdf5
    from sdformerflow_tpu_torch.utils.visualization import write_png
    h, w = SENSOR
    counts, parts = [], []
    for i in range(PREP_WINDOWS):
        m = int(rng.uniform(0.6, 1.0) * K3_EVENTS)
        idx = rng.choice(active_pixels(torch, rng), m)
        x, y = (idx % w).astype(np.uint16), (idx // w).astype(np.uint16)
        for a, n in ((x, w), (y, h)):
            edge = rng.random(m) < PREP_EDGE
            a[edge] = rng.choice([0, n - 1], int(edge.sum()))
        t = np.sort(rng.integers(i * PREP_WINDOW_US, (i + 1) * PREP_WINDOW_US,
                                 m)).astype(np.int64)
        parts.append((x, y, t, rng.integers(0, 2, m).astype(np.uint8)))
        counts.append(m)
    x, y, t, p = (np.concatenate(a) for a in zip(*parts))
    ms = np.arange(PREP_WINDOWS * PREP_WINDOW_US // 1000 + 1) * 1000
    ev_dir = os.path.join(root, "train_events", seq, "events", "left")
    flow_dir = os.path.join(root, "train_optical_flow", seq, "flow")
    os.makedirs(ev_dir)
    os.makedirs(os.path.join(flow_dir, "forward"))
    events = os.path.join(ev_dir, "events.h5")
    hdf5.write(events, {"events": {"p": p, "x": x, "y": y, "t": t},
                        "ms_to_idx": np.searchsorted(t, ms).astype(np.uint64),
                        "t_offset": np.int64(DSEC_T0_US)},
               chunks=PREP_CHUNK_ROWS, deflate=PREP_DEFLATE, shuffle=True)
    hdf5.write(os.path.join(ev_dir, "rectify_map.h5"),
               {"rectify_map": rectify_map(rng)})
    bounds = DSEC_T0_US + PREP_WINDOW_US * np.arange(PREP_WINDOWS + 1)
    np.savetxt(os.path.join(flow_dir, "forward_timestamps.txt"),
               np.stack([bounds[:-1], bounds[1:]], 1), delimiter=",",
               fmt="%d")
    flows, masks = [], []
    for i in range(PREP_WINDOWS):
        coarse = torch.from_numpy(rng.uniform(-14.0, 14.0, (1, 2, 7, 9)))
        flow = F.interpolate(coarse, size=(h, w), mode="bilinear",
                             align_corners=True)[0].numpy()
        png = np.empty((h, w, 3), np.uint16)
        png[..., :2] = np.rint(flow * 128 + 2 ** 15).transpose(1, 2, 0)
        png[..., 2] = rng.random((h, w)) < 0.7
        write_png(os.path.join(flow_dir, "forward", f"{i:06d}.png"), png)
        flows.append(((png[..., :2].astype(float) - 2 ** 15) / 128.0)
                     .transpose(2, 0, 1).astype(np.float32))
        masks.append(png[..., 2].astype(bool))
    with hdf5.File(events) as f:
        ds = f["events/t"]
        check(len(ds.chunk_index()) == -(-len(t) // PREP_CHUNK_ROWS)
              and np.array_equal(ds[()], t)
              and np.array_equal(f["events/x"][()], x),
              f"[20] {events}: the port's reader does not give back what "
              f"its writer wrote")
    raw = nbytes_np(x, y, t, p)
    return dict(counts=counts, flows=flows, masks=masks,
                events_h5_bytes=os.path.getsize(events), events_raw_bytes=raw)


def nbytes_np(*arrays):
    return int(sum(a.nbytes for a in arrays))


def write_raw_mvsec(root, seq, rng):
    """A raw MVSEC sequence at 260x346 by the port's HDF5 writer:
    ``<seq>_data.hdf5`` with ``davis/left/events`` (x, y, ts, p rows,
    float64, MVSEC_PREP_EVENTS a ~32 ms image frame, p in {-1, 1}),
    ``image_raw`` (u8 frames, which encode_mvsec never reads),
    ``image_raw_event_inds`` and ``image_raw_ts``, chunked with deflate
    (the timestamps contiguous); ``<seq>_gt.hdf5`` with
    ``davis/left/flow_dist`` ([M, 2, H, W] float32 at 20 Hz: a smooth
    field of up to 8 px, chunked a frame with shuffle and deflate) and
    ``flow_dist_ts``. Returns the rows, frame indices and the bytes."""
    from sdformerflow_tpu_torch.data import hdf5
    h, w = MDR_SENSOR
    n = MVSEC_PREP_FRAMES
    ts = 1.5e9 + 0.032 * np.arange(n) + rng.uniform(0, 1e-3, n)
    m = MVSEC_PREP_EVENTS * n
    t = np.sort(rng.uniform(ts[0] - 0.032, ts[-1], m))
    raw = np.stack([rng.integers(0, w, m), rng.integers(0, h, m), t,
                    rng.choice([-1.0, 1.0], m)], 1).astype(np.float64)
    inds = np.searchsorted(t, ts).astype(np.int64)
    yy, xx = np.mgrid[0:h, 0:w]
    img = ((xx[None] + 3 * np.arange(n)[:, None, None]) % 256).astype(
        np.uint8)
    gt_ts = ts[0] - MVSEC_GT_S + MVSEC_GT_S * np.arange(
        int((ts[-1] - ts[0]) / MVSEC_GT_S) + 4)
    a = rng.uniform(-8, 8, (len(gt_ts), 4, 1, 1))
    u, v = xx / w, yy / h
    flow = np.stack([a[:, 0] * u + a[:, 1] * v, a[:, 2] * u - a[:, 3] * v],
                    1).astype(np.float32)
    base = os.path.join(root, seq)
    os.makedirs(base)
    data = os.path.join(base, f"{seq}_data.hdf5")
    gt = os.path.join(base, f"{seq}_gt.hdf5")
    hdf5.write(data, {"davis": {"left": {
        "events": raw, "image_raw": img, "image_raw_event_inds": inds,
        "image_raw_ts": ts}}}, chunks={
            "davis/left/events": (1 << 14, 4),
            "davis/left/image_raw": (1, h, w),
            "davis/left/image_raw_event_inds": (64,)},
        deflate=PREP_DEFLATE)
    hdf5.write(gt, {"davis": {"left": {"flow_dist": flow,
                                       "flow_dist_ts": gt_ts}}},
               chunks={"davis/left/flow_dist": (1, 2, h, w)},
               deflate=PREP_DEFLATE, shuffle=True)
    return dict(raw=raw, inds=inds, data_bytes=os.path.getsize(data),
                gt_bytes=os.path.getsize(gt), gt_frames=len(gt_ts),
                raw_bytes=nbytes_np(raw, img, flow))


def prep_eval(torch, main, argv, expect, label):
    """``main(argv)`` through :func:`eval_run`: the launches it must make
    (``expect``), the batches it must read and its metrics within
    DSEC_EVAL_TOL of the float64 recompute."""
    rec = eval_run(torch, main, argv)
    res = rec["results"]
    check(res["num_batches"] == res["num_samples"] == PREP_EVAL_BATCHES
          and all(np.isfinite(res[k]) for k in DSEC_METRICS),
          f"[20] {label}: results {res}")
    check(rec["launches"] == expect, f"[20] {label}: launches "
          f"{rec['launches']}, expected {expect}")
    want, _ = recompute_numpy(rec)
    err = max(abs(res[k] - want[k]) / max(abs(want[k]), 1e-300)
              for k in DSEC_METRICS)
    check(err <= DSEC_EVAL_TOL, f"[20] {label}: metrics {err:.3e} from the "
          f"float64 recompute")
    return dict(results={k: res[k] for k in DSEC_METRICS},
                launches=rec["launches"], main_s=rec["main_s"],
                rel_err=err)


def phase_prep(torch, dev, config, state_dict, card):
    """The port's raw-data preparation on the card's host: a raw DSEC
    sequence and a raw MVSEC sequence written by the port's HDF5 writer
    (chunked, deflate, shuffle), ``preprocess_dsec`` (voxel on the card by
    K3, then cnt and list) and ``encode_mvsec`` at dt 1 and dt 4, each
    output chained into ``eval_dsec`` / ``eval_mvsec``."""
    import io
    import shutil
    import yaml
    from sdformerflow_tpu_torch import (encode_mvsec, eval_dsec, eval_mvsec,
                                        preprocess_dsec)
    from sdformerflow_tpu_torch.data.loader_utils import get_events_h5
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.ops import hopper_voxel as V
    from sdformerflow_tpu_torch.ops.voxel import voxel_grid_signed
    from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        chunk_bins,
                                                        load_config,
                                                        merge_eval_config)
    from sdformerflow_tpu_torch.training.torch_interop import (
        to_reference_state_dict)
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                        "smoke_prep")
    shutil.rmtree(root, ignore_errors=True)
    raw, mv_raw = os.path.join(root, "dsec"), os.path.join(root, "mvsec_raw")
    rng = np.random.default_rng(SEED + 200)
    h, w = SENSOR
    bins = config["data"]["num_frames"]
    out = {"launches": {}}

    t0 = time.perf_counter()
    tree = write_raw_dsec(torch, raw, DSEC_SEQ, rng)
    out["dsec_write_s"] = time.perf_counter() - t0
    log(f"[20] raw DSEC {DSEC_SEQ}: {PREP_WINDOWS} windows of "
        f"{tree['counts']} events; events.h5 "
        f"{tree['events_h5_bytes'] / 2 ** 20:.1f} MiB for "
        f"{tree['events_raw_bytes'] / 2 ** 20:.1f} MiB of events (chunks of "
        f"{PREP_CHUNK_ROWS}, shuffle + deflate {PREP_DEFLATE}), written in "
        f"{out['dsec_write_s']:.2f} s")

    # preprocess_dsec --input voxel --make_lists: K3 once a window, counted
    # from 0 over the run; each launch's inputs kept for the twin
    kept = []

    def keep(k3):
        def run(x, y, t, p, **kw):
            grid = k3(x, y, t, p, **kw)
            kept.append((x, y, t, p, kw, grid))
            return grid
        return run

    argv = ["--root", raw, "--sequence", DSEC_SEQ, "--num_frames", str(bins),
            "--device", str(dev)]
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    with patched(V, "voxel_grid_signed_k3", keep), \
            contextlib.redirect_stdout(io.StringIO()):
        res = preprocess_dsec.main(argv + ["--input", "voxel", "--make_lists",
                                           "--valid_seqs", DSEC_SEQ])
    out["voxel_wall_s"] = time.perf_counter() - t0
    out["launches"]["preprocess_dsec"] = launches = {
        k: wr.launches for k, wr in kernel_wrappers().items()}
    check(launches == launches_of(K3=PREP_WINDOWS), f"[20] preprocess_dsec: "
          f"launches {launches}, expected K3 {PREP_WINDOWS}")
    windows = res[DSEC_SEQ]
    check([r["events"] for r in windows] == tree["counts"]
          and len(kept) == PREP_WINDOWS,
          f"[20] preprocess_dsec: windows {windows}, {len(kept)} K3 calls, "
          f"written {tree['counts']}")
    sfd = os.path.join(raw, "saved_flow_data")
    names = [f"{DSEC_SEQ}_{i + 1:04d}.npy" for i in range(PREP_WINDOWS)]
    for name, rec, flow, mask, (x, y, t, p, kw, grid) in zip(
            names, windows, tree["flows"], tree["masks"], kept):
        twin = voxel_grid_signed(x, y, t, p, **kw)
        scale = float(twin.abs().max())
        rec["rel_err"] = float((grid - twin).abs().max()) / scale
        saved = np.load(os.path.join(sfd, "event_tensors", f"{bins:02d}bins",
                                     "left", DSEC_SEQ, name))
        check(rec["rel_err"] <= PREP_K3_TOL and scale > 0
              and np.array_equal(saved, grid.cpu().numpy()),
              f"[20] {name}: K3 {rec['rel_err']:.3e} of the twin's largest "
              f"{scale} (tolerance {PREP_K3_TOL}), or the .npy differs")
        xs, ys = x.cpu().numpy(), y.cpu().numpy()
        check(all(((v > -1) & (v < 0)).any() and (v >= n).any()
                  for v, n in ((xs, w), (ys, h))),
              f"[20] {name}: the rectified events neither reach (-1, 0) "
              f"nor leave the frame")
        check(np.array_equal(np.load(os.path.join(sfd, "gt_tensors", name)),
                             flow)
              and np.array_equal(np.load(os.path.join(
                  sfd, "mask_tensors", name)), mask),
              f"[20] {name}: the GT or mask tensor differs from the PNG's")
        launch, _ = V.prepare_k3(x, y, t, p, mode="signed", num_bins=bins,
                                 height=h, width=w, t_range=kw["t_range"])
        rec["k3_ms"] = cuda_time_ms(launch)
        rec["k3_graph_ms"] = cuda_graph_ms(launch)
        rec["plain_ms"] = cuda_time_ms(lambda: voxel_grid_signed(
            x, y, t, p, **kw), iters=5, warmup=1)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, y, t, p, grid),
                                                 0, F32_FLOP_S)
        rec["in_frame"] = int(((xs >= 0) & (xs < w) & (ys >= 0)
                               & (ys < h)).sum())
        log(f"[20] {name}: {rec['events']} events, read {rec['read_ms']:.2f}"
            f" ms, voxel {rec['voxel_ms']:.2f} ms (copies + K3), write "
            f"{rec['write_ms']:.2f} ms; K3 alone {rec['k3_ms']:.4f} ms, graph "
            f"{rec['k3_graph_ms']:.4f} (twin {rec['plain_ms']:.3f}, bound "
            f"{rec['bound_ms']:.4f} by {rec['bound_by']}), within "
            f"{rec['rel_err']:.2e} of the twin's largest")
    lists = {os.path.basename(p): n for p, n in res["lists"]}
    check(lists["valid_split_seq.csv"] == PREP_WINDOWS
          and lists["valid_split_doubleseq.csv"] == PREP_WINDOWS - 1,
          f"[20] sequence lists {lists}")
    out["windows"] = windows
    log(f"[20] preprocess_dsec --input voxel: {out['voxel_wall_s']:.2f} s "
        f"for the sequence on {card}")

    # chained: eval_dsec on the tree just written (en4, bf16, K1 and K2)
    model = get_model(config["model"]["name"], *build_configs(config))
    model.load_state_dict(state_dict)
    pt = os.path.join(root, "reference_en4.pt")
    torch.save({"module." + k: v for k, v in
                to_reference_state_dict(model).items()}, pt)
    del model
    out["eval_dsec"] = prep_eval(torch, eval_dsec.main, [
        "--train_config", CONFIG, "--eval_config", VALID_CONFIG,
        "--torch_ckpt", pt, "--path", sfd, "--bf16", "--max_batches",
        str(PREP_EVAL_BATCHES), "--run_dir", os.path.join(root, "eval_dsec")],
        launches_of(K1=12 * PREP_EVAL_BATCHES, K2=45 * PREP_EVAL_BATCHES),
        "eval_dsec")
    out["launches"]["eval_dsec"] = out["eval_dsec"].pop("launches")

    # the host modes once each: no launch
    for mode, sub in (("cnt", f"{bins:02d}frames"),
                      ("list", f"{bins:02d}lists")):
        for wrapper in kernel_wrappers().values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            preprocess_dsec.main(argv + ["--input", mode])
        out[f"{mode}_wall_s"] = time.perf_counter() - t0
        out["launches"][f"preprocess_dsec_{mode}"] = launches = {
            k: wr.launches for k, wr in kernel_wrappers().items()}
        check(launches == launches_of(), f"[20] --input {mode}: {launches}")
        for name, rec, (x, _, _, _, _, _) in zip(names, windows, kept):
            got = np.load(os.path.join(sfd, "event_tensors", sub, "left",
                                       DSEC_SEQ, name), allow_pickle=True)
            if mode == "cnt":
                ok = (got.shape == (bins, 2, h, w)
                      and int(got.sum()) == rec["in_frame"])
            else:
                ev = got[0]
                ok = (np.array_equal(ev["x"], x.cpu().numpy())
                      and len(ev["t"]) == rec["events"]
                      and 0 <= ev["t"].min() and ev["t"].max() < 1)
            check(ok, f"[20] --input {mode}: {name}")
        log(f"[20] preprocess_dsec --input {mode}: "
            f"{out[f'{mode}_wall_s']:.2f} s, no launch")

    # MVSEC: encode_mvsec at dt 1 and dt 4, then eval_mvsec on each
    t0 = time.perf_counter()
    mv = write_raw_mvsec(mv_raw, MVSEC_PREP_SEQ, rng)
    out["mvsec_write_s"] = time.perf_counter() - t0
    log(f"[20] raw MVSEC {MVSEC_PREP_SEQ}: {MVSEC_PREP_FRAMES} frames of "
        f"{MVSEC_PREP_EVENTS} events, {mv['gt_frames']} GT frames; "
        f"{(mv['data_bytes'] + mv['gt_bytes']) / 2 ** 20:.1f} MiB for "
        f"{mv['raw_bytes'] / 2 ** 20:.1f} MiB (deflate), written in "
        f"{out['mvsec_write_s']:.2f} s")
    mvsec = os.path.join(root, "mvsec")
    for dt in ("1", "4"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            encode_mvsec.main(["--data_dir", mv_raw, "--out_dir", mvsec,
                               "--sequence", MVSEC_PREP_SEQ, "--dt", dt])
        out[f"encode_dt{dt}_s"] = time.perf_counter() - t0
    event_dir = os.path.join(mvsec, MVSEC_PREP_SEQ, "event")
    files = sorted(os.listdir(event_dir))
    raw_rows, inds = mv["raw"], mv["inds"]
    first = 196
    for i in range(first, first + 12):
        rows = raw_rows[inds[i - 1]:inds[i]]
        check(get_events_h5(os.path.join(event_dir, f"{i:06d}.h5")).tobytes()
              == rows[:, [2, 0, 1, 3]].tobytes(),
              f"[20] encode_mvsec: frame {i}'s events differ from the raw "
              f"rows")
    gts = {dt: sorted(os.listdir(os.path.join(mvsec, MVSEC_PREP_SEQ,
                                              f"flowgt_dt{dt}")))
           for dt in ("1", "4")}
    check(len(files) == MVSEC_PREP_FRAMES - 1
          and all(f"{i}.npy" in gts[dt] for dt in gts
                  for i in range(first, first + 3)),
          f"[20] encode_mvsec: {len(files)} event files, GT "
          f"{ {k: len(v) for k, v in gts.items()} }")
    log(f"[20] encode_mvsec: {len(files)} event files, flowgt_dt1 "
        f"{len(gts['1'])}, flowgt_dt4 {len(gts['4'])} in "
        f"{out['encode_dt1_s']:.2f} / {out['encode_dt4_s']:.2f} s")
    # the weights at eval_mvsec's geometry: the merged config (the 10-bin
    # chunk, the crop)
    mdr = merge_eval_config(load_config(MDR_CONFIG),
                            load_config(MVSEC_EVAL_CONFIG))
    m_cfg, swin, spiking = build_configs(mdr)
    model = get_model(mdr["model"]["name"], m_cfg,
                      swin.replace(input_size=tuple(mdr["loader"]["crop"])),
                      spiking, input_bins=chunk_bins(mdr))
    randomize_(model, torch.Generator().manual_seed(SEED + 201))
    ckpt = os.path.join(root, "mdr_ckpt")
    save_checkpoint(ckpt, model, torch.optim.SGD(model.parameters(), lr=0),
                    epoch=0, step=0)
    del model
    with open(MVSEC_EVAL_CONFIG) as f:
        ev_raw = yaml.safe_load(f)
    for dt in ("dt1", "dt4"):
        ev_raw["data"]["event_interval"] = dt
        ev_cfg = os.path.join(root, f"eval_{dt}.yaml")
        with open(ev_cfg, "w") as f:
            yaml.safe_dump(ev_raw, f)
        key = f"eval_mvsec_{dt}"
        out[key] = prep_eval(torch, eval_mvsec.main, [
            "--train_config", MDR_CONFIG, "--eval_config", ev_cfg, "--ckpt",
            ckpt, "--path", mvsec, "--sequence", MVSEC_PREP_SEQ,
            "--max_batches", str(PREP_EVAL_BATCHES), "--run_dir",
            os.path.join(root, key)],
            launches_of(K1=10 * PREP_EVAL_BATCHES,
                        K2=53 * PREP_EVAL_BATCHES), key)
        out["launches"][key] = out[key].pop("launches")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[20] eval_dsec on the prepared tree {out['eval_dsec']['results']}; "
        f"eval_mvsec dt1 {out['eval_mvsec_dt1']['results']}, dt4 "
        f"{out['eval_mvsec_dt4']['results']}; phase 20: "
        f"{out['phase_s']:.1f} s")
    return out


# ----------------------------------------------------------- phase 21
# the rest of the training surface: the en4 step rematerialized (K2
# recomputed, K2b) and tensor parallelism over a model axis (dp1 x tp2,
# two gloo ranks on the one card)

REMAT_POLICIES = (None, "dots", "all")
REMAT_WARMUP_STEPS = 2
REMAT_TIMED_STEPS = 6
# remat against the plain step from one state, with the same spikes: each
# gradient's largest |d| over the largest |gradient| (phase 13's bound)
REMAT_GRAD_TOL = ANN_REMAT_TOL
REMAT_TRAIN_STEPS = 2     # train_dsec --max_steps with optimizer.remat
TP_WORLD = 2              # dp1 x tp2
TP_TIMED_STEPS = 3


def neuron_spikes(model, plain=None):
    """Forward hooks on every neuron of ``model``: each neuron's first call
    keeps its spikes (and, with ``plain``, the plain step's first-call
    spikes by neuron name, counts those that differ); a later call (the
    recompute of a checkpointed block) counts the spikes that differ from
    the first call's. Returns (record, handles): ``record["calls"]`` each
    neuron's calls, ``"recompute"`` and ``"vs_plain"`` [differing,
    compared]."""
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    rec = dict(first={}, calls={}, recompute=[0, 0], vs_plain=[0, 0])

    def hook(name):
        def fn(mod, args, out):
            s = out.detach() != 0
            k = rec["calls"].get(name, 0)
            rec["calls"][name] = k + 1
            if k == 0:
                rec["first"][name] = s
                if plain is not None:
                    rec["vs_plain"][0] += int((s != plain[name]).sum())
                    rec["vs_plain"][1] += s.numel()
            else:
                rec["recompute"][0] += int((s != rec["first"][name]).sum())
                rec["recompute"][1] += s.numel()
        return fn
    return rec, [m.register_forward_hook(hook(n))
                 for n, m in model.named_modules()
                 if isinstance(m, SpikingNeuron)]


def forward_kept_gib(torch, step, opt, batch):
    """One step of ``step``, returning what its forward keeps for the
    backward: the memory allocated when the loss is taken, less what was
    allocated before the step (gradients cleared)."""
    from sdformerflow_tpu_torch.training import train_step as TS
    opt.zero_grad()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    seen = []
    loss = TS.flow_loss_supervised

    def probe(*args, **kw):
        seen.append(torch.cuda.memory_allocated())
        return loss(*args, **kw)
    with patched(TS, "flow_loss_supervised", lambda f: probe):
        step(batch)["loss"].item()
    return (seen[0] - base) / 2 ** 30


def remat_check(torch, dev, config, state_dict, remat, batch, plain):
    """The first en4 f32 step under ``remat`` (None: the plain step) from
    the seeded state: its K2 / K2b launches, every neuron call's spikes
    against the plain step's (``plain``) and, in a recompute, against its
    forward's, and the gradients (on the host). Returns (record,
    gradients, the first calls' spikes)."""
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    model, _, step = dp_trainer(torch, dev, config, state_dict, None,
                                remat=remat)
    rec, handles = neuron_spikes(model, plain)
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    loss = step(batch)["loss"].item()
    launches = {"K2": P.fused_affine_psn.launches,
                "K2b": P.fused_psn_backward.launches}
    for h in handles:
        h.remove()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    first = rec.pop("first")
    del model, step
    torch.cuda.empty_cache()
    return dict(loss=loss, launches=launches,
                neuron_calls=sorted(set(rec["calls"].values())),
                neurons=len(rec["calls"]), recompute_flips=rec["recompute"],
                flips_vs_plain=rec["vs_plain"]), grads, first


def largest_allocation(torch, run, frames=True):
    """The largest single allocation of ``run()`` (GiB) and, with
    ``frames``, what made it: the first frame naming a cuDNN call, else the
    first Python frame. (Recording frames through a rematerialized
    backward fails inside CPython on the card's host: a checkpoint's
    recompute records none.)"""
    kw = dict(stacks="all") if frames else dict(context=None)
    torch.cuda.memory._record_memory_history(max_entries=200000, **kw)
    try:
        run()
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    big = max((e for e in trace if e["action"] == "alloc"),
              key=lambda e: e["size"])
    frames = big.get("frames", [])
    if not frames:
        return dict(gib=big["size"] / 2 ** 30, by="not recorded")
    by = next((f["name"].split("(")[0] for f in frames
               if "cudnn" in f["name"]), None) or next(
        (f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"
         for f in frames if f["filename"].endswith(".py")), "unknown")
    return dict(gib=big["size"] / 2 ** 30, by=by)


def remat_measure(torch, dev, config, state_dict, remat, batch):
    """The en4 f32 step under ``remat`` with nothing else of this phase on
    the card: what its forward keeps, p50 / p90 after the warm-up, the
    peak memory, device busy and its largest allocation."""
    model, opt, step = dp_trainer(torch, dev, config, state_dict, None,
                                  remat=remat)
    kept = forward_kept_gib(torch, step, opt, batch)
    for _ in range(REMAT_WARMUP_STEPS - 1):
        step(batch)["loss"].item()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(REMAT_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    busy = device_ms_per_call(torch, lambda: step(batch), 1,
                              f"smoke_remat_{remat}_trace")
    big = largest_allocation(torch, lambda: step(batch),
                             frames=remat is None)
    del model, opt, step
    torch.cuda.empty_cache()
    return dict(forward_kept_gib=kept, step_ms=ms,
                p50_ms=float(np.percentile(ms, 50)),
                p90_ms=float(np.percentile(ms, 90)), peak_mem_gib=peak,
                device_ms=busy, largest_alloc=big)


def remat_trainer(torch, dev, card):
    """``train_dsec --synthetic --max_steps 2`` on the en4 config written
    anew with ``optimizer.remat: dots``: finite losses, K2 twice and K2b
    once at every site a step."""
    import copy
    import shutil
    import tempfile
    import yaml
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training import train_loop as TL
    from sdformerflow_tpu_torch.training.config import load_config
    config = copy.deepcopy(load_config(CONFIG))
    config["optimizer"]["remat"] = "dots"
    tmp = tempfile.mkdtemp(prefix="smoke_remat_")
    try:
        path = os.path.join(tmp, "en4_remat_dots.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(config, f)
        steps, wall, model, opt = dsec_train(torch, [
            "--config", path, "--synthetic", "--max_steps",
            str(REMAT_TRAIN_STEPS), "--run_dir", os.path.join(tmp, "run"),
            "--device", str(dev)], TL, P)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses = [s[0] for s in steps]
    check(len(steps) == REMAT_TRAIN_STEPS and np.isfinite(losses).all()
          and int(opt.count) == REMAT_TRAIN_STEPS,
          f"[21] train_dsec with remat dots: losses {losses}, "
          f"{int(opt.count)} updates")
    launches = [{"K2": s[1], "K2b": s[2]} for s in steps]
    check(all(c == {"K2": 2 * DP_PSN_SITES, "K2b": DP_PSN_SITES}
              for c in launches), f"[21] train_dsec with remat dots: "
          f"launches a step {launches}")
    log(f"[21] train_dsec --synthetic --max_steps {REMAT_TRAIN_STEPS} on the "
        f"en4 config with optimizer.remat: dots: losses "
        + ", ".join(f"{v:.5g}" for v in losses)
        + f", launches a step {launches[0]}, {wall:.1f} s with validation, "
        f"on {card}")
    del model, opt
    torch.cuda.empty_cache()
    return dict(losses=losses, launches_per_step=launches[0], seconds=wall)


def phase_remat(torch, dev, config, state_dict, card):
    """Remat ``dots`` and ``all`` beside the plain en4 f32 step at batch 1
    (288x384, TF32 off): the same spikes and gradients, no spike of a
    recompute differing from its forward's, K2 twice and K2b once at every
    PSN site, the memory the forward keeps, the step's peak, p50 / p90 and
    device busy; then the trainer with ``optimizer.remat: dots``."""
    batch = train_batch(torch, dev, TRAIN_HW, SEED + 200)
    runs, grads, plain = {}, {}, None
    for remat in REMAT_POLICIES:
        key = str(remat)
        runs[key], grads[key], first = remat_check(
            torch, dev, config, state_dict, remat, batch, plain)
        if remat is None:
            plain = first
        del first
    del plain
    torch.cuda.empty_cache()
    for remat in REMAT_POLICIES:
        runs[str(remat)].update(remat_measure(torch, dev, config,
                                              state_dict, remat, batch))
    top = max(float(g.abs().max()) for g in grads["None"].values())
    for remat in REMAT_POLICIES[1:]:
        r = runs[remat]
        check(set(grads[remat]) == set(grads["None"]),
              f"[21] remat {remat}: other parameters have gradients")
        r["grad_err_of_largest"] = max(
            float((grads[remat][n] - g).abs().max())
            for n, g in grads["None"].items()) / top
    del grads
    want = {"None": (DP_PSN_SITES, [1]), "dots": (2 * DP_PSN_SITES, [2]),
            "all": (2 * DP_PSN_SITES, [2])}
    for key, r in runs.items():
        k2, calls = want[key]
        check(r["launches"] == {"K2": k2, "K2b": DP_PSN_SITES}
              and r["neuron_calls"] == calls and r["neurons"] == DP_PSN_SITES,
              f"[21] remat {key}: launches {r['launches']}, neuron calls "
              f"{r['neuron_calls']} of {r['neurons']} neurons")
        if key == "None":
            continue
        f, n = r["recompute_flips"]
        check(n > 0 and f == 0, f"[21] remat {key}: {f} of {n} spikes of "
              "a recompute differ from its forward's")
        f, n = r["flips_vs_plain"]
        check(n > 0 and f == 0, f"[21] remat {key}: {f} of {n} spikes "
              "differ from the plain step's")
        check(r["grad_err_of_largest"] <= REMAT_GRAD_TOL,
              f"[21] remat {key}: gradients {r['grad_err_of_largest']:.3g} "
              f"of the largest from the plain step's (bound "
              f"{REMAT_GRAD_TOL})")
    log(f"[21] en4 f32 train step (TF32 off), batch 1 at {TRAIN_HW[0]}x"
        f"{TRAIN_HW[1]}, plain and under remat, from one state, on {card}:")
    for key, r in runs.items():
        extra = "" if key == "None" else (
            f"; a recompute's spikes differ from its forward's at "
            f"{r['recompute_flips'][0]} of {r['recompute_flips'][1]}, the "
            f"forward's from the plain step's at {r['flips_vs_plain'][0]} "
            f"of {r['flips_vs_plain'][1]}; gradients "
            f"{r['grad_err_of_largest']:.3g} of the largest from the plain "
            f"step's")
        log(f"[21]   remat {key}: the forward keeps "
            f"{r['forward_kept_gib']:.3f} GiB, peak {r['peak_mem_gib']:.3f}"
            f" GiB; step p50 {r['p50_ms']:.1f} ms, p90 {r['p90_ms']:.1f} ("
            + ", ".join(f"{v:.1f}" for v in r["step_ms"]) + "), device "
            "busy " + ("not measured" if r["device_ms"] is None
                       else f"{r['device_ms']:.1f} ms")
            + f"; K2 {r['launches']['K2']}, K2b {r['launches']['K2b']} "
            f"launches; the largest allocation of a step "
            f"{r['largest_alloc']['gib']:.3f} GiB by "
            f"{r['largest_alloc']['by']}" + extra)
    trainer = remat_trainer(torch, dev, card)
    return dict(steps=runs, trainer=trainer)


def tp_trainer(torch, dev, config, state_dict, mesh):
    """(model, optimizer, train step) of the en4 config in float32 with
    DP_OPT, sharded over ``mesh``'s model group (None: one process)."""
    from sdformerflow_tpu_torch.parallel import sharding_rules
    from sdformerflow_tpu_torch.training.train_step import make_train_step
    model, opt, _ = dp_trainer(torch, dev, config, state_dict, None)
    if mesh is not None:
        sharding_rules.shard_model(model, opt, mesh)
    step = make_train_step(model, opt,
                           norm_input=config["model"]["norm_input"],
                           generator=torch.Generator(dev).manual_seed(SEED))
    return model, opt, step


def tp_rank_work(torch, dev, rank, world, config, state_dict, hw):
    """One rank's share of phase 21's dp1 x tp2 step (the whole batch on
    every model rank), checked on rank 0 against one process on the same
    card given the TP step's spikes."""
    import torch.distributed as dist
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.parallel import multihost, sharding_rules
    mesh = multihost.make_multihost_mesh(world)
    check(mesh.n_model == world and mesh.data is None
          and mesh.model_rank == rank, f"rank {rank}: mesh {mesh}")
    batch = train_batch(torch, dev, hw, SEED + 210)
    start = {k: v.to(dev) for k, v in state_dict.items()}
    model, opt, step = tp_trainer(torch, dev, config, state_dict, mesh)
    layout = sharding_rules.tp_layout(model)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    whole = sum(v.numel() * v.element_size() for k, v in start.items()
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked")))

    # the checked step: launches, spikes recorded, collectives counted
    spikes = []
    handles = spike_record(model, spikes)
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    with CollectiveLog(torch) as coll:
        tp_loss = step(batch)["loss"].item()
    launches = {"K2": P.fused_affine_psn.launches,
                "K2b": P.fused_psn_backward.launches}
    for h in handles:
        h.remove()
    opt_bytes = sum(getattr(opt, n).numel() * getattr(opt, n).element_size()
                    for n in opt.state_names)
    after_tp = {k: v.detach().clone() for k, v in
                sharding_rules.whole_state(model)[0].items()}
    # the model ranks fired the same spikes and hold the same whole state
    sig = torch.tensor([float(s.sum()) for s in spikes]
                       + [float(v.double().sum()) for v in after_tp.values()
                          if v.is_floating_point()], dtype=torch.float64)
    sigs = [torch.empty_like(sig) for _ in range(world)]
    dist.all_gather(sigs, sig, group=mesh.model)
    ranks_agree = all(torch.equal(s, sigs[0]) for s in sigs)

    # the timed steps and the peak memory
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for _ in range(TP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    del model, opt, step
    torch.cuda.empty_cache()
    res = dict(rank=rank, loss=tp_loss, launches=launches,
               sharded=len(layout.dims), param_bytes=held,
               param_bytes_one_process=whole, optimizer_bytes=opt_bytes,
               collectives=coll.summary(), ranks_agree=ranks_agree,
               step_ms=ms, p50_ms=float(np.percentile(ms, 50)),
               peak_mem_gib=peak, spike_calls=len(spikes))
    if rank != 0:
        return res

    # one process on the same batch from the same state, its neurons given
    # the TP step's spikes
    model, opt, step = tp_trainer(torch, dev, config, state_dict, None)
    site = []
    handles = forced_spikes(torch, model, [spikes], site)
    P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
    one_loss = step(batch)["loss"].item()
    one_launches = {"K2": P.fused_affine_psn.launches,
                    "K2b": P.fused_psn_backward.launches}
    for h in handles:
        h.remove()
    one_opt_bytes = sum(getattr(opt, n).numel()
                        * getattr(opt, n).element_size()
                        for n in opt.state_names)
    after_one = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model, opt, step, spikes
    check(len(site) == res["spike_calls"] > 0, f"{res['spike_calls']} neuron"
          f" calls in the TP step against {len(site)} in one process")

    def moved(after):
        return {k: after[k].double() - start[k].double() for k in start
                if after[k].is_floating_point()}
    d_tp, d_one = moved(after_tp), moved(after_one)
    params = [k for k in d_one if not k.endswith(("running_mean",
                                                  "running_var"))]
    top = max(d_one[k].abs().max().item() for k in params)
    res.update(
        one_process_loss=one_loss, one_process_launches=one_launches,
        optimizer_bytes_one_process=one_opt_bytes,
        loss_rel=abs(tp_loss - one_loss) / max(abs(one_loss), 1e-300),
        spikes_flipped=sum(s[0] for s in site),
        spikes=sum(s[1] for s in site),
        param_delta_rel=max((d_tp[k] - d_one[k]).abs().max().item()
                            for k in params) / max(top, 1e-300),
        running_stats_rel=max(rel_err(after_tp[k], after_one[k])[1]
                              for k in start
                              if k.endswith(("running_mean",
                                             "running_var"))))
    torch.cuda.empty_cache()
    return res


def tp_rank(index, world, out_dir, config_path, hw):
    """A spawned rank of phase 21 (``torch.multiprocessing``), as
    :func:`dp_rank`."""
    run_rank(index, world, out_dir, config_path, hw, tp_rank_work)


def tp_step(torch, card):
    """The dp1 x tp2 en4 step against one process (see tp_rank_work)."""
    wall, ranks = spawn_ranks(tp_rank, TP_WORLD, "smoke_tp", TRAIN_HW)
    r0 = ranks[0]
    log(f"[21] en4 f32 train step (TF32 off), batch 1 at {TRAIN_HW[0]}x"
        f"{TRAIN_HW[1]}, dp1 x tp{TP_WORLD} ({r0['sharded']} weights sharded"
        f" over output channels), {TP_WORLD} gloo ranks on cuda:0 "
        f"({wall:.1f} s with start-up), against one process on the same "
        f"card given the TP step's spikes, on {card}: loss "
        f"{r0['loss']:.7g} (one process {r0['one_process_loss']:.7g}, rel "
        f"{r0['loss_rel']:.2e}); the one process's own spikes differ at "
        f"{r0['spikes_flipped']} of {r0['spikes']}; parameter moves "
        f"{r0['param_delta_rel']:.2e} of the largest away, running "
        f"statistics {r0['running_stats_rel']:.2e}")
    for r in ranks:
        log(f"[21]   rank {r['rank']}: K2 {r['launches']['K2']}, K2b "
            f"{r['launches']['K2b']} launches; parameters "
            f"{r['param_bytes'] / 2 ** 20:.1f} MiB (one process "
            f"{r['param_bytes_one_process'] / 2 ** 20:.1f}), optimizer "
            f"state {r['optimizer_bytes'] / 2 ** 20:.1f} MiB"
            + (f" (one process "
               f"{r['optimizer_bytes_one_process'] / 2 ** 20:.1f})"
               if "optimizer_bytes_one_process" in r else "")
            + f"; peak "
            f"{r['peak_mem_gib']:.2f} GiB; step p50 {r['p50_ms']:.1f} ms ("
            + ", ".join(f"{v:.1f}" for v in r["step_ms"])
            + "); collectives of the checked step (host clock, a sync "
            "either side): " + ", ".join(
                f"{k} {v['count']} ({v['ms']:.1f} ms, "
                f"{v['bytes'] / 2 ** 20:.1f} MiB)"
                for k, v in sorted(r["collectives"].items())))
    want = {"K2": DP_PSN_SITES, "K2b": DP_PSN_SITES}
    for r in ranks:
        rk = r["rank"]
        check(r["foreign_modules"] == [], f"rank {rk} imported "
              f"{r['foreign_modules']}")
        check(r["launches"] == want, f"[21] TP rank {rk}: launches "
              f"{r['launches']}, expected {want}")
        check(r["ranks_agree"], f"[21] TP rank {rk}: the model ranks' "
              "spikes or whole states differ")
        check(r["param_bytes"] < r["param_bytes_one_process"],
              f"[21] TP rank {rk} holds every parameter whole")
    check(r0["one_process_launches"] == want, f"[21] one process: "
          f"{r0['one_process_launches']}")
    check(r0["spikes_flipped"] <= MAX_FLIP_SHARE * r0["spikes"],
          f"[21] {r0['spikes_flipped']} of {r0['spikes']} spikes of one "
          "process differ from the TP step's")
    check(r0["loss_rel"] <= DP_LOSS_TOL, f"[21] the TP loss {r0['loss']} "
          f"against one process's {r0['one_process_loss']}")
    check(r0["param_delta_rel"] <= DP_DELTA_TOL, f"[21] the parameters "
          f"moved {r0['param_delta_rel']:.3g} of the largest move away from"
          " one process's")
    check(r0["running_stats_rel"] <= DP_STATS_TOL, f"[21] the running "
          f"statistics {r0['running_stats_rel']:.3g} away from one "
          "process's")
    return dict(ranks=ranks, wall_s=wall, world=TP_WORLD)


def phase_train_surface(torch, dev, config, state_dict, card):
    t_phase = time.perf_counter()
    remat = phase_remat(torch, dev, config, state_dict, card)
    torch.cuda.empty_cache()
    tp = tp_step(torch, card)
    phase_s = time.perf_counter() - t_phase
    log(f"[21] phase 21: {phase_s:.1f} s")
    return dict(remat=remat, tp=tp, phase_s=phase_s)


# ----------------------------------------------------------- phase 22
# the closing modules: the MS Sep-conv layers at en4's shapes, the SEW
# attention's SDSA switches, the Local embed's plain-conv projection, and
# export_model --verify of every SNN / ANN family at full width

SEP_IN = (10, 1, 72, 96, 96)  # en4's first Swin stage input at 288x384
SEP_OUT = 192
ZOO_EXPORTS = ("SpikingformerFlowNet", "MS_SpikingformerFlowNet",
               "SpikingMultiResUNet", "STTFlowNet")
EXPORT_BUSY_TOL = 0.02       # a reloaded program's device busy vs live
EXPORT_BUSY_ROUNDS = 5
EXPORT_OPS = {"K1": "sdformerflow_torch.qk_attn_interior.default",
              "K2": "sdformerflow_torch.fused_affine_psn.default",
              "K3": "sdformerflow_torch.voxelize_batch.default"}


def en4_layer_inputs(torch, dev, config, state_dict):
    """The input shapes of en4's first decoder and of its last prediction
    head (bf16 forward at the config's crop), and their out channels."""
    from sdformerflow_tpu_torch.models.registry import get_model
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    model = get_model(config["model"]["name"], *build_configs(config))
    model.load_state_dict(state_dict)
    unet = model.sttmultires_unet
    dec, pred = unet.decoder0, getattr(unet, f"pred{unet.num_encoders - 1}")
    shapes = {}

    def grab(name):
        def hook(mod, args):
            shapes[name] = tuple(args[0].shape)
        return hook
    handles = [dec.register_forward_pre_hook(grab("decoder")),
               pred.register_forward_pre_hook(grab("pred"))]
    step = make_eval_step(model.to(dev), compute_dtype=torch.bfloat16)
    hw = tuple(config["loader"]["crop"])
    with torch.inference_mode():
        step(torch.from_numpy(voxel_requests(1, 10, hw, SEED + 220)[0])[None]
             .to(dev))
    for h in handles:
        h.remove()
    out = {"decoder": (shapes["decoder"], dec.deconv.out_channels),
           "pred": (shapes["pred"], pred.conv.out_channels)}
    del model, step
    torch.cuda.empty_cache()
    return out


def psn_sites_dyadic(torch, dev, P, sites, gen):
    """K2 against its twin bit for bit on dyadic inputs at each captured
    site's shape, dtype and affine (x on a 1/4 grid, W on 1/8, b, scale
    and shift on 1/4): the largest |d| (must be 0)."""
    err = 0.0
    for shape, dtype, affine in sorted(set(sites), key=str):
        T, C = shape[0], shape[-1]
        x = dyadic(shape, 0.25, -2.0, 2.0, gen, dev, dtype)
        w = dyadic((T, T), 0.125, -1.0, 1.0, gen, dev, torch.float32)
        b = dyadic((T, 1), 0.25, -1.0, 1.0, gen, dev, torch.float32)
        kw = dict(scale=dyadic((C,), 0.25, 0.25, 2.0, gen, dev,
                               torch.float32),
                  shift=dyadic((C,), 0.25, -1.0, 1.0, gen, dev,
                               torch.float32)) if affine else {}
        got = P.fused_affine_psn(x, w, b, **kw)
        d = (got.float() - P.psn_spike(x, w, b, **kw).float()).abs().max()
        err = max(err, d.item())
        check(0.0 < got.float().mean().item() < 1.0,
              f"[22] dyadic K2 at {list(shape)}: degenerate output")
    return err


def layer_eval(torch, dev, label, layer, x):
    """``layer`` in bf16 eval (a cast copy, inference mode): K2 once at
    every PSN site, each launch against its twin (flipped share), the
    sites' shapes again on dyadic inputs bit for bit, then the plain
    twins' forward (equal where no spike flipped)."""
    import copy
    from sdformerflow_tpu_torch.models.spiking_layers import SpikingNeuron
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    from sdformerflow_tpu_torch.training.train_step import cast_params
    m = cast_params(copy.deepcopy(layer).to(dev).eval(), torch.bfloat16)
    xb = x.to(dev, torch.bfloat16)
    flips, sites, calls = {"K1": [0, 0], "K2": [0, 0]}, [], [0]
    psn, _ = checked_kernels(flips)

    def on_psn(mod, args, kwargs):
        sites.append((tuple(args[0].shape), args[0].dtype,
                      kwargs.get("affine") is not None))
    handles = [n.register_forward_pre_hook(on_psn, with_kwargs=True)
               for n in m.modules()
               if isinstance(n, SpikingNeuron) and n.kind == "psn"]
    with torch.inference_mode():
        with psn_calls(m, calls):
            P.fused_affine_psn.launches = 0
            with site_functions(psn):
                y = first_out(m(xb))
            torch.cuda.synchronize()
            k2 = P.fused_affine_psn.launches
        for h in handles:
            h.remove()
        with site_functions(plain_twins()[0]):
            plain = first_out(m(xb))
    check(k2 == calls[0] == len(sites) > 0, f"[22] {label} bf16: K2 {k2} "
          f"launches for {calls[0]} PSN-site calls")
    n_flip, n = flips["K2"]
    check(n_flip <= MAX_FLIP_SHARE * n, f"[22] {label} bf16: K2 flipped "
          f"{n_flip} of {n} spikes")
    check(bool(torch.isfinite(y.float()).all()), f"[22] {label}: non-finite")
    same = torch.equal(y, plain)
    if n_flip == 0:
        check(same, f"[22] {label}: no spike flipped, yet the kernel path "
              "differs from the plain twins'")
    with torch.inference_mode():
        dy = psn_sites_dyadic(torch, dev, P, sites,
                              torch.Generator(dev).manual_seed(SEED + 221))
    check(dy == 0.0, f"[22] {label}: K2 {dy} from its twin on dyadic inputs")
    return dict(k2=k2, sites=sorted({str(list(s)) + (" affine" if a else "")
                                     for s, _, a in sites}),
                flipped=n_flip, spikes=n, same_as_plain=same,
                dyadic_max_abs_err=dy, out_shape=list(y.shape)), y


def first_out(out):
    return out[0] if isinstance(out, tuple) else out


def layer_train(torch, dev, label, layer, x):
    """``layer`` in float32 train mode (TF32 off): one forward and backward
    of a random projection of its output, K2 and K2b once at every PSN
    site, each K2 launch against its twin (flipped share) and each K2b
    launch against the float64 twin (``captured_ok``); then the same step
    through the plain twins (``hopper_psn.PLAIN``), whose output must be
    equal where no spike flipped."""
    import copy
    import functools
    from sdformerflow_tpu_torch.ops import hopper_psn as P
    gen = torch.Generator(dev).manual_seed(SEED + 222)
    x = x.to(dev, torch.float32)
    g = []
    flips = [0, 0]
    worst = dict.fromkeys(GRAD_NAMES, 0.0)
    terms = dict.fromkeys(GRAD_NAMES, 0.0)

    def checked_fwd(x, w, b, *, scale=None, shift=None):
        y = P.fused_affine_psn(x, w, b, scale=scale, shift=shift)
        flips[0] += int((y != P.psn_spike(x, w, b, scale=scale,
                                          shift=shift)).sum())
        flips[1] += y.numel()
        return y

    def checked_bwd(x, gy, w, b, **kw):
        got = P.fused_psn_backward(x, gy, w, b, **kw)
        want = plain64(P, x, gy, w, b, **kw)
        sums = sum_of_terms(P, x, gy, w, b, **kw)
        for name, e in k2b_errors(got, want).items():
            i = GRAD_NAMES.index(name)
            worst[name] = max(worst[name], e)
            scale = (sums[i] if i else want[0]).abs().max().item()
            terms[name] = max(terms[name], rel_err(got[i], want[i])[0]
                              / max(scale, 1e-300))
        return got

    def run(m, impl):
        xi = x.clone().requires_grad_(True)
        with site_functions(functools.partial(P.affine_psn, impl=impl)):
            y = first_out(m(xi))
            if not g:
                g.append(torch.randn(y.shape, generator=gen, device=dev))
            (y * g[0]).sum().backward()
        return y.detach(), xi.grad

    m, calls = copy.deepcopy(layer).to(dev).float().train(), [0]
    with psn_calls(m, calls):
        P.fused_affine_psn.launches = P.fused_psn_backward.launches = 0
        y, dx = run(m, P.PSNImpl(checked_fwd, checked_bwd))
        torch.cuda.synchronize()
        k2, k2b = P.fused_affine_psn.launches, P.fused_psn_backward.launches
    check(k2 == k2b == calls[0] > 0, f"[22] {label} train: K2 {k2}, K2b "
          f"{k2b} launches for {calls[0]} PSN-site calls")
    check(flips[0] <= MAX_FLIP_SHARE * flips[1], f"[22] {label} train: K2 "
          f"flipped {flips[0]} of {flips[1]} spikes")
    check(captured_ok(worst, terms), f"[22] {label} train: K2b against the "
          f"float64 twin {worst} (reductions over their sums of |terms| "
          f"{terms})")
    y_plain, dx_plain = run(copy.deepcopy(layer).to(dev).float().train(),
                            P.PLAIN)
    same = torch.equal(y, y_plain)
    if flips[0] == 0:
        check(same, f"[22] {label} train: no spike flipped, yet the output "
              "differs from the plain twins'")
    return dict(k2=k2, k2b=k2b, flipped=flips[0], spikes=flips[1],
                k2b_err=worst, k2b_terms_err=terms, same_as_plain=same,
                dx_rel_to_plain=rel_err(dx, dx_plain)[1])


def sep_conv_layers(torch, dev, config, state_dict, card):
    """(a) the four MS Sep-conv layers (through the encoder block, which
    holds MSSepConv) at en4's shapes: bf16 eval and f32 train."""
    from sdformerflow_tpu_torch.models import spiking_layers as L
    from sdformerflow_tpu_torch.models.registry import randomize_
    from sdformerflow_tpu_torch.training.config import build_configs
    cfg = build_configs(config)[2]
    shapes = en4_layer_inputs(torch, dev, config, state_dict)
    (dec_in, dec_out), (pred_in, pred_out) = shapes["decoder"], \
        shapes["pred"]
    layers = {
        "MSSpikingSepConvEncoderBlock": (
            L.MSSpikingSepConvEncoderBlock(SEP_IN[-1], SEP_OUT, cfg),
            SEP_IN),
        "MSSpikingSepTransposeDecoderLayer": (
            L.MSSpikingSepTransposeDecoderLayer(dec_in[-1], dec_out, cfg),
            dec_in),
        "MSSpikingSepPredLayer": (
            L.MSSpikingSepPredLayer(pred_in[-1], pred_out, cfg), pred_in)}
    out = {}
    for i, (name, (layer, shape)) in enumerate(layers.items()):
        randomize_(layer, torch.Generator().manual_seed(SEED + 230 + i))
        gen = torch.Generator().manual_seed(SEED + 240 + i)
        x = 1.5 * torch.randn(shape, generator=gen)
        ev, y = layer_eval(torch, dev, name, layer, x)
        tr = layer_train(torch, dev, name, layer, x)
        out[name] = dict(input=list(shape), eval_bf16=ev, train_f32=tr)
        log(f"[22] {name} at {list(shape)} -> {ev['out_shape']}: bf16 eval "
            f"K2 {ev['k2']} launches (one a PSN site; sites {ev['sites']}),"
            f" {ev['flipped']} of {ev['spikes']} spikes flipped against the"
            f" twin, dyadic bitwise; f32 train K2 {tr['k2']} ({tr['flipped']}"
            f" of {tr['spikes']} spikes flipped), K2b {tr['k2b']}, K2b vs "
            "the float64 twin "
            + ", ".join(f"{k} {v:.2e}" for k, v in tr["k2b_err"].items())
            + f"; plain-twin step equal {tr['same_as_plain']} (dx "
            f"{tr['dx_rel_to_plain']:.2e} of its largest)")
        del y
    torch.cuda.empty_cache()
    return out, shapes


def sdsa_attention(torch, dev, hw, card):
    """(b) SpikingBNWindowAttention3D(spike_input=True, spike_output=False)
    on the SEW model's first-stage window batch, bf16 eval and f32 train
    against the plain twins."""
    from sdformerflow_tpu_torch.models.registry import randomize_
    from sdformerflow_tpu_torch.models.spiking_swin import (
        SpikingBNWindowAttention3D)
    from sdformerflow_tpu_torch.training.config import build_configs
    from sdformerflow_tpu_torch.training.train_step import make_eval_step
    config = zoo_config("SpikingformerFlowNet")
    model = zoo_model(torch, config).to(dev)
    attn = next(m for m in model.modules()
                if isinstance(m, SpikingBNWindowAttention3D))
    grabbed = []
    h = attn.register_forward_pre_hook(
        lambda mod, args: grabbed.append(args[0].float().clone()))
    with torch.inference_mode():
        make_eval_step(model, compute_dtype=torch.bfloat16)(
            torch.from_numpy(voxel_requests(1, 10, hw, SEED + 223)[0])[None]
            .to(dev))
    h.remove()
    x = grabbed[0].cpu()
    _, swin, cfg = build_configs(config)
    sdsa = randomize_(SpikingBNWindowAttention3D(
        attn.dim, attn.window_size, attn.num_heads, cfg,
        qk_scale=swin.qk_scale, norm="BN", spike_input=True,
        spike_output=False), torch.Generator().manual_seed(SEED + 224))
    del model, attn, grabbed
    torch.cuda.empty_cache()
    ev, y = layer_eval(torch, dev, "SDSA attention", sdsa, x)
    check(ev["k2"] == 4, f"[22] SDSA: K2 {ev['k2']}, expected 4 (proj_sn_in,"
          " q, k, v)")
    check(not bool(((y == 0) | (y == 1)).all()),
          "[22] SDSA: spike_output=False returned spikes")
    tr = layer_train(torch, dev, "SDSA attention", sdsa, x)
    log(f"[22] SDSA SpikingBNWindowAttention3D(spike_input=True, "
        f"spike_output=False) on the SEW model's first-stage windows "
        f"{list(x.shape)}: bf16 eval K2 {ev['k2']}, {ev['flipped']} of "
        f"{ev['spikes']} spikes flipped, equal to the plain twins "
        f"{ev['same_as_plain']}; f32 train K2 {tr['k2']} ({tr['flipped']} of "
        f"{tr['spikes']} spikes flipped), K2b {tr['k2b']}, "
        + ", ".join(f"{k} {v:.2e}" for k, v in tr["k2b_err"].items())
        + f"; equal to the plain twins' step {tr['same_as_plain']}")
    return dict(input=list(x.shape), eval_bf16=ev, train_f32=tr)


def local_plain_proj(torch, dev, hw, card):
    """(c) SpikingPatchEmbedLocal(spiking_proj=False) at en4's width
    (embed 96, T = 10, 4 residual blocks) on a 288x384 10-bin input."""
    from sdformerflow_tpu_torch.models.registry import randomize_
    from sdformerflow_tpu_torch.models.spiking_patch_embed import (
        SpikingPatchEmbedLocal)
    from sdformerflow_tpu_torch.training.config import build_configs, \
        load_config
    cfg = build_configs(load_config(CONFIG))[2]
    embed = randomize_(SpikingPatchEmbedLocal(
        hw, (1, 1, 2, 2), 10, 96, cfg, spiking_proj=False),
        torch.Generator().manual_seed(SEED + 225))
    gen = torch.Generator().manual_seed(SEED + 226)
    x = torch.rand((1, 10, 2) + tuple(hw), generator=gen) \
        * (torch.rand((1, 10, 2) + tuple(hw), generator=gen) < 0.3)
    ev, y = layer_eval(torch, dev, "Local embed (plain proj)", embed, x)
    check(ev["out_shape"] == [10, 1, hw[0] // 2, hw[1] // 2, 96],
          f"[22] Local embed: {ev['out_shape']}")
    check(not bool(((y == 0) | (y == 1)).all()),
          "[22] Local embed: the plain projection returned spikes")
    log(f"[22] SpikingPatchEmbedLocal(spiking_proj=False), embed 96, "
        f"{hw[0]}x{hw[1]} -> {ev['out_shape']}, bf16: K2 {ev['k2']} "
        f"launches (head and 4 residual blocks), {ev['flipped']} of "
        f"{ev['spikes']} spikes flipped, equal to the plain twins "
        f"{ev['same_as_plain']}")
    del y
    torch.cuda.empty_cache()
    return dict(eval_bf16=ev)


def zoo_export_config(name):
    """The family's full-width config: the phase 17 zoo configs (the en4
    cut to 3 stages; SpikingMultiResUNet with its registry's width) and
    the DSEC STT config (two 10-bin chunks a window)."""
    from sdformerflow_tpu_torch.training.config import load_config
    if name == "STTFlowNet":
        return load_config(STT_CONFIG)
    if name == "MS_SpikingformerFlowNet":
        return zoo_config(name, "MS_Spiking_PatchEmbed_Conv_sfn")
    config = zoo_config(name)
    if name == "SpikingMultiResUNet":
        for key in ("base_num_channels", "kernel_size", "use_upsample_conv",
                    "num_encoders"):
            config["model"].pop(key, None)
    return config


def zoo_export(torch, dev, root, name, card):
    """export_model --verify of one family at full width in bf16 from
    seeded random weights (and the 2^20-event program for the SEW model):
    the reloaded programs equal the live step bit for bit (verify), their
    K1 / K2 / K3 op nodes equal the live step's launches and the reloaded
    program's, device busy within EXPORT_BUSY_TOL of the live step's."""
    import io
    import yaml
    from sdformerflow_tpu_torch import export_model
    from sdformerflow_tpu_torch.models.registry import get_model, randomize_
    from sdformerflow_tpu_torch.training import export as X
    from sdformerflow_tpu_torch.training.checkpoints import save_checkpoint
    from sdformerflow_tpu_torch.training.config import (build_configs,
                                                        chunk_bins)
    config = zoo_export_config(name)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    path, ckpt, out = (os.path.join(d, "config.yaml"),
                       os.path.join(d, "ckpt"), os.path.join(d, "export"))
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    model = get_model(name, *build_configs(config),
                      input_bins=chunk_bins(config))
    randomize_(model, torch.Generator().manual_seed(SEED + 250))
    save_checkpoint(ckpt, model, torch.optim.SGD(model.parameters(), lr=0),
                    epoch=0, step=0)
    del model
    timing, loaded = {"load_s": 0.0}, {}

    def timed_export(export):
        def run(*a, **kw):
            t0 = time.perf_counter()
            meta = export(*a, **kw)
            timing["export_s"] = time.perf_counter() - t0
            return meta
        return run

    def timed_load(load):
        def run(*a, **kw):
            t0 = time.perf_counter()
            meta, fns = load(*a, **kw)
            timing["load_s"] += time.perf_counter() - t0
            loaded.update(fns)
            return meta, fns
        return run

    events = name == "SpikingformerFlowNet"
    argv = ["--train_config", path, "--ckpt", ckpt, "--out", out,
            "--device", str(dev), "--verify"]
    if events:
        argv += ["--event_buckets", str(K3_EVENTS)]
    text = io.StringIO()
    with patched(X, "export_flow_model", timed_export), \
            patched(X, "load_exported", timed_load), \
            contextlib.redirect_stdout(text):
        try:
            meta = export_model.main(argv)
        except SystemExit as e:
            raise SmokeFailure(f"[22] export_model --verify {name}: {e}")
    names = sorted(meta["artifacts"])
    check(meta["bf16"] and sorted(meta["verify"]) == names
          and not any(meta["verify"].values()),
          f"[22] {name} --verify: {meta['verify']}")
    mb = {k: os.path.getsize(os.path.join(out, k + ".pt2")) / 1e6
          for k in names}
    live_model = X.build_inference_state(config, ckpt, device=dev)
    cast = X.cast_for(live_model, True)
    arts = {}
    for art in names:
        fn = loaded[art]
        live = X._eval_fn(config, cast, bf16=True, events=art != "voxel")
        x = export_model.random_inputs(meta, art, seed=1)
        nodes = collections.Counter(str(n.target)
                                    for n in fn.program.graph.nodes)
        graph = {k: nodes[op] for k, op in EXPORT_OPS.items()}
        counts = {}
        for route, run in (("live", live), ("reloaded", fn)):
            for w in kernel_wrappers().values():
                w.launches = 0
            with torch.inference_mode():
                y = run(x)
            torch.cuda.synchronize()
            counts[route] = {k: kernel_wrappers()[k].launches
                             for k in EXPORT_OPS}
            if route == "live":
                want = y
            else:
                check(torch.equal(y, want), f"[22] {name} {art}: the "
                      "reloaded program differs from the live step")
        check(counts["live"] == counts["reloaded"] == graph,
              f"[22] {name} {art}: op nodes {graph}, launches {counts}")
        # the median of EXPORT_BUSY_ROUNDS interleaved readings a route: one
        # reading of 8 calls swung 2% on the same program
        rounds = {"live": [], "reloaded": []}
        with torch.inference_mode():
            for _ in range(EXPORT_BUSY_ROUNDS):
                for route, run in (("live", live), ("reloaded", fn)):
                    rounds[route].append(device_ms_per_call(
                        torch, lambda: run(x), 8))
        busy = {k: None if None in v else float(np.median(v))
                for k, v in rounds.items()}
        if None not in busy.values():
            check(abs(busy["reloaded"] - busy["live"])
                  <= EXPORT_BUSY_TOL * busy["live"],
                  f"[22] {name} {art}: device busy {busy}")
        arts[art] = dict(mb=mb[art], op_nodes=graph, device_ms=busy,
                         device_ms_rounds=rounds,
                         input=meta["artifacts"][art]["input"])
    del live_model, cast, loaded
    torch.cuda.empty_cache()
    log(f"[22] export_model --verify {name} (bf16, {config['loader']['crop']}"
        f"): export {timing['export_s']:.1f} s, load {timing['load_s']:.1f} s"
        f"; " + "; ".join(
            f"{k} {v['mb']:.1f} MB, input {v['input']}, op nodes "
            f"{v['op_nodes']} = live launches, busy live "
            f"{v['device_ms']['live']} / reloaded "
            f"{v['device_ms']['reloaded']} ms" for k, v in arts.items())
        + f"; reloaded == live bit for bit; on {card}")
    return dict(export_s=timing["export_s"], load_s=timing["load_s"],
                artifacts=arts)


def phase_close(torch, dev, config, state_dict, card):
    """Phase 22: the modules that close the port, at full width."""
    import shutil
    t_phase = time.perf_counter()
    hw = tuple(config["loader"]["crop"])
    sep, shapes = sep_conv_layers(torch, dev, config, state_dict, card)
    sdsa = sdsa_attention(torch, dev, hw, card)
    local = local_plain_proj(torch, dev, hw, card)
    root = os.path.join(ROOT, "sdformerflow_tpu_torch", "_build",
                        "smoke_zoo_export")
    shutil.rmtree(root, ignore_errors=True)
    exports = {name: zoo_export(torch, dev, root, name, card)
               for name in ZOO_EXPORTS}
    phase_s = time.perf_counter() - t_phase
    log(f"[22] phase 22: {phase_s:.1f} s")
    launches = {
        "K2": {"sep_conv_eval": {k: v["eval_bf16"]["k2"]
                                 for k, v in sep.items()},
               "sep_conv_train": {k: v["train_f32"]["k2"]
                                  for k, v in sep.items()},
               "sdsa_eval": sdsa["eval_bf16"]["k2"],
               "sdsa_train": sdsa["train_f32"]["k2"],
               "local_plain_proj": local["eval_bf16"]["k2"]},
        "K2b": {"sep_conv_train": {k: v["train_f32"]["k2b"]
                                   for k, v in sep.items()},
                "sdsa_train": sdsa["train_f32"]["k2b"]}}
    export_launches = {k: {f"{n}/{a}": v["op_nodes"][k]
                           for n, e in exports.items()
                           for a, v in e["artifacts"].items()}
                       for k in EXPORT_OPS}
    return dict(sep_conv=sep, en4_shapes={k: [list(s), c] for k, (s, c)
                                          in shapes.items()},
                sdsa=sdsa, local_plain_proj=local, zoo_exports=exports,
                launches=launches, launches_export=export_launches,
                phase_s=phase_s)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    try:
        from sdformerflow_tpu_torch.ops import hopper_attn, hopper_psn
        from sdformerflow_tpu_torch.serving import FlowServer
    except ImportError as e:
        print(f"FAIL: run from the repository root ({e})", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    dev = torch.device("cuda", 0)
    # float32 means float32 in every phase (bf16 work is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.get_device_name(0)} [{card}]")
    t_start = time.perf_counter()
    try:
        build_s = phase_build(torch, dev)
        config, state_dict = load_en4(torch)
        server = FlowServer(config, state_dict, device=dev, bf16=True)
        try:
            hw = tuple(config["loader"]["crop"])
            attn_in, psn_sites = capture_sites(
                torch, server.model, lambda: server.infer(
                    voxel_requests(1, 10, hw, SEED + 7)[0]))
            check(len(attn_in) == 12, f"{len(attn_in)} attention sites")
            with torch.inference_mode():
                k1 = phase_k1(torch, dev, attn_in)
                k2 = phase_k2(torch, dev, psn_sites)
            del attn_in
            rates = k1["rates"]
            log(f"[2] K1 output firing rate per block: "
                + ", ".join(f"{r:.3f}" for r in rates))
            check(all(0.0 < r < 1.0 for r in rates),
                  "K1 sites fire all-0 or all-1: the checks would be vacuous")
            k3 = phase_k3(torch, dev)
            sl = phase_slice(torch, server, hw, card)
            evp = phase_events(torch, dev, server, card)
        finally:
            server.close()
        ab = phase_ab(torch, dev, config, state_dict)
        k2b = phase_k2b(torch, dev, config, state_dict)
        odd = phase_odd_m(torch, dev)
        tr = phase_train(torch, dev, config, state_dict, card)
        emb = phase_embed(torch, dev, config, state_dict, card)
        dsec = phase_dsec_eval(torch, dev, config, state_dict, card)
        ann = phase_ann(torch, dev, card)
        mdr = phase_mdr(torch, dev, card)
        deploy = phase_deploy(torch, dev, config, state_dict, card)
        slice16 = phase_train_slice(torch, dev, config, state_dict, card)
        zoo = phase_zoo(torch, dev, card)
        tel = phase_telemetry(torch, dev, config, state_dict, card)
        dp = phase_dp(torch, dev, config, state_dict, card)
        prep = phase_prep(torch, dev, config, state_dict, card)
        surface = phase_train_surface(torch, dev, config, state_dict, card)
        close = phase_close(torch, dev, config, state_dict, card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    check_no_jax = [m for m in sys.modules
                    if m in ("jax", "sdformerflow_tpu")
                    or m.startswith(("jax.", "sdformerflow_tpu."))]
    if check_no_jax:
        print(f"FAIL: JAX modules imported: {check_no_jax[:5]}",
              file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s "
        f"(build {build_s:.1f} s)")
    # launches: the raw-events path's run (phase 6); K1 and K2 also give
    # the voxel path's (phase 5); K2b per train step (phase 9); K4, K4a and
    # K2c the fused-embed path's counted run (phase 10; no path runs K2c);
    # K1, K2 and K3 also each eval_dsec run's (phase 12, 4 windows); the
    # ANN paths (phase 13) launch none; the MDR / MVSEC runs' (phase 14):
    # train_mdr en4 (K2, K2b and the validations' K1), train_mdr STT (none)
    # and eval_mvsec dt1 / dt4; the exported programs' (phase 15): 8 voxel
    # and 8 events requests reloaded in a fresh process; the folded serving
    # forward's and the s2d_train step's (phase 16); the SNN zoo's (phase
    # 17): K2 a SEW request and train step, K2b a SEW train step, K1 and K2
    # an MS_SpikingformerFlowNet forward, K2 a SpikingMultiResUNet forward;
    # the data preparation's (phase 20): K3 a window of preprocess_dsec,
    # K1 and K2 the chained eval_dsec and eval_mvsec runs; the en4 step's
    # plain and under remat dots / all, and a dp1 x tp2 rank's (phase 21);
    # the Sep-conv layers', the SDSA attention's and the Local embed's, and
    # the op nodes (= launches) of every family's exported programs (phase
    # 22)
    kernels = [
        {"name": "K1 fused spiking-QK attention interior", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/qk_attn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_attn.py:382",
         "launches": evp["k1"], "launches_voxel_path": sl["k1"],
         "launches_dsec_eval": {k: v["K1"]
                                for k, v in dsec["launches"].items()},
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": None,
         "earlier_ms": k1["earlier_ms"], "device_ms": k1["device_ms"],
         "earlier_device_ms": k1["earlier_device_ms"],
         "flip_share": k1["flip_share"]},
        {"name": "K2 fused affine PSN forward", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/psn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_psn.py:80",
         "launches": evp["k2"], "launches_voxel_path": sl["k2"],
         "launches_dsec_eval": {k: v["K2"]
                                for k, v in dsec["launches"].items()},
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "device_ms": k2["device_ms"],
         "earlier_device_ms": k2["earlier_device_ms"],
         "graph_ms": k2["graph_ms"],
         "earlier_graph_ms": k2["earlier_graph_ms"],
         "flip_share": k2["flip_share"],
         "launches_train_step": tr["launches_per_step"]["K2"],
         "h_device_ms": tel["k2_h"]["h_device_ms"],
         "h_graph_ms": tel["k2_h"]["h_graph_ms"],
         "h_plain_ms": tel["k2_h"]["h_plain_ms"],
         "h_bound_ms": tel["k2_h"]["h_bound_ms"],
         "h_max_abs_err": tel["k2_h"]["max_abs_err"],
         "h_max_rel_err": tel["k2_h"]["h_max_rel_err"]},
        {"name": "K2b fused PSN surrogate backward with its parameter "
                 "reductions (float32, per train step)", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/psn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_psn.py:115",
         "launches": tr["launches_per_step"]["K2b"],
         "max_abs_err": k2b["max_abs_err"],
         "max_rel_err": k2b["max_rel_err"], "ms": k2b["ms"],
         "plain_ms": k2b["plain_ms"], "bound_ms": k2b["bound_ms"],
         "bound_by": k2b["bound_by"], "library_ms": None,
         "device_ms": k2b["device_ms"], "graph_ms": k2b["graph_ms"],
         "bf16_ms": k2b["bf16_ms"],
         "param_grads_ms": k2b["param_grads_ms"]},
        {"name": "K3 event voxel-grid scatter (signed, 10x480x640, 2^20 "
                 "slots)", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/voxel.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_voxel.py:135",
         "launches": evp["k3"],
         "launches_dsec_eval": dsec["launches"]["events"]["K3"],
         "max_abs_err": k3["max_abs_err"],
         "uniform_max_abs_err": k3["uniform_max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "device_ms": k3["device_ms"], "graph_ms": k3["graph_ms"],
         "earlier_device_ms": k3["earlier_device_ms"],
         "earlier_graph_ms": k3["earlier_graph_ms"], "tiles": k3["tiles"]},
        {"name": "K4 channels-second conv + BN affine (bf16, the 8 "
                 "launches of one fused-embed request)", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/conv_cs.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_embed.py:202",
         "launches": emb["launches"]["K4"],
         "max_abs_err": emb["k4"]["max_abs_err"],
         "max_rel_err": emb["k4"]["max_rel_err"],
         "bf16_max_rel_err": emb["k4"]["bf16_max_rel_err"],
         "ms": emb["k4"]["ms"], "plain_ms": emb["k4"]["plain_ms"],
         "bound_ms": emb["k4"]["bound_ms"], "bound_by": emb["k4"]["bound_by"],
         "library_ms": emb["k4"]["library_ms"], "f32_ms": emb["k4"]["f32_ms"],
         "earlier_ms": emb["k4"]["earlier_ms"],
         "device_ms": emb["k4"]["device_ms"],
         "earlier_device_ms": emb["k4"]["earlier_device_ms"]},
        {"name": "K4a channels-second PSN spike (bf16, the 6 sites of one "
                 "fused-embed request)", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/psn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_embed.py:93",
         "launches": emb["launches"]["K4a"],
         "max_abs_err": emb["k4a"]["max_abs_err"], "ms": emb["k4a"]["ms"],
         "plain_ms": emb["k4a"]["plain_ms"],
         "bound_ms": emb["k4a"]["bound_ms"],
         "bound_by": emb["k4a"]["bound_by"], "library_ms": None,
         "flip_share": emb["k4a"]["flip_share"]},
        {"name": "K2c time-major PSN spike (bf16, [10, 27648, 96] + "
                 "[10, 6912, 96]; on no path)", "route": "cuda",
         "source": "sdformerflow_tpu_torch/csrc/psn.cu",
         "replaces": "sdformerflow_tpu/ops/pallas_psn.py:224",
         "launches": emb["launches"]["K2c"],
         "max_abs_err": emb["k2c"]["max_abs_err"], "ms": emb["k2c"]["ms"],
         "plain_ms": emb["k2c"]["plain_ms"],
         "bound_ms": emb["k2c"]["bound_ms"],
         "bound_by": emb["k2c"]["bound_by"], "library_ms": None,
         "flip_share": emb["k2c"]["flip_share"]},
    ]
    for entry, key in zip(kernels, ("K1", "K2", "K2b", "K3", "K4", "K4a",
                                    "K2c")):
        entry["launches_ann_paths"] = ann["kernel_launches"][key]
        entry["launches_mdr_mvsec"] = {run: counts[key] for run, counts
                                       in mdr["launches"].items()}
        entry["launches_export"] = deploy["launches_export"][key]
        entry["launches_folded_forward"] = slice16["folded"]["launches"] \
            .get(key, 0)
        entry["launches_s2d_train_step"] = slice16["s2d_train"]["launches"] \
            .get(key, 0)
        entry["launches_zoo"] = zoo["launches"].get(key, 0)
        entry["launches_telemetry"] = tel["collecting_launches"][key]
        entry["launches_dp_step"] = \
            dp["step"]["ranks"][0]["launches"].get(key, 0)
        entry["launches_dp_serving"] = {
            kind: v["launches"].get(key, 0) for kind, v in
            dp["serving"]["servers"][f"devices=[{dev}] * 2"].items()}
        entry["launches_data_prep"] = {run: counts[key] for run, counts
                                       in prep["launches"].items()}
        entry["launches_remat_step"] = {
            policy: r["launches"].get(key, 0)
            for policy, r in surface["remat"]["steps"].items()}
        entry["launches_tp_step"] = \
            surface["tp"]["ranks"][0]["launches"].get(key, 0)
        entry["launches_close"] = close["launches"].get(key, 0)
        entry["launches_zoo_export"] = close["launches_export"].get(key, 0)
    log(json.dumps({"voxel_path": {
        "p50_ms": sl["p50"], "p90_ms": sl["p90"],
        "windows_per_s": sl["windows_per_s"],
        "device_ms_per_request": sl["device_ms"]},
        "events_path": {k: v for k, v in evp.items()
                        if k not in ("k1", "k2", "k3")},
        "f32_ab": ab}))
    log(json.dumps({"k3": {k: {m: round(v, 5) if isinstance(v, float)
                                   else v for m, v in r.items()}
                               for k, r in k3["rows"].items()}}))
    log(json.dumps({"odd_window_count": odd}))
    log(json.dumps({"train": tr}))
    log(json.dumps({"embed": {k: v for k, v in emb.items()
                              if k not in ("k4", "k4a", "k2c")}}))
    log(json.dumps({"dsec_eval": dsec}))
    log(json.dumps({"ann": ann}))
    log(json.dumps({"mdr_mvsec": mdr}))
    log(json.dumps({"deploy": deploy}))
    log(json.dumps({"train_slice": slice16}))
    log(json.dumps({"zoo": zoo}))
    log(json.dumps({"telemetry": tel}))
    log(json.dumps({"dp": dp}))
    log(json.dumps({"data_prep": prep}))
    log(json.dumps({"train_surface": surface}))
    log(json.dumps({"close": close}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
