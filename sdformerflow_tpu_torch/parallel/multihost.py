"""Multi-process data parallelism, the port of
``sdformerflow_tpu/parallel/multihost.py``.

JAX runs one process per host and one SPMD program over a global mesh whose
data axis spans every device: a step is the step of the global batch, the
batch statistics and the loss normaliser are global because GSPMD reduces
over the whole sharded batch. The port runs one process per card
(``torchrun``; ``torch.distributed``, NCCL on the card, gloo on the CPU or
for two ranks on one card) and makes each rank compute its share of that
same global step:

- :func:`initialize` joins the process group (from ``torchrun``'s
  environment, or from explicit arguments on a test rig);
- :func:`shard_indices` / :class:`ProcessShardedDataset` give each rank its
  slice of a global permutation, index for index as JAX's;
- :func:`batch_moments` is the one helper behind every batch-statistics
  norm of the port (``models/spiking_layers.py``): the global count, mean
  and biased variance, differentiable through their all-reduces;
- :func:`global_rows` draws a per-sample random tensor at the global batch
  shape and keeps this rank's rows (drop path, the "Drop" augmentation), so
  R ranks draw what one process would;
- :func:`gather_rows` / :func:`own_rows` run a layer whose function mixes
  the rows of a batch on the global batch (the spiking swin blocks' raw
  window refold, ``models/spiking_swin.py``);
- :func:`all_reduce_sum` sums a tensor over the ranks (the flat gradient
  in ``training/optim.py``, the loss normaliser in ``losses.py``);
- :func:`broadcast_state` stands for JAX's ``replicate_global``: rank 0's
  parameters, buffers and optimizer state, once at start and after a
  resume (JAX relies on every process drawing the same init from a shared
  seed);
- :func:`establish_collectives` runs one tiny all-reduce at start-up,
  :func:`process_mean` means a host scalar over the ranks in float64.

A ``group`` argument is a ``torch.distributed`` process group or None. No
group, or a group of one, leaves every function of the port exactly as it
is in one process. :func:`make_multihost_mesh` is JAX's
``make_multihost_mesh(n_model)``: the world's ranks as a (data, model) grid,
rank = d * n_model + m, with this rank's data group (the ranks of its model
index: the batch's rows are split over it) and model group (the ranks of its
data slice: tensor parallelism, ``parallel/sharding_rules.py``). Every
``group`` above is a data group. JAX's ``global_batch`` has no tensor
counterpart: each rank keeps its local rows on its own card and nothing
assembles a global array.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               timeout_s: float = 600.0):
    """Join the default process group. Under ``torchrun`` every value comes
    from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR/PORT``);
    a test rig passes ``init_method`` (``file://`` or ``tcp://``),
    ``world_size`` and ``rank``. The backend defaults to NCCL where a card
    is visible and to gloo elsewhere. A second call is a no-op."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def join_launcher_group(device) -> bool:
    """Join the process group of a ``torchrun`` launch (``WORLD_SIZE`` in
    the environment) unless one exists: NCCL for a CUDA ``device``, gloo
    for the CPU. Returns whether it joined, so that the caller leaves the
    group at its end (:func:`leave`)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    initialize(backend="nccl" if torch.device(device).type == "cuda"
               else "gloo")
    return True


def leave():
    """Leave the default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The number of processes of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_group():
    """The data-parallel group of a run: the default group when it spans
    more than one process, else None (the one-process forms)."""
    return dist.group.WORLD if process_count() > 1 else None


def active(group) -> bool:
    """Whether ``group`` spans more than one rank (else every function of
    the port runs its one-process form)."""
    return group is not None and dist.get_world_size(group) > 1


def rank_of(group) -> int:
    """This process's rank in ``group`` (0 with no active group)."""
    return dist.get_rank(group) if active(group) else 0


class Mesh(NamedTuple):
    """This rank's place in the (data, model) grid of the world's ranks
    (:func:`make_multihost_mesh`): its data group and model group (None
    where that axis has one rank), the axes' sizes and its indices."""
    data: object
    model: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int


def make_multihost_mesh(n_model: int = 1) -> Mesh:
    """The world's ranks as a grid of ``process_count() // n_model`` data
    slices of ``n_model`` model ranks, laid out as JAX's
    ``devs.reshape(n_data, n_model)``: rank = d * n_model + m. Every rank
    must call it (it creates the groups, in one order on every rank). With
    ``n_model == 1`` the data group is :func:`world_group`'s."""
    world, rank = process_count(), process_index()
    n_model = int(n_model)
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} does not divide the "
                         f"{world} rank(s)")
    n_data = world // n_model
    d, m = divmod(rank, n_model)
    if n_model == 1:
        return Mesh(world_group(), None, n_data, 1, d, 0)
    data = model = None
    for i in range(n_data):
        g = dist.new_group([i * n_model + j for j in range(n_model)])
        if i == d:
            model = g
    if n_data > 1:
        for j in range(n_model):
            g = dist.new_group([i * n_model + j for i in range(n_data)])
            if j == m:
                data = g
    return Mesh(data, model, n_data, n_model, d, m)


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for None or a bare
    ``"cuda"``, else the device the caller named. A rank that asks for a
    card it cannot see raises; a CUDA device becomes the current one (NCCL
    takes it from there)."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return device
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not torch.cuda.is_available() \
            or device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"rank {process_index()} needs {device} but sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " CUDA device(s)")
    torch.cuda.set_device(device)
    return device


def comm_device(group) -> torch.device:
    """Where a host value goes to be reduced: the current card for NCCL,
    the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_count, _index = process_count, process_index   # under the kwargs' names


def shard_indices(n: int, *, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> range:
    """Contiguous per-process slice of ``range(n)``, truncated so every
    process gets the same count (every rank must take as many steps)."""
    pc = _count() if process_count is None else process_count
    pi = _index() if process_index is None else process_index
    per = n // pc
    return range(pi * per, (pi + 1) * per)


class ProcessShardedDataset:
    """View of a dataset restricted to this process's index shard.

    Shuffling happens at the global-index level before sharding, so that
    an epoch is statistically the single-process one: call
    :meth:`reshard` with the epoch's seed instead of shuffling the local
    shard."""

    def __init__(self, dataset, *, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self._pi = _index() if process_index is None else process_index
        self._pc = _count() if process_count is None else process_count
        self._local = list(shard_indices(len(dataset),
                                         process_index=self._pi,
                                         process_count=self._pc))

    @property
    def events_presorted(self):
        # the inner dataset's packer guarantee, seen through the view
        return bool(getattr(self.dataset, "events_presorted", False))

    def reshard(self, seed: int):
        """Global shuffle with ``seed`` (the same on every process), then
        this process's contiguous slice of the permutation."""
        perm = np.random.default_rng(seed).permutation(len(self.dataset))
        per = len(self.dataset) // self._pc
        self._local = perm[self._pi * per:(self._pi + 1) * per].tolist()

    def __len__(self):
        return len(self._local)

    def __getitem__(self, idx):
        return self.dataset[self._local[idx]]


def establish_collectives(group=None):
    """One tiny all-reduce now over ``group`` (None: the default group,
    if this process has one), while the ranks start in step: the first
    collective of a group creates its communicator, and a rank that
    arrives there much later than the others (building kernels, reading
    the first batch) can time the connection out."""
    if not dist.is_initialized():
        return
    one = torch.ones(1, device=comm_device(group))
    dist.all_reduce(one, group=group)
    if int(one.item()) != dist.get_world_size(group):
        raise RuntimeError(f"establish_collectives: sum {one.item()} over "
                           f"{dist.get_world_size(group)} ranks")


def process_mean(value: float, group=None) -> float:
    """Mean of a per-process host scalar over the ranks, in float64."""
    if not active(group):
        return float(value)
    t = torch.tensor([value], dtype=torch.float64,
                     device=comm_device(group))
    dist.all_reduce(t, group=group)
    return float(t.item()) / dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """All-reduce (SUM) whose gradient is the all-reduced gradient: every
    rank's loss depends on the sum, so each rank's input takes the sum of
    the ranks' gradients of it."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (``t`` itself with no
    active group), differentiable: the gradient of the sum is all-reduced
    back to every rank."""
    if not active(group):
        return t
    return _AllReduceSum.apply(t, group)


def batch_moments(xf: torch.Tensor, dims, group):
    """(mean, biased variance, count) of ``xf`` over ``dims``, over the
    rows of every rank of ``group``: one all-reduce of the local sums and
    counts, then one of the squared deviations from the global mean (the
    two-pass form of ``torch.var_mean``). Both are differentiable, so the
    gradients of the statistics reach every rank's rows. The count is a
    device scalar (reading it would wait for the device). With no active
    group: ``torch.var_mean`` and the local count, a float."""
    dims = tuple(dims)
    n_local = 1
    for d in dims:
        n_local *= xf.shape[d]
    if not active(group):
        var, mean = torch.var_mean(xf, dim=dims, correction=0)
        return mean, var, float(n_local)
    s = xf.sum(dim=dims)
    sums = all_reduce_sum(torch.cat([s.reshape(-1), s.new_full(
        (1,), float(n_local))]), group)
    n = sums[-1]
    mean = (sums[:-1] / n).reshape(s.shape)
    d = xf - mean
    var = all_reduce_sum((d * d).sum(dim=dims), group) / n
    return mean, var, n.detach()


class _GatherRows(torch.autograd.Function):
    """All-gather along ``dim``; the gradient of the gathered tensor is
    summed over the ranks (each rank computed from its own copy) and this
    rank's slice taken."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.rank * ctx.rows, ctx.rows), None, None


def gather_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The global batch from every rank's rows along ``dim`` (in rank
    order; every rank holds as many rows), differentiable: for a layer
    whose function mixes a batch's rows, which every rank then computes on
    the whole batch (:func:`own_rows` takes its rows back)."""
    if not active(group):
        return x
    return _GatherRows.apply(x, dim, group)


def own_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (the inverse of
    :func:`gather_rows`)."""
    if not active(group):
        return x
    rows = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * rows, rows)


def global_rows(draw, shape, dim: int, group) -> torch.Tensor:
    """``draw(shape)`` at the global batch: ``shape[dim]`` is this rank's
    row count, every rank holds as many rows and the global batch is the
    ranks' rows in rank order. The draw is made at the global shape (the
    generator advances as one process's would) and this rank's rows are
    kept."""
    if not active(group):
        return draw(tuple(shape))
    r, k = dist.get_rank(group), dist.get_world_size(group)
    shape = list(shape)
    rows = shape[dim]
    shape[dim] = rows * k
    return draw(tuple(shape)).narrow(dim, r * rows, rows)


def broadcast_state(model: torch.nn.Module, optimizer=None, group=None):
    """Every rank takes the parameters and buffers of ``group``'s rank 0
    and, if given, its optimizer's tensors (``state_dict()``, whose tensors
    are the optimizer's own): JAX's ``replicate_global`` of the train
    state."""
    if not active(group):
        return
    src = dist.get_global_rank(group, 0)
    tensors = list(model.state_dict().values())
    if optimizer is not None:
        tensors += [v for v in optimizer.state_dict().values()
                    if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def barrier(group=None):
    if active(group):
        dist.barrier(group=group)
