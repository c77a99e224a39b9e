"""Shared checks of the SNN-zoo parity tests (tests/test_torch_port_zoo_*):
one JAX model and its port on the same randomized float64 variables, the
eval and the train forward (one JAX compile for both), the running
statistics after the train forward."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdformerflow_tpu.ops.normalization import encode_input as j_encode
from sdformerflow_tpu_torch.ops.normalization import encode_input
from sdformerflow_tpu_torch.training.from_jax import from_jax

from torch_port_harness import (init_pair,  # noqa: F401
                                 one_torch_thread, to_torch)

# spikes are exact 0/1 on both sides: a wrong pairing shows as an O(1)
# difference; 1e-9 of the largest flow absorbs float64 summation order
FLOW_TOL = 1e-9
STAT_TOL = 1e-9


def rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def eval_and_train_match(jmodel, tmodel, *, num_bins=4, size=(32, 32),
                         seed=5):
    """Hold ``tmodel`` against ``jmodel`` in eval and in train mode on one
    randomized chunk; returns the JAX variables."""
    chunk = np.random.default_rng(seed).standard_normal((1, num_bins) + size)
    with jax.enable_x64(True):
        x_enc = np.asarray(j_encode(jnp.asarray(chunk)))
    # the shapes in float32 (JAX's GLIF init mixes float32 and float64
    # under x64); every leaf is drawn anew in float64
    variables = init_pair(jmodel, tmodel, x_enc, seed=seed + 1)
    with jax.enable_x64(True):

        @jax.jit
        def both(v, z):
            ev = jmodel.apply(v, z, False)["flow"]
            tr, mut = jmodel.apply(v, z, True, mutable=["batch_stats"])
            return ev, tr["flow"], mut

        want_eval, want_train, mut = both(variables, jnp.asarray(x_enc))
    x = encode_input(to_torch(chunk))
    with torch.no_grad():
        got_eval = tmodel.eval()(x)["flow"]
        got_train = tmodel.train()(x)["flow"]
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float64 and g.shape == w.shape
            assert np.abs(np.asarray(w)).max() > 0
            assert rel(g.numpy(), w) <= FLOW_TOL
    if "batch_stats" in mut:
        after = from_jax(dict(variables, batch_stats=jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"])), tmodel)
        sd = tmodel.state_dict()
        stats = [k for k in sd if "running" in k]
        assert stats
        for k in stats:
            np.testing.assert_allclose(sd[k].numpy(), after[k].numpy(),
                                       rtol=STAT_TOL, atol=STAT_TOL,
                                       err_msg=k)
    return variables
