"""The port's optimizers and schedules (``training/optim.py``) against the
JAX package's ``build_optimizer`` (optax), in float64.

Each case runs 6 optimizer updates of a small parameter tree (a telemetry
leaf ``attn_sn`` without a gradient on the port's side, with JAX's
structural zero gradient on the JAX side) and holds every parameter after
every micro-step to rtol 1e-12: Adam, SGD with momentum, AdamW under
``num_acc`` 2 and 3 with a clipped and a non-finite micro-batch, and the
OneCycle and multistep schedules at ``num_acc`` 2. The OneCycle staircase
is also held against torch's ``OneCycleLR`` stepped once an epoch (the
JAX package's ``tests/test_schedules.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdformerflow_tpu.training import optim as j_optim
from sdformerflow_tpu_torch.training import optim

N_UPDATES = 6

# name -> (build_optimizer kwargs, num_acc, micro-step with a NaN or None)
CASES = {
    "adam": (dict(name="Adam", scheduler="multistep", milestones=[2]), 1,
             None),
    "sgd": (dict(name="SGD", scheduler="multistep", milestones=[2]), 1,
            None),
    "adamw_acc2_nonfinite": (dict(name="AdamW", weight_decay=0.05,
                                  scheduler="multistep", milestones=[1]),
                             2, 7),
    "adamw_acc3_nonfinite": (dict(name="AdamW", weight_decay=0.05,
                                  scheduler="multistep", milestones=[1]),
                             3, 13),
    "onecycle_acc2": (dict(name="AdamW", scheduler="one_cycle",
                           n_epochs=3), 2, None),
    "multistep_acc2": (dict(name="SGD", scheduler="multistep",
                            milestones=[1, 2]), 2, None),
}


def _tree(seed, n_micro, nan_at):
    """Parameters and ``n_micro`` gradients: one micro-step's norm above
    the clip (100), one with a NaN at ``nan_at``."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((3, 4)), "b": rng.standard_normal(5),
              "attn_sn": rng.standard_normal((2, 2))}
    grads = []
    for i in range(n_micro):
        scale = 120.0 if i == 2 else 1.0
        g = {k: rng.standard_normal(v.shape) * scale
             for k, v in params.items() if k != "attn_sn"}
        if i == nan_at:
            g["b"][3] = np.nan
        grads.append(g)
    return params, grads


def _jax_run(kw, params, grads):
    with jax.enable_x64(True):
        tx = j_optim.build_optimizer(**kw)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)

        @jax.jit
        def step(jg, state, jp):
            upd, state = tx.update(jg, state, jp)
            return optax.apply_updates(jp, upd), state

        out = []
        for g in grads:
            jg = {k: jnp.asarray(v) for k, v in g.items()}
            jg["attn_sn"] = jnp.zeros_like(jp["attn_sn"])
            jp, state = step(jg, state, jp)
            out.append({k: np.asarray(v) for k, v in jp.items()})
    return out


def _port_run(kw, params, grads, resume_at=None):
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = optim.build_optimizer(tp.items(), **kw)
    out = []
    for i, g in enumerate(grads):
        if i == resume_at:     # a fresh optimizer from the state so far
            state = opt.state_dict()
            opt = optim.build_optimizer(tp.items(), **kw)
            opt.load_state_dict(state)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy()) if k in g else None
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in tp.items()})
    return out, opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_f64(case):
    kw, num_acc, nan_at = CASES[case]
    kw = dict(kw, lr=1e-2, steps_per_epoch=2 * num_acc, clip_grad=100.0,
              num_acc=num_acc)
    params, grads = _tree(sorted(CASES).index(case), N_UPDATES * num_acc,
                          nan_at)
    want = _jax_run(kw, params, grads)
    got, opt = _port_run(kw, params, grads, resume_at=num_acc + 1)
    for i, (w, g) in enumerate(zip(want, got)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-12, atol=0,
                                       err_msg=f"{case} micro-step {i} {k}")
    np.testing.assert_array_equal(got[-1]["attn_sn"], params["attn_sn"])
    assert not np.array_equal(got[-1]["a"], params["a"])
    assert opt.gradient_step == N_UPDATES and opt.mini_step == 0
    if nan_at is None:
        assert int(opt.count) == N_UPDATES
        assert int(opt.notfinite_count) == 0
    else:
        # the NaN poisons its window's mean and, as optax's accumulator
        # is reset by 0 * acc, every later one: those updates are skipped
        done = nan_at // num_acc
        assert int(opt.count) == done
        assert int(opt.notfinite_count) == N_UPDATES - done
        np.testing.assert_array_equal(got[-1]["a"],
                                      got[done * num_acc - 1]["a"])


def test_state_dicts_do_not_cross_optimizers():
    p = [("w", torch.nn.Parameter(torch.zeros(3, dtype=torch.float64)))]
    states = {}
    for name in ("AdamW", "Adam", "SGD"):
        opt = optim.build_optimizer(p, name=name, num_acc=2)
        p[0][1].grad = torch.ones(3, dtype=torch.float64)
        opt.step()
        states[name] = opt.state_dict()
        assert states[name]["mini_step"] == 1
    for name, state in states.items():
        for other in states:
            opt = optim.build_optimizer(p, name=other, num_acc=2)
            if other == name:
                opt.load_state_dict(state)
                assert opt.mini_step == 1 and torch.equal(opt.acc,
                                                          state["acc"])
            else:
                with pytest.raises(ValueError, match=name):
                    opt.load_state_dict(state)


@pytest.mark.parametrize("num_acc,steps_per_epoch", [(1, 3), (2, 4), (2, 3)])
def test_onecycle_counts_updates_and_matches_torch(num_acc, steps_per_epoch):
    """The staircase against torch's OneCycleLR (total_steps n_epochs +
    100, pct_start 0.01, linear, stepped once an epoch) and against JAX's
    schedule, counted in updates: ceil(steps_per_epoch / num_acc) a
    epoch."""
    lr, n_epochs = 5e-4, 60
    upe = -(-steps_per_epoch // num_acc)
    p = torch.nn.Parameter(torch.zeros(1))
    ref = torch.optim.SGD([p], lr=lr)
    sched = torch.optim.lr_scheduler.OneCycleLR(
        ref, max_lr=lr, total_steps=n_epochs + 100, pct_start=0.01,
        cycle_momentum=False, anneal_strategy="linear")
    ours = optim.build_optimizer(
        [("w", p)], name="SGD", lr=lr, scheduler="one_cycle",
        n_epochs=n_epochs, steps_per_epoch=steps_per_epoch,
        num_acc=num_acc).schedule
    with jax.enable_x64(True):
        j_sched = j_optim.onecycle_schedule(lr, n_epochs, upe)
        count = 0
        for epoch in range(n_epochs):
            torch_lr = ref.param_groups[0]["lr"]
            for _ in range(upe):
                got = float(ours(torch.tensor(count)))
                np.testing.assert_allclose(got, torch_lr, rtol=1e-6,
                                           err_msg=f"epoch {epoch}")
                np.testing.assert_allclose(got, float(j_sched(count)),
                                           rtol=1e-12)
                count += 1
            ref.step()      # no gradient: only keeps torch's order
            sched.step()
    assert float(ours(torch.tensor(0))) == pytest.approx(lr / 25.0)


def test_unknown_scheduler_raises():
    """The port's one deviation from JAX's build_optimizer, which falls
    back to a constant lr for a name it does not know."""
    p = [("w", torch.nn.Parameter(torch.zeros(2)))]
    with pytest.raises(NotImplementedError, match="cosine"):
        optim.build_optimizer(p, scheduler="cosine")
    const = optim.build_optimizer(p, scheduler="constant", lr=3e-4).schedule
    assert float(const(torch.tensor(10 ** 6))) == pytest.approx(3e-4)
