"""The port's learning-rate schedulers (``paddle_tpu_torch/optimizer/
lr.py``) against the JAX package's (``paddle_tpu/optimizer/lr.py``).

Both are host Python floats, so every scheduler's ``get_lr()`` must
equal the JAX one's float for float over 50 steps (tolerance 0), and
``state_dict`` must carry the same keys and values.  Mirrors
``tests/test_optimizer.py::test_lr_schedulers`` and
``::test_scheduler_drives_optimizer`` and
``tests/test_utils.py::test_multiplicative_and_linear_lr``; the
optimizer side checks that the device learning-rate scalar follows the
scheduler.
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.optimizer import lr as tlr
from torch_parity_helpers import torch_one_thread  # noqa: F401

STEPS = 50


def _plateau_metrics():
    """A loss that falls, stalls, then falls: ReduceOnPlateau cuts the
    rate during the stall."""
    vals = [1.0 / (1 + k) for k in range(10)] + [0.1] * 15 + \
        [0.1 - 0.001 * k for k in range(25)]
    return vals


CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                        learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 20, 33],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.3),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 20, end_lr=1e-3,
                                                   power=2.0),
    "PolynomialDecay cycle": lambda m: m.PolynomialDecay(
        0.1, 7, end_lr=1e-3, power=0.5, cycle=True),
    "LinearWarmup float": lambda m: m.LinearWarmup(0.1, 8, 0.0, 0.1),
    "LinearWarmup into PolynomialDecay": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-4, 16, end_lr=1e-5, power=1.0), 4, 0.0, 1e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, [3, 17, 40],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.2, lambda e: 0.97 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=23, eta_min=1e-3),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-4),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=3, cooldown=2, min_lr=1e-3),
    "OneCycleLR cos": lambda m: m.OneCycleLR(0.1, total_steps=40),
    "OneCycleLR linear": lambda m: m.OneCycleLR(
        0.1, total_steps=30, anneal_strategy="linear", phase_pct=0.25),
    "CyclicLR triangular": lambda m: m.CyclicLR(0.01, 0.1, 6),
    "CyclicLR triangular2": lambda m: m.CyclicLR(0.01, 0.1, 4, 7,
                                                 mode="triangular2"),
    "CyclicLR exp_range": lambda m: m.CyclicLR(0.01, 0.1, 5,
                                               mode="exp_range",
                                               exp_gamma=0.95),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 3 else 0.99),
    "LinearLR": lambda m: m.LinearLR(0.2, total_steps=17,
                                     start_factor=0.25, end_factor=1.5),
}


def _run(sched, metrics=None):
    rates = []
    for k in range(STEPS):
        rates.append(sched.get_lr())
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[k])
    return rates


def _state(sched):
    return {k: (_state(v) if isinstance(v, (jlr.LRScheduler,
                                            tlr.LRScheduler)) else v)
            for k, v in sched.state_dict().items() if not callable(v)}


@pytest.mark.parametrize("name", list(CASES))
def test_rates_equal_the_jax_package_float_for_float(name):
    metrics = _plateau_metrics() if name == "ReduceOnPlateau" else None
    j, t = CASES[name](jlr), CASES[name](tlr)
    jr = _run(j, metrics)
    tr = _run(t, None if metrics is None else
              [torch.tensor(v, dtype=torch.float64) for v in metrics])
    assert tr == jr
    assert len(set(jr)) > 1, "the schedule never moved"
    assert _state(t) == _state(j)
    assert type(t).__name__ == type(j).__name__


def test_every_scheduler_of_the_jax_package_is_ported():
    jnames = {n for n, c in vars(jlr).items()
              if isinstance(c, type) and issubclass(c, jlr.LRScheduler)}
    tnames = {n for n, c in vars(tlr).items()
              if isinstance(c, type) and issubclass(c, tlr.LRScheduler)}
    assert jnames == tnames and len(jnames) == 18   # 17 and the base
    covered = {n.split(" ")[0] for n in CASES}
    assert covered == jnames - {"LRScheduler"}


def test_set_state_dict_resumes_mid_schedule():
    """A scheduler restored from another's ``state_dict`` mid-warmup
    gives the same rates as the one that ran on, in both packages'
    directions."""
    for src_mod, dst_mod in ((tlr, tlr), (jlr, tlr), (tlr, jlr)):
        src = CASES["LinearWarmup into PolynomialDecay"](src_mod)
        for _ in range(3):
            src.step()
        dst = CASES["LinearWarmup into PolynomialDecay"](dst_mod)
        sd = {k: v for k, v in src.state_dict().items() if k != "lr_after"}
        sd["lr_after"] = type(dst.lr_after).__new__(type(dst.lr_after))
        sd["lr_after"].__dict__.update(src.lr_after.state_dict())
        dst.set_state_dict(sd)
        assert _run(dst)[:20] == _run(src)[:20]


def test_lr_schedulers():
    lr = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    vals = []
    for _ in range(5):
        vals.append(round(lr.get_lr(), 6))
        lr.step()
    assert vals == [0.1, 0.1, 0.05, 0.05, 0.025]
    warm = tlr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1)
    v0 = warm.get_lr()
    for _ in range(4):
        warm.step()
    assert v0 == 0.0 and abs(warm.get_lr() - 0.1) < 1e-9
    cos = tlr.CosineAnnealingDecay(1.0, T_max=10)
    assert abs(cos.get_lr() - 1.0) < 1e-9
    noam = tlr.NoamDecay(d_model=512, warmup_steps=10, learning_rate=1.0)
    assert noam.get_lr() > 0


def test_scheduler_drives_optimizer():
    """``get_lr`` follows the scheduler; ``set_lr`` refuses under one;
    the device scalar the update reads takes the new rate at the next
    refresh and the update uses it."""
    sched = tlr.StepDecay(0.5, step_size=1, gamma=0.1)
    p = torch.nn.Parameter(torch.ones(1))
    opt = tpaddle.optimizer.SGD(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.5
    p.grad = torch.ones(1)
    opt.step()
    assert p.item() == pytest.approx(0.5)
    sched.step()
    assert abs(opt.get_lr() - 0.05) < 1e-9
    scalar = opt._lr_scalar(p.device)
    assert scalar.item() == pytest.approx(0.5)     # not refreshed yet
    opt.step()
    assert scalar.item() == np.float32(0.05)
    assert p.item() == pytest.approx(0.45)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    plain = tpaddle.optimizer.SGD(learning_rate=0.5, parameters=[p])
    plain.set_lr(0.25)
    assert plain.get_lr() == 0.25


def test_multiplicative_and_linear_lr():
    m = tlr.MultiplicativeDecay(1.0, lambda e: 0.5)
    vals = []
    for _ in range(3):
        vals.append(m.get_lr())
        m.step()
    assert vals == [1.0, 0.5, 0.25]
    lin = tlr.LinearLR(1.0, total_steps=4, start_factor=0.5, end_factor=1.0)
    vals = []
    for _ in range(6):
        vals.append(round(lin.get_lr(), 4))
        lin.step()
    assert vals == [0.5, 0.625, 0.75, 0.875, 1.0, 1.0]
    assert math.isclose(tlr.LinearLR(2.0, 3).get_lr(), 2.0 / 3.0)
