"""Sparse row gradients of the PyTorch port against the JAX package's
eager ``SelectedRows`` path.

The model is ``chip_smoke.slice21_models``' Wide&Deep (PaddleRec's
``WideDeepLayer``) at a small size: a table of 1000 rows of dim 4
looked up once per slot in 3 slots (row 0 a padding row, which some
ids hit), 5 dense features, ``layer_sizes`` [16, 8], batch 16, written
once and built from either package's ``nn``; the JAX twin takes the
port's weights by name.  Both packages train eagerly
(``backward`` / ``step`` / ``clear_grad``) on the same numpy batches.

What is held, with the tolerances (fp32; the two packages sum the same
terms in another order):
- the merged ``SelectedRows`` of one backward: rows equal (the padding
  row among them with zero values), values within 1e-6 x max(|ref|, 1);
- three steps of SGD, dense Adam, ``Adam(lazy_mode=True)``,
  ``AdamW(lazy_mode=True)``, Momentum (densified) and Adam with an
  ``L1Decay`` on the table (densified): losses within 1e-5 relative,
  every parameter within ``PARAM_TOL`` (1e-5 x max(|ref|, 1): Adam
  divides by each element's own RMS, which the summation order moves
  in the last bits), and the rows no step looked up bit-equal to their
  initial values in both packages (their gradients and moments are 0),
  except under the L1 term, which moves every row; lazy Adam leaves
  their moments 0 and still advances the beta powers;
- the three clips on a sparse gradient, the scaler's skip on an
  injected inf (nothing moves, no moment is made), ``lazy_mode`` on a
  dense table equal to plain Adam bit for bit, and ``Model.fit`` with
  ``jit=False`` (sparse, lazy) and captured (dense: plain Adam), each
  against its JAX counterpart.

The JAX ``AdamW`` never stores ``lazy_mode`` (its ``Adam._sparse_step``
then fails on the missing attribute), so its lazy run sets the
attribute as ``Adam.__init__`` would (ROADMAP C).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.amp import GradScaler as JGradScaler
from paddle_tpu.framework.selected_rows import SelectedRows as JSelectedRows
from paddle_tpu.metric import Auc as JAuc
from paddle_tpu.regularizer import L1Decay as JL1Decay

import chip_smoke
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.metric import Auc as TAuc
from paddle_tpu_torch.ops import manipulation as M
from paddle_tpu_torch.regularizer import L1Decay as TL1Decay
from torch_parity_helpers import CPU, close
from torch_parity_helpers import torch_one_thread  # noqa: F401 (autouse)

ROWS, DIM, FIELDS, DENSE, B = 1000, 4, 3, 5, 16
SIZES = (16, 8)
LR = 0.01
LOSS_RTOL = 1e-5
PARAM_TOL = 1e-5
SR_TOL = 1e-6


def _models(seed=0, sparse=True, padding_idx=0):
    tpaddle.seed(seed)
    kw = dict(sparse_feature_number=ROWS, sparse_feature_dim=DIM,
              dense_feature_dim=DENSE, num_field=FIELDS, layer_sizes=SIZES,
              padding_idx=padding_idx, sparse=sparse)
    tnet = chip_smoke.slice21_models(tnn, M.concat)["WideDeep"](
        device=CPU, **kw)
    with jpaddle.LazyGuard():
        jnet = chip_smoke.slice21_models(jnn, jpaddle.concat)["WideDeep"](
            **kw)
    # copies: a JAX array made from a numpy view may share the port's
    # memory on the CPU, which the port's optimizer updates in place
    jnet.set_state_dict(_tstate(tnet))
    return jnet, tnet


def _data(steps, seed=3):
    data = chip_smoke.widedeep_data(seed, steps, b=B, rows=ROWS,
                                    fields=FIELDS, dense=DENSE)
    for ids, _, _ in data:
        ids[::5, 0] = 0          # the padding row, in some lookups
        ids[1, 2] = ids[1, 1]    # a repeated id across slots
    return data


def _jloss(jnet, batch):
    ids, dense, y = batch
    pred = jnet(jpaddle.to_tensor(ids), jpaddle.to_tensor(dense))
    return jnn.functional.binary_cross_entropy(pred, jpaddle.to_tensor(y))


def _tloss(tnet, batch):
    ids, dense, y = batch
    pred = tnet(torch.from_numpy(ids), torch.from_numpy(dense))
    return tnn.functional.binary_cross_entropy(pred, torch.from_numpy(y))


def _state(net):
    return {k: np.asarray(v.numpy(), np.float32).copy()
            for k, v in net.state_dict().items()}


def _tstate(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def test_merged_selected_rows_match_jax():
    jnet, tnet = _models()
    batch = _data(1)[0]
    _jloss(jnet, batch).backward()
    _tloss(tnet, batch).backward()
    jg = jnet.embedding.weight.grad
    tg = tnet.embedding.weight.grad
    assert isinstance(jg, JSelectedRows) and tg.is_sparse
    sr = tpaddle.SelectedRows.from_grad(tg)
    assert sr.height == ROWS and sr.shape == (ROWS, DIM)
    jm, tm = jg.merged(), sr.merged()
    assert tm.merged() is tm
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    close(tm.values.numpy(), np.asarray(jm.values), SR_TOL, "merged values")
    assert 0 in tm.rows.tolist()
    assert not tm.values[tm.rows == 0].any()
    # every lookup's rows, duplicates included, sum to the merged ones
    ids = batch[0]
    assert len(np.unique(ids)) == len(tm.rows) < ids.size
    close(sr.to_dense().numpy(), np.asarray(jg.to_dense()), SR_TOL, "dense")
    close((sr + torch.zeros(ROWS, DIM)).numpy(), np.asarray(jg.to_dense()),
          SR_TOL, "dense + sparse")
    assert (sr + sr).rows.shape[0] == 2 * sr.rows.shape[0]
    for name, p in tnet.named_parameters():
        if name != "embedding.weight":
            close(p.grad.numpy(), np.asarray(
                dict(jnet.named_parameters())[name].grad.numpy()), SR_TOL,
                name)


OPTIMIZERS = {
    "sgd": lambda m, ps, **kw: m.SGD(LR, parameters=ps, **kw),
    "adam": lambda m, ps, **kw: m.Adam(LR, parameters=ps, **kw),
    "adam lazy": lambda m, ps, **kw: m.Adam(LR, parameters=ps,
                                            lazy_mode=True, **kw),
    "adamw lazy": lambda m, ps, **kw: m.AdamW(LR, parameters=ps,
                                              lazy_mode=True,
                                              weight_decay=0.1, **kw),
    "momentum": lambda m, ps, **kw: m.Momentum(LR, 0.9, parameters=ps, **kw),
    "adam l1 table": lambda m, ps, **kw: m.Adam(LR, parameters=ps, **kw),
}
ROWWISE = ("sgd", "adam lazy", "adamw lazy")


def _optimizers(name, jnet, tnet, clip=None):
    jclip, tclip = clip if clip else (None, None)
    jopt = OPTIMIZERS[name](joptimizer, jnet.parameters(), grad_clip=jclip)
    topt = OPTIMIZERS[name](tpaddle.optimizer, tnet.parameters(),
                            grad_clip=tclip)
    if name == "adamw lazy":
        jopt._lazy_mode = True     # the JAX AdamW drops the argument
    if name == "adam l1 table":
        jnet.embedding.weight.regularizer = JL1Decay(1e-3)
        tnet.embedding.weight.regularizer = TL1Decay(1e-3)
    return jopt, topt


def _train_both(jnet, tnet, jopt, topt, data):
    jl, tl = [], []
    for batch in data:
        jloss, tloss = _jloss(jnet, batch), _tloss(tnet, batch)
        jl.append(float(jloss.numpy()))
        tl.append(float(tloss.detach()))
        jloss.backward()
        tloss.backward()
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        assert tnet.embedding.weight.grad is None
    return jl, tl


def _held(jnet, tnet, what):
    js, ts = _state(jnet), _tstate(tnet)
    for k in ts:
        close(ts[k], js[k], PARAM_TOL, f"{what}: {k}")


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_jax(name):
    jnet, tnet = _models()
    init = tnet.embedding.weight.detach().clone()
    jopt, topt = _optimizers(name, jnet, tnet)
    data = _data(3)
    jl, tl = _train_both(jnet, tnet, jopt, topt, data)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _held(jnet, tnet, name)
    table = tnet.embedding.weight.detach()
    untouched = np.setdiff1d(np.arange(ROWS),
                             np.concatenate([b[0].ravel() for b in data]))
    assert len(untouched) > ROWS // 2
    jtable = np.asarray(jnet.embedding.weight.numpy())
    # a row no step looked up has zero gradients and moments, so no rule
    # moves it, but the L1 term moves every row
    same = not torch.equal(table[untouched], init[untouched])
    assert same == (name == "adam l1 table"), name
    assert np.array_equal(jtable[untouched], init.numpy()[untouched]) != same
    if name.startswith("adam") and name != "adam l1 table":
        st = topt._state[[id(p) for p in topt.parameters()].index(
            id(tnet.embedding.weight))]
        moved = (st["moment2"] != 0).any(1)
        assert moved.sum() > 0
        if name in ROWWISE:
            assert not moved[untouched].any()
            assert float(st["beta1_pow"]) == pytest.approx(0.9 ** 3)


CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.01),
    "norm": lambda m: m.ClipGradByNorm(0.05),
    "global norm": lambda m: m.ClipGradByGlobalNorm(0.05),
}


@pytest.mark.parametrize("clip", list(CLIPS))
def test_clips_of_a_sparse_gradient_match_jax(clip):
    """Two SGD steps through each clip, clipping active (the limits are
    below the gradients' values and norms); the global norm takes the
    merged rows, so duplicate ids sum before they are squared."""
    jnet, tnet = _models()
    pair = (CLIPS[clip](jnn), CLIPS[clip](tnn))
    jopt, topt = _optimizers("sgd", jnet, tnet, pair)
    data = _data(2)
    batch = data[0]
    _tloss(tnet, batch).backward()
    g = tnet.embedding.weight.grad
    clipped = pair[1]([(tnet.embedding.weight, g)])[0][1]
    assert clipped.is_sparse and clipped.is_coalesced()
    merged = g.coalesce().values()
    if clip == "value":
        assert merged.abs().max() > 0.01
    else:
        assert merged.norm() > 0.05
    topt.clear_grad()
    jl, tl = _train_both(jnet, tnet, jopt, topt, data)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _held(jnet, tnet, clip)


def test_scaler_skips_a_step_with_an_inf_in_a_sparse_gradient():
    jnet, tnet = _models()
    jopt, topt = _optimizers("adam lazy", jnet, tnet)
    jsc, tsc = JGradScaler(init_loss_scaling=1024.0), \
        tpaddle.amp.GradScaler(init_loss_scaling=1024.0)
    data = _data(2)
    before = _tstate(tnet)
    for inf in (True, False):
        batch = data[0] if inf else data[1]
        jsc.scale(_jloss(jnet, batch)).backward()
        tsc.scale(_tloss(tnet, batch)).backward()
        if inf:
            jg = jnet.embedding.weight.grad
            jnet.embedding.weight.grad = JSelectedRows(
                jg.rows, jg.values.at[3, 1].set(np.inf), jg.height)
            tnet.embedding.weight.grad._values()[3, 1] = float("inf")
        jsc.step(jopt)
        tsc.step(topt)
        jsc.update()
        tsc.update()
        jopt.clear_grad()
        topt.clear_grad()
        if inf:
            assert tsc._found_inf is False and tsc._scale == 512.0
            after = _tstate(tnet)
            for k in before:
                np.testing.assert_array_equal(after[k], before[k], k)
            assert not topt._state and topt._global_step == 0
    assert tsc._scale == jsc._scale == 512.0
    _held(jnet, tnet, "after the skipped and one good step")


def test_lazy_mode_on_a_dense_table_is_plain_adam():
    data = _data(3)
    ends = []
    for lazy in (False, True):
        jnet, tnet = _models(sparse=False)
        jopt = joptimizer.Adam(LR, parameters=jnet.parameters(),
                               lazy_mode=lazy)
        topt = tpaddle.optimizer.Adam(LR, parameters=tnet.parameters(),
                                      lazy_mode=lazy)
        jl, tl = _train_both(jnet, tnet, jopt, topt, data)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        _held(jnet, tnet, f"dense table, lazy_mode={lazy}")
        ends.append(_tstate(tnet))
    for k in ends[0]:
        np.testing.assert_array_equal(ends[0][k], ends[1][k], k)


class _Losses(tpaddle.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))


class _JLosses(jpaddle.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))


def _fit(net, opt, data, jit, model_cls, loss, metric, cb):
    model = model_cls(net) if model_cls is jpaddle.Model else \
        model_cls(net, device=CPU)
    model.prepare(opt, loss, metric, jit=jit)
    model.fit(data, epochs=1, verbose=0, callbacks=[cb] if cb else None)


@pytest.mark.parametrize("jit", [False, True])
def test_fit_matches_jax(jit):
    """``Model.fit`` with lazy Adam and ``Auc``: with ``jit=False`` the
    step is eager and the table's gradient sparse in both packages (lazy
    rows); captured, the lookup is dense in both, so lazy Adam is plain
    Adam (every row with a moment moves).  The two routes' end states
    differ, which shows which route ran."""
    data = _data(3)
    tdata = [tuple(torch.from_numpy(a) for a in b) for b in data]
    ends = {}
    for route in (jit, not jit):
        jnet, tnet = _models()
        topt = tpaddle.optimizer.Adam(LR, parameters=tnet.parameters(),
                                      lazy_mode=True)
        tcb = _Losses()
        _fit(tnet, topt, tdata, route, tpaddle.Model, tnn.BCELoss(),
             TAuc(), tcb)
        ends[route] = _tstate(tnet)["embedding.weight"]
        if route != jit:
            break
        jopt = joptimizer.Adam(LR, parameters=jnet.parameters(),
                               lazy_mode=True)
        jcb = _JLosses()
        _fit(jnet, jopt, data, route, jpaddle.Model, jnn.BCELoss(),
             JAuc(), jcb)
        np.testing.assert_allclose(tcb.losses, jcb.losses, rtol=LOSS_RTOL)
        _held(jnet, tnet, f"fit jit={route}")
    assert not np.array_equal(ends[True], ends[False])
