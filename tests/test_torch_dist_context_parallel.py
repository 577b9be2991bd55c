"""Context parallelism, Megatron sequence parallelism and ERNIE under
sharding stage 2 at world 4 (gloo, four CPU processes) against the JAX
package on its 8-device CPU mesh.

One world (``torch_dist_workers.context_world``) runs the file's rank
side; the JAX references run here, in the test process, each once:

- ``ring_flash_attention`` (causal and not), the balanced zigzag ring
  and ``ulysses_attention`` at sep 4 on the global q, k, v cut into each
  rank's slices: the joined output and the gradients of the replicated
  inputs against the JAX functions on a sep-4 mesh, 2e-4 / 2e-5 on
  outputs and 5e-4 / 5e-5 on gradients (``tests/test_context_parallel.
  py``'s bounds);
- the zigzag helpers: the layout's indices and their refusals;
- ``DistributedRunner`` on ``gpt_tiny`` at sep 4 and at sep2 x mp2, ring
  and Ulysses, SGD (lr 0.5) with the global-norm clip, 3 steps, against
  the JAX ``DistributedRunner`` on the same layouts: losses and every
  weight at rtol 5e-4 / atol 1e-5 (the sep runner's bound);
- the sequence-parallel operators and linears at mp 2 against the JAX
  ones under ``jax.vjp`` on the dp2 x mp2 mesh, forward 1e-5 and
  gradients 1e-4 x max(|ref|, 1);
- ERNIE (``bert_tiny`` MLM) under ``group_sharded_parallel(level=
  "os_g")`` at sharding 4 against the JAX ``DistributedRunner(
  sharding_stage=2)``: losses and every weight after 3 SGD steps at
  rtol 5e-4 / atol 1e-5.  Every row masks the same number of positions:
  each rank's loss is the mean over its rows (Paddle's data-parallel
  loss), which is the global batch's mean that the JAX runner takes
  only when the ranks' counts agree.

The refusal of attention dropout at sep > 1 is held without a world.
"""

import numpy as np
import pytest

import torch_parity_helpers as H
from torch_dist_workers import shared_world
from torch_parity_helpers import torch_one_thread  # noqa: F401

WORLD = 4
CFG = dict(max_position_embeddings=64)
LR, CLIP = 0.5, 1.0
RTOL, ATOL = 5e-4, 1e-5
ATTN = {f"{kind}{'_causal' if causal else ''}": (kind, causal)
        for kind in ("ring", "zigzag", "ulysses") for causal in (False, True)}
SEP_RUNS = {
    "sep4 ring": dict(hybrid={"sep_degree": 4}, cp="ring"),
    "sep4 ulysses": dict(hybrid={"sep_degree": 4}, cp="ulysses"),
    "sep2mp2 ring": dict(hybrid={"sep_degree": 2, "mp_degree": 2}, cp="ring"),
    "sep2mp2 ulysses": dict(hybrid={"sep_degree": 2, "mp_degree": 2},
                            cp="ulysses"),
}
SP_CASES = ("scatter", "gather", "allgather", "reducescatter", "column",
            "row")
ERNIE_B, ERNIE_S, ERNIE_MASKED = 8, 32, 5


def _attention_inputs():
    r = np.random.RandomState(0)
    out = {}
    for name, (kind, causal) in ATTN.items():
        b, s, h, d = 2, 32, 4, 8
        out[name] = dict(kind=kind, causal=causal,
                         q=r.randn(b, s, h, d).astype(np.float32),
                         k=r.randn(b, s, h, d).astype(np.float32),
                         v=r.randn(b, s, h, d).astype(np.float32),
                         w=r.randn(b, s, h, d).astype(np.float32))
    return out


def _gpt_state():
    from paddle_tpu_torch.models import gpt_tiny
    from paddle_tpu_torch.models.gpt import _expected_shapes
    rng = np.random.default_rng(0)
    state = {}
    for name, shape in _expected_shapes(gpt_tiny(**CFG)).items():
        if name.endswith(("ln1.weight", "ln2.weight", "final_norm.weight")):
            state[name] = np.ones(shape, np.float32)
        else:
            state[name] = (rng.standard_normal(shape) * 0.02).astype(
                np.float32)
    return state


def _batches():
    x = np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int64)
    return [(x, np.roll(x, -1, 1))] * 3


def _sp_inputs():
    r = np.random.default_rng(2)

    def rnd(*shape):
        return r.standard_normal(shape).astype(np.float32)

    cases = {k: dict(x=rnd(2, 8, 6), g=rnd(2, 8, 6))
             for k in ("scatter", "gather", "allgather", "reducescatter")}
    cases["column"] = dict(x=rnd(2, 8, 8), g=rnd(2, 8, 12), w=rnd(8, 12),
                           b=rnd(12))
    cases["row"] = dict(x=rnd(2, 8, 8), g=rnd(2, 8, 12), w=rnd(8, 12),
                        b=rnd(12))
    return cases


def _ernie_state():
    """bert_tiny's weights from numpy: Normal(0, 0.02) matrices and
    embeddings, unit norm scales, small random biases."""
    from paddle_tpu_torch.models import BertForPretraining, bert_tiny
    net = BertForPretraining(bert_tiny(), device="cpu")
    rng = np.random.default_rng(3)
    state = {}
    for name, v in net.state_dict().items():
        if "norm" in name.lower() or "_ln" in name or ".ln" in name:
            state[name] = (np.ones(v.shape, np.float32) if
                           name.endswith("weight") else
                           np.zeros(v.shape, np.float32))
        else:
            state[name] = (rng.standard_normal(tuple(v.shape)) * 0.02
                           ).astype(np.float32)
    return state


def _ernie_batches():
    """Tokens, and MLM labels on ``ERNIE_MASKED`` positions of every row
    (-100 elsewhere); one batch taken three times."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (ERNIE_B, ERNIE_S)).astype(np.int64)
    y = np.full_like(x, -100)
    for i in range(ERNIE_B):
        at = rng.choice(ERNIE_S, ERNIE_MASKED, replace=False)
        y[i, at] = x[i, at]
    return [(x, y)] * 3


def _inputs():
    return dict(cfg=CFG, state=_gpt_state(), batches=_batches(), lr=LR,
                adam_lr=1e-3, clip=CLIP, attention=_attention_inputs(),
                sep_runs=SEP_RUNS, sp=_sp_inputs(),
                ernie_state=_ernie_state(), ernie_batches=_ernie_batches())



@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The port's tensors go to the CPU while this module runs."""
    import paddle_tpu_torch as tpaddle
    prev = tpaddle.get_device()
    tpaddle.set_device("cpu")
    yield
    tpaddle.set_device(prev)

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_world(tmp_path_factory, "context", "context_world", WORLD,
                        _inputs, timeout=300)


# -- ring / zigzag / Ulysses attention ------------------------------------------
def _jax_attention(case):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.fleet.meta_parallel.context_parallel \
        import (_ring_attention_impl, _ulysses_attention_impl,
                ring_flash_attention, zigzag_merge_sequence,
                zigzag_split_sequence)
    mesh = collective.build_mesh({"sep": 4}, devices=jax.devices()[:4])
    kind, causal = case["kind"], case["causal"]

    def run(q, k, v):
        if kind == "ring":
            return _ring_attention_impl(q, k, v, causal=causal, mesh=mesh)
        if kind == "ulysses":
            return _ulysses_attention_impl(q, k, v, causal=causal,
                                           mesh=mesh)
        qz, kz, vz = (zigzag_split_sequence(t, mesh=mesh) for t in (q, k, v))
        oz = ring_flash_attention.raw(qz, kz, vz, causal=causal, mesh=mesh,
                                      balanced=True)
        return zigzag_merge_sequence(oz, mesh=mesh)

    w = jnp.asarray(case["w"])
    args = [jnp.asarray(case[n]) for n in ("q", "k", "v")]
    out, vjp = jax.vjp(jax.jit(run), *args)
    return np.asarray(out), [np.asarray(g) for g in vjp(w)]


@pytest.mark.parametrize("name", sorted(ATTN))
def test_context_parallel_attention_matches_jax(ranks, name):
    case = _attention_inputs()[name]
    out, grads = _jax_attention(case)
    for r, res in enumerate(ranks):
        got = res["attention"][name]
        np.testing.assert_allclose(got["out"], out, rtol=2e-4, atol=2e-5,
                                   err_msg=f"{name} rank {r} out")
        for k, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[k], g, rtol=5e-4, atol=5e-5,
                                       err_msg=f"{name} rank {r} {k}")


def test_zigzag_indices_and_refusals():
    """The layout (rank i holds chunks i and 2n-1-i) and the refusals
    where 2 sep does not divide the sequence, with the JAX indices."""
    import torch
    from paddle_tpu.distributed.fleet.meta_parallel.context_parallel \
        import zigzag_indices as jidx
    from paddle_tpu_torch.distributed.communication import Group
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        context_parallel as cp
    idx = cp.zigzag_indices(32, 4)
    assert list(idx[:8]) == [0, 1, 2, 3, 28, 29, 30, 31]
    assert list(idx[8:16]) == [4, 5, 6, 7, 24, 25, 26, 27]
    for s, n in ((32, 4), (24, 3), (16, 2)):
        np.testing.assert_array_equal(cp.zigzag_indices(s, n), jidx(s, n))
    group = Group([0, 1, 2, 3])
    x = torch.ones(2, 12, 4, 8)
    with pytest.raises(ValueError, match="zigzag"):
        cp.zigzag_split_sequence(x, group=group)
    with pytest.raises(ValueError, match="zigzag"):
        q = torch.ones(2, 3, 4, 8)             # 4 * 3 rows: 12 % 8 != 0
        cp.ring_flash_attention(q, q, q, causal=True, balanced=True,
                                group=group)
    with pytest.raises(ValueError, match="sep_degree\\*mp_degree"):
        q = torch.ones(2, 8, 2, 8)             # 2 heads over sep 4
        cp.ulysses_attention(q, q, q, group=group)


# -- the GPT sep runner ---------------------------------------------------------
_JAX = {}


def _jax_sep_runner(name):
    if name in _JAX:
        return _JAX[name]
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptimizer
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.runner import DistributedRunner as JRunner
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCrit
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
    run = SEP_RUNS[name]
    with jpaddle.LazyGuard():
        net = JGPT(jgpt_tiny(context_parallel=run["cp"], **CFG))
    net.set_state_dict(_gpt_state())
    opt = joptimizer.SGD(learning_rate=LR, parameters=net.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
    degrees = {"sep": run["hybrid"]["sep_degree"],
               "mp": run["hybrid"].get("mp_degree", 1)}
    mesh = collective.build_mesh(degrees)
    collective.set_mesh(mesh)
    try:
        runner = JRunner(net, opt, JCrit(), mesh=mesh)
        losses = [float(runner.train_step([x], [y])) for x, y in _batches()]
        runner.sync_to_layers()
    finally:
        collective.set_mesh(None)
    _JAX[name] = (losses, {k: np.asarray(v.numpy())
                           for k, v in net.state_dict().items()})
    return _JAX[name]


@pytest.mark.parametrize("name", sorted(SEP_RUNS))
def test_sep_runner_matches_the_jax_runner(ranks, name):
    losses, state = _jax_sep_runner(name)
    for res in ranks:
        assert res["sep_runs"][name]["losses"] == ranks[0]["sep_runs"][
            name]["losses"], "the ranks report different losses"
    got = ranks[0]["sep_runs"][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    assert set(got["state"]) == set(state)
    for k, v in state.items():
        np.testing.assert_allclose(got["state"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


def test_attention_dropout_refused_under_sep():
    """A GPT built under sep > 1 refuses attention dropout in training
    with the JAX message (no world: the refusal comes first)."""
    import torch
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    s = tfleet.DistributedStrategy()
    s.hybrid_configs = {"sep_degree": 2}
    tfleet.init(is_collective=True, strategy=s)
    try:
        net = GPTForCausalLM(gpt_tiny(attention_probs_dropout_prob=0.1,
                                      **CFG), device="cpu")
        x = torch.zeros(2, 16, dtype=torch.int64)
        with pytest.raises(ValueError, match="attention dropout"):
            net(x)
    finally:
        collective.set_mesh(None)
        tfleet._fleet._hcg = None


# -- the sequence-parallel operators and linears ----------------------------------
def _jax_sp(name, case):
    import jax
    import jax.numpy as jnp
    import paddle_tpu as jpaddle
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.fleet.utils import \
        sequence_parallel_utils as jsp
    from paddle_tpu.nn.functional_call import bind
    from paddle_tpu.tensor import Tensor as JTensor
    collective.set_mesh(collective.build_mesh({"dp": 2, "mp": 2}))
    try:
        params = {}
        if name in ("column", "row"):
            cls = jsp.ColumnSequenceParallelLinear if name == "column" \
                else jsp.RowSequenceParallelLinear
            with jpaddle.LazyGuard():
                layer = cls(*case["w"].shape)
            params = {"weight": jnp.asarray(case["w"]),
                      "bias": jnp.asarray(case["b"])}

            def fwd(p, x):
                with bind(layer, p):
                    return layer(JTensor(x))._value
        else:
            op = {"scatter": jsp.ScatterOp, "gather": jsp.GatherOp,
                  "allgather": jsp.AllGatherOp,
                  "reducescatter": jsp.ReduceScatterOp}[name]

            def fwd(p, x):
                return op.apply(JTensor(x))._value

        def run(p, g, x):
            out, vjp = jax.vjp(fwd, p, x)
            return out, vjp(g)

        out, (gp, gx) = jax.jit(run)(params, jnp.asarray(case["g"]),
                                     jnp.asarray(case["x"]))
    finally:
        collective.set_mesh(None)
    ref = {"out": np.asarray(out), "dx": np.asarray(gx)}
    ref.update({k: np.asarray(v) for k, v in gp.items()})
    return ref


@pytest.mark.parametrize("name", SP_CASES)
def test_sequence_parallel_matches_jax(ranks, name):
    ref = _jax_sp(name, _sp_inputs()[name])
    for r, res in enumerate(ranks):
        got = res["sp"][name]
        if name == "row":
            assert got.pop("bias_marked") is True
        assert set(got) == set(ref), (sorted(got), sorted(ref))
        for k in ref:
            tol = H.FWD_TOL if k == "out" else H.GRAD_TOL
            H.close(got[k], ref[k], tol, f"rank {r} {name} {k}")


# -- ERNIE under sharding stage 2 -------------------------------------------------
def _jax_ernie_stage2():
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptimizer
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.runner import DistributedRunner as JRunner
    from paddle_tpu.models.bert import BertForPretraining as JBert
    from paddle_tpu.models.bert import BertPretrainingCriterion as JCrit
    from paddle_tpu.models.bert import bert_tiny as jbert_tiny
    with jpaddle.LazyGuard():
        net = JBert(jbert_tiny())
    net.set_state_dict(_ernie_state())
    opt = joptimizer.SGD(learning_rate=LR, parameters=net.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
    mesh = collective.build_mesh({"sharding": 4})
    collective.set_mesh(mesh)
    try:
        runner = JRunner(net, opt, JCrit(jbert_tiny().vocab_size),
                         mesh=mesh, sharding_stage=2)
        losses = [float(runner.train_step([x], [y]))
                  for x, y in _ernie_batches()]
        runner.sync_to_layers()
    finally:
        collective.set_mesh(None)
    return losses, {k: np.asarray(v.numpy())
                    for k, v in net.state_dict().items()}


def test_ernie_stage2_matches_the_jax_runner(ranks):
    losses, state = _jax_ernie_stage2()
    for res in ranks:
        assert res["ernie"]["losses"] == ranks[0]["ernie"]["losses"]
        np.testing.assert_allclose(res["ernie"]["losses"], losses,
                                   rtol=RTOL, atol=ATOL)
        assert set(res["ernie"]["state"]) == set(state)
        for k, v in state.items():
            np.testing.assert_allclose(res["ernie"]["state"][k], v,
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    assert losses[-1] < losses[0]


def test_ranks_import_no_jax(ranks):
    assert all(res["foreign_modules"] == [] for res in ranks)
