"""Tensor, data and sharding parallelism of the port at world 4 (gloo,
four CPU processes) against the JAX package on its 8-device CPU mesh.

One world (``torch_dist_workers.hybrid_world``) runs the file's rank
side; the JAX references run here, in the test process:

- each mp layer at dp2 x mp2 (``ColumnParallelLinear`` with and without
  ``gather_output``, ``RowParallelLinear`` with and without
  ``input_is_parallel``, ``VocabParallelEmbedding``,
  ``ParallelCrossEntropy`` with ignored labels): the output and every
  gradient, each rank's shards joined, against the JAX layer compiled
  on the dp2 x mp2 mesh under ``jax.vjp``; forward 1e-5 and gradients
  1e-4 x max(|ref|, 1) (``torch_parity_helpers``);
- ``DistributedRunner`` on ``gpt_tiny`` (weights from numpy, cut into
  each rank's shard by ``state_dict_from_jax``) at dp2 x mp2, with
  ``accumulate_steps=2``, with ``remat=True``, at ``sharding=4`` for
  stages 1, 2 and 3, and at dp4: three steps of the global batch, against the
  JAX ``DistributedRunner`` on the same mesh: losses and every weight
  (the shards joined by ``merge_mp_states``) at rtol 5e-4 / atol 1e-5,
  the JAX package's own bound for mp against serial
  (``tests/test_distributed.py::test_mp_runner_matches_serial``).  Both
  step with SGD (lr 0.5) and the global-norm clip at 1.0, which binds:
  SGD moves each weight by its gradient, where Adam would turn a
  gradient of pure rounding noise into a step of ~lr;
- the dygraph loop (Paddle Tensors, each rank its data rows) against
  the runner with the same optimizer: ``fleet.distributed_model`` +
  ``distributed_optimizer`` at dp2 x mp2, the same at dp4 with
  ``DataParallel`` and ``distributed_scaler``, and
  ``group_sharded_parallel(level="os_g")`` at sharding 4;
- dp2 x mp2 from each mp rank's own random weights: the replicas stay
  bit-equal, and the hybrid clip counts each weight once.
"""

import numpy as np
import pytest

import torch_parity_helpers as H
from torch_dist_workers import shared_world
from torch_parity_helpers import torch_one_thread  # noqa: F401

WORLD = 4
CFG = dict(max_position_embeddings=64)
LR, ADAM_LR, CLIP = 0.5, 1e-3, 1.0
RTOL, ATOL = 5e-4, 1e-5
DP2MP2 = {"dp_degree": 2, "mp_degree": 2}
SHARD4 = {"sharding_degree": 4}
RUNS = {
    "dp2mp2": dict(hybrid=DP2MP2, kw={}),
    "acc2": dict(hybrid=DP2MP2, kw=dict(accumulate_steps=2)),
    "remat": dict(hybrid=DP2MP2, kw=dict(remat=True)),
    "stage1": dict(hybrid=SHARD4, kw=dict(sharding_stage=1)),
    "stage2": dict(hybrid=SHARD4, kw=dict(sharding_stage=2)),
    "stage3": dict(hybrid=SHARD4, kw=dict(sharding_stage=3)),
    "dp4": dict(hybrid={"dp_degree": 4}, kw={}),
    "adamw": dict(hybrid=DP2MP2, kw={}, opt="adamw"),
    "dygraph": dict(hybrid=DP2MP2, opt="adamw", dygraph="fleet"),
    "dygraph dp4 scaler": dict(hybrid={"dp_degree": 4}, dygraph="scaler"),
    "dygraph os_g": dict(hybrid=SHARD4, dygraph="os_g"),
}
JAX_MESH = {"dp2mp2": {"dp": 2, "mp": 2}, "acc2": {"dp": 2, "mp": 2},
            "remat": {"dp": 2, "mp": 2}, "stage1": {"sharding": 4},
            "stage2": {"sharding": 4}, "stage3": {"sharding": 4},
            "dp4": {"dp": 4}}


def _gpt_state():
    """gpt_tiny's weights from numpy: GPT's Normal(0, 0.02) matrices and
    embeddings, small random biases (so each bias's gradient path is
    seen), unit LayerNorm scales."""
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
    """One global batch taken three times, so the loss must fall."""
    x = np.random.default_rng(1).integers(0, 256, (8, 32)).astype(np.int64)
    return [(x, np.roll(x, -1, 1))] * 3


def _layer_cases():
    r = np.random.default_rng(2)

    def rnd(*shape):
        return r.standard_normal(shape).astype(np.float32)

    cases = {}
    for kind in ("col_gather", "col_local", "row_split", "row_parallel"):
        cases[kind] = dict(kind=kind, w=rnd(8, 12), b=rnd(12), x=rnd(3, 8),
                           g=rnd(3, 12))
    cases["vocab"] = dict(kind="vocab", w=rnd(16, 6),
                          x=r.integers(0, 16, (2, 5)), g=rnd(2, 5, 6))
    label = r.integers(0, 16, (7,))
    label[[1, 4]] = -100
    cases["pce"] = dict(kind="pce", logits=rnd(7, 16), label=label,
                        ignore=-100, g=rnd(7))
    return cases


def _inputs():
    return dict(cfg=CFG, state=_gpt_state(), batches=_batches(), lr=LR,
                adam_lr=ADAM_LR, clip=CLIP, layers=_layer_cases(),
                runs=RUNS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_world(tmp_path_factory, "hybrid", "hybrid_world", WORLD,
                        _inputs, timeout=300)


def _jax_mp_layer(case):
    """The JAX layer of ``case`` on the dp2 x mp2 mesh: output and
    gradients under ``jax.vjp`` of one compiled program."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as jpaddle
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.fleet import meta_parallel as jmp
    from paddle_tpu.nn.functional_call import bind
    from paddle_tpu.tensor import Tensor as JTensor
    kind = case["kind"]
    collective.set_mesh(collective.build_mesh({"dp": 2, "mp": 2}))
    with jpaddle.LazyGuard():
        if kind == "pce":
            layer = jmp.ParallelCrossEntropy(ignore_index=case["ignore"])
        elif kind == "vocab":
            layer = jmp.VocabParallelEmbedding(*case["w"].shape)
        elif kind.startswith("col"):
            layer = jmp.ColumnParallelLinear(
                *case["w"].shape, gather_output=kind == "col_gather")
        else:
            layer = jmp.RowParallelLinear(
                *case["w"].shape, input_is_parallel=kind == "row_parallel")
    params = {}
    if kind != "pce":
        params = {"weight": jnp.asarray(case["w"])}
        if "b" in case:
            params["bias"] = jnp.asarray(case["b"])
    if kind == "pce":
        xs = [jnp.asarray(case["logits"])]
        label = jnp.asarray(case["label"])

        def fwd(p, x):
            return layer(JTensor(x), JTensor(label))._value
    else:
        xs = [] if kind == "vocab" else [jnp.asarray(case["x"])]
        ids = jnp.asarray(case["x"]) if kind == "vocab" else None

        def fwd(p, *x):
            with bind(layer, p):
                arg = JTensor(ids) if kind == "vocab" else JTensor(x[0])
                return layer(arg)._value

    def run(p, g, *x):
        out, vjp = jax.vjp(fwd, p, *x)
        return out, vjp(g)

    out, grads = jax.jit(run)(params, jnp.asarray(case["g"]), *xs)
    ref = {"out": np.asarray(out)}
    if xs:
        ref["dx"] = np.asarray(grads[1])
    for k, v in grads[0].items():
        ref[k] = np.asarray(v)
    return ref


@pytest.mark.parametrize("kind", ["col_gather", "col_local", "row_split",
                                  "row_parallel", "vocab", "pce"])
def test_mp_layer_matches_jax(ranks, kind):
    case = _layer_cases()[kind]
    ref = _jax_mp_layer(case)
    for r, res in enumerate(ranks):
        got = res["layers"][kind]
        assert set(got) == set(ref), (sorted(got), sorted(ref))
        for k in ref:
            tol = H.FWD_TOL if k == "out" else H.GRAD_TOL
            H.close(got[k], ref[k], tol, f"rank {r} {kind} {k}")


def _jax_runner(name):
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptimizer
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.runner import DistributedRunner as JRunner
    from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCrit
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
    with jpaddle.LazyGuard():
        net = JGPT(jgpt_tiny(**CFG))
    net.set_state_dict(_gpt_state())
    opt = joptimizer.SGD(learning_rate=LR, parameters=net.parameters(),
                         grad_clip=jnn.ClipGradByGlobalNorm(CLIP))
    mesh = collective.build_mesh(JAX_MESH[name])
    collective.set_mesh(mesh)
    runner = JRunner(net, opt, JCrit(), mesh=mesh, **RUNS[name]["kw"])
    losses = [float(runner.train_step([x], [y])) for x, y in _batches()]
    runner.sync_to_layers()
    return losses, {k: np.asarray(v.numpy())
                    for k, v in net.state_dict().items()}


@pytest.mark.parametrize("name", sorted(JAX_MESH))
def test_runner_matches_the_jax_runner(ranks, name):
    losses, state = _jax_runner(name)
    for res in ranks:
        assert res["runs"][name]["losses"] == ranks[0]["runs"][name][
            "losses"], "the ranks report different losses"
    got = ranks[0]["runs"][name]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    assert set(got["state"]) == set(state)
    for k, v in state.items():
        np.testing.assert_allclose(got["state"][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("loop,runner", [
    ("dygraph", "adamw"), ("dygraph dp4 scaler", "dp4"),
    ("dygraph os_g", "stage2")])
def test_dygraph_hybrid_loop_matches_the_runner(ranks, loop, runner):
    """The same steps, with the hybrid clip, through the user's loop and
    through ``DistributedRunner``: dp2 x mp2 with AdamW
    (``TensorParallel`` + ``HybridParallelOptimizer``); dp4 with SGD
    (``DataParallel``'s gradient hooks, a ``GradScaler`` at 2**10 behind
    ``distributed_scaler``: a power of two scales and unscales exactly);
    sharding 4 with SGD (``group_sharded_parallel(level="os_g")``).  The
    same update on the same gradients, so the losses and weights agree
    to the last bits the reductions' order leaves."""
    loop, runner = (ranks[0]["runs"][k] for k in (loop, runner))
    np.testing.assert_allclose(loop["losses"], runner["losses"], rtol=1e-6)
    for k, v in runner["state"].items():
        np.testing.assert_allclose(loop["state"][k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _replicated_numel():
    """The weights GPT keeps whole on every mp rank: the position table,
    each layer's two LayerNorms and two row-parallel biases, the final
    LayerNorm."""
    from paddle_tpu_torch.models import gpt_tiny
    cfg = gpt_tiny(**CFG)
    d = cfg.hidden_size
    return (cfg.max_position_embeddings * d
            + cfg.num_hidden_layers * 6 * d + 2 * d)


def test_random_init_ranks_hold_one_model(ranks):
    """Each mp rank draws its own random weights; ``fleet.
    distributed_model`` starts the replicated ones from the mp group's
    first rank, and after two AdamW steps with the hybrid clip every
    weight is bit-equal over dp and every replicated one over mp."""
    for r, res in enumerate(ranks):
        rep = res["random_init"]["replicas"]
        assert rep["dp"][0] > 0 and rep["dp"][1] == 0, (r, rep)
        assert rep["mp"] == [_replicated_numel(), 0], (r, rep)


def test_the_hybrid_clip_counts_each_weight_once(ranks):
    """The clip's square-sum at dp2 x mp2 (split weights summed over mp,
    replicated ones once) is the square-sum of the whole gradient joined
    from the shards."""
    for res in ranks:
        got = res["random_init"]
        np.testing.assert_allclose(got["clip_sq_sum"], got["joined_sq_sum"],
                                   rtol=1e-5)


def test_ranks_hold_one_model(ranks):
    """Every rank of a run reports the same losses and joins to the same
    weights; no rank imported JAX."""
    for name in RUNS:
        ref = ranks[0]["runs"][name]
        for res in ranks[1:]:
            assert res["runs"][name]["losses"] == ref["losses"], name
            for k, v in ref["state"].items():
                np.testing.assert_array_equal(res["runs"][name]["state"][k],
                                              v, err_msg=f"{name} {k}")
    assert all(res["foreign_modules"] == [] for res in ranks)
