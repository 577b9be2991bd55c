"""The port's distributed pieces that need no world, in one process:
the hybrid topology's rank arithmetic and groups against the JAX
package's (``tests/test_distributed.py::test_topology_groups`` and more
layouts), ``DistributedStrategy``'s merges, ``recompute`` (bit-equal
gradients to the plain run in the port, and against the JAX
``recompute``), ``GPTConfig(recompute=True)`` with dropout, the mp GPT's
weight carrying, the refusals that cite the next slices, and the world-1
defaults."""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet.base import topology as ttopo
import torch_parity_helpers as H
from torch_parity_helpers import torch_one_thread  # noqa: F401

NAMES = ["data", "pipe", "sharding", "sep", "model"]
LAYOUTS = [[2, 2, 1, 1, 2], [2, 1, 1, 1, 4], [1, 2, 1, 1, 4],
           [2, 1, 2, 1, 2], [1, 1, 4, 1, 2], [8, 1, 1, 1, 1],
           [1, 1, 1, 2, 4], [2, 2, 2, 1, 1]]


@pytest.fixture
def clean_registry():
    """A test that registers a topology leaves none behind."""
    from paddle_tpu_torch.distributed import collective
    yield
    collective.set_mesh(None)
    tfleet._fleet._hcg = None


@pytest.mark.parametrize("dims", LAYOUTS,
                         ids=["x".join(map(str, d)) for d in LAYOUTS])
def test_topology_matches_jax(dims, clean_registry):
    from paddle_tpu.distributed.fleet import CommunicateTopology as JTopo
    from paddle_tpu.distributed.fleet import HybridCommunicateGroup as JHcg
    jt, tt = JTopo(NAMES, dims), ttopo.CommunicateTopology(NAMES, dims)
    assert tt.world_size() == jt.world_size()
    for axis in NAMES:
        assert tt.get_comm_list(axis) == jt.get_comm_list(axis)
        assert tt.get_dim(axis) == jt.get_dim(axis)
        for i in range(tt.get_dim(axis)):
            assert tt.get_axis_list(axis, i) == jt.get_axis_list(axis, i)
    getters = ["data_parallel", "model_parallel", "pipe_parallel",
               "sharding_parallel", "sep_parallel"]
    for rank in range(tt.world_size()):
        assert tt.get_coord(rank) == jt.get_coord(rank)
        assert tt.get_rank(**tt.get_coord(rank)) == rank
        j, t = JHcg(jt, rank), ttopo.HybridCommunicateGroup(tt, rank)
        for g in getters:
            assert getattr(t, f"get_{g}_rank")() == \
                getattr(j, f"get_{g}_rank")(), (rank, g)
            assert getattr(t, f"get_{g}_world_size")() == \
                getattr(j, f"get_{g}_world_size")(), (rank, g)
            assert getattr(t, f"get_{g}_group")().ranks == \
                getattr(j, f"get_{g}_group")().ranks, (rank, g)
        assert t.get_check_parallel_group().ranks == \
            j.get_check_parallel_group().ranks
        assert (t.is_first_stage(), t.is_last_stage()) == \
            (j.is_first_stage(), j.is_last_stage())
        assert t.get_rank_from_stage(0) == j.get_rank_from_stage(0)


def test_jax_topology_case(clean_registry):
    """``tests/test_distributed.py::test_topology_groups`` on the port."""
    topo = ttopo.CommunicateTopology(NAMES, [2, 2, 1, 1, 2])
    hcg = ttopo.HybridCommunicateGroup(topo, rank=0)
    assert hcg.get_data_parallel_world_size() == 2
    assert hcg.get_pipe_parallel_world_size() == 2
    assert hcg.get_model_parallel_group().ranks == [0, 1]
    assert topo.get_rank(data=1, pipe=0, sharding=0, sep=0, model=1) == 5


def test_strategy_merges_as_jax():
    from paddle_tpu.distributed.fleet import DistributedStrategy as JS
    s, j = tfleet.DistributedStrategy(), JS()
    for obj in (s, j):
        obj.hybrid_configs = {"dp_degree": 4}
        obj.hybrid_configs = {"mp_degree": 2}
        obj.amp_configs = {"init_loss_scaling": 1024.0}
        obj.sharding_configs = {"stage": 2}
        obj.recompute = True
        obj.gradient_merge_configs = {"k_steps": 4}
    # hybrid_configs merges over its defaults, the other configs over
    # their current values (the JAX rule)
    assert (s.hybrid_configs["dp_degree"], s.hybrid_configs["mp_degree"]) \
        == (1, 2)
    assert s.amp_configs["init_loss_scaling"] == 1024.0
    assert s.amp_configs["incr_ratio"] == 2.0
    assert s.to_dict() == j.to_dict()


def _block_case():
    lin = tpaddle.nn.Linear(8, 8, device="cpu")
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (4, 8)).astype(np.float32), requires_grad=True)

    def block(t):
        return torch.tanh(lin(t)) * 2

    return lin, x, block


def test_recompute_matches_plain_and_jax():
    """The port's recompute against its plain run (bit-equal) and both
    against the JAX ``recompute`` on the same weights
    (``tests/test_distributed.py::test_recompute_matches_plain``), within
    the cross-package bounds of ``torch_parity_helpers``."""
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.distributed import recompute as jrecompute
    from paddle_tpu_torch.distributed import recompute
    lin, x, block = _block_case()
    out1 = recompute(block, x)
    out1.sum().backward()
    g1, w1 = x.grad.clone(), lin.weight.grad.clone()
    x.grad, lin.weight.grad, lin.bias.grad = None, None, None
    out2 = block(x)
    out2.sum().backward()
    assert torch.equal(out1, out2)
    assert torch.equal(g1, x.grad) and torch.equal(w1, lin.weight.grad)

    jlin = jnn.Linear(8, 8)
    jlin.set_state_dict({k: v.detach().numpy() for k, v in
                         lin.state_dict().items()})
    jx = jpaddle.to_tensor(x.detach().numpy(), stop_gradient=False)
    jout = jrecompute(lambda t: jpaddle.tanh(jlin(t)) * 2, jx)
    jout.sum().backward()
    H.close(out1.detach().numpy(), jout.numpy(), H.FWD_TOL, "out")
    H.close(g1.numpy(), jx.grad.numpy(), H.GRAD_TOL, "x grad")
    H.close(w1.numpy(), jlin.weight.grad.numpy(), H.GRAD_TOL, "w grad")


def test_recompute_on_paddle_tensors():
    from paddle_tpu_torch.distributed import recompute
    lin, x, block = _block_case()
    tx = tpaddle.to_tensor(x.detach().numpy(), place="cpu",
                           stop_gradient=False)
    out = recompute(lambda t: tpaddle.tanh(lin(t)) * 2, tx)
    assert isinstance(out, tpaddle.Tensor)
    out.sum().backward()
    ref = block(x)
    ref.sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), x.grad.numpy())


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gpt_recompute_gradients_bit_equal(dropout):
    """``GPTConfig(recompute=True)`` trains with the gradients of
    ``recompute=False``, bit for bit, dropout included: the replay draws
    the first run's masks from the port's generator."""
    from paddle_tpu_torch.framework import random as trandom
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny)
    x = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(np.int64)
    y = np.roll(x, -1, 1)
    grads, losses = [], []
    for remat in (False, True):
        cfg = gpt_tiny(max_position_embeddings=64, recompute=remat,
                       hidden_dropout_prob=dropout,
                       attention_probs_dropout_prob=dropout)
        net = GPTForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(5))
        trandom.seed(11)
        loss = GPTPretrainingCriterion()(net(torch.tensor(x)),
                                         torch.tensor(y))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in net.named_parameters()})
    assert losses[0] == losses[1]
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def test_mp_weights_cut_and_join(clean_registry):
    """``state_dict_from_jax`` at mp 2 cuts each rank's shard; the shards
    load into the mp GPT each rank builds (its shapes) and
    ``merge_mp_states`` gives back the whole state; at mp 1 the cut is
    the whole state."""
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                         state_dict_from_jax)
    from paddle_tpu_torch.models.gpt import _expected_shapes, merge_mp_states
    cfg = gpt_tiny(max_position_embeddings=64)
    rng = np.random.default_rng(0)
    full = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in _expected_shapes(cfg).items()}
    whole = state_dict_from_jax(full, cfg)
    assert all(np.array_equal(whole[k].numpy(), v) for k, v in full.items())
    s = tfleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2}
    tfleet.init(is_collective=True, strategy=s)
    shards = []
    for r in range(2):
        part = state_dict_from_jax(full, cfg, mp_rank=r, mp_degree=2)
        net = GPTForCausalLM(cfg, device="cpu")
        net.load_state_dict(part)
        assert net.gpt.layers[0].attn.num_heads == 2
        shards.append({k: v.numpy() for k, v in part.items()})
    joined = merge_mp_states(shards, cfg)
    for k, v in full.items():
        np.testing.assert_array_equal(joined[k], v, err_msg=k)
    q = full["gpt.layers.0.attn.qkv_proj.weight"].reshape(64, 3, 4, 16)
    np.testing.assert_array_equal(
        shards[1]["gpt.layers.0.attn.qkv_proj.weight"],
        q[:, :, 2:].reshape(64, 96))


def _init(clean, **hybrid):
    s = tfleet.DistributedStrategy()
    s.hybrid_configs = hybrid
    tfleet.init(is_collective=True, strategy=s)
    return s


def _tiny(**kw):
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
    net = GPTForCausalLM(gpt_tiny(max_position_embeddings=64, **kw),
                         device="cpu")
    return net, tpaddle.optimizer.SGD(learning_rate=0.1,
                                      parameters=net.parameters())


@pytest.mark.parametrize("axis", ["pp_degree", "sep_degree"])
def test_pipeline_and_context_parallel_refuse(axis, clean_registry):
    """What pipeline and context parallel still refuse: at pp 2 a model
    that is not a ``PipelineLayer`` (``DistributedRunner`` runs pp 1,
    ``PipelinedRunner`` trains pipeline items); at sep 2 attention
    dropout while training (the JAX model's refusal), and pp beside sep
    in the pipeline engine (its ROADMAP item)."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed.runner import PipelinedRunner
    if axis == "pp_degree":
        _init(clean_registry, pp_degree=2)
        net, opt = _tiny()
        with pytest.raises(ValueError, match="PipelinedRunner"):
            DistributedRunner(net, opt)
        with pytest.raises(TypeError, match="PipelineLayer"):
            PipelinedRunner(net, opt)
        return
    _init(clean_registry, sep_degree=2)
    net, _ = _tiny(attention_probs_dropout_prob=0.1)
    with pytest.raises(ValueError, match="attention dropout"):
        net(torch.zeros(2, 16, dtype=torch.int64))
    _init(clean_registry, sep_degree=2, pp_degree=2)
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt_tiny
    pipe = GPTForCausalLMPipe(gpt_tiny(max_position_embeddings=64,
                                       num_hidden_layers=4),
                              num_stages=2, device="cpu")
    with pytest.raises(NotImplementedError, match="context parallel.*A10"):
        tfleet.distributed_model(pipe)


def test_pipelined_runner_refuses_the_folded_entry(clean_registry):
    """``train_steps_folded`` waits for the fold engine's mesh branch."""
    from paddle_tpu_torch.distributed.runner import PipelinedRunner
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt_tiny
    _init(clean_registry)
    net = GPTForCausalLMPipe(gpt_tiny(max_position_embeddings=64),
                             device="cpu")
    opt = tpaddle.optimizer.SGD(learning_rate=0.1,
                                parameters=net.parameters())
    runner = PipelinedRunner(net, opt)
    with pytest.raises(NotImplementedError, match="A10 \\(the mesh branch"):
        runner.train_steps_folded([])


@pytest.mark.parametrize("knob", ["bits4", "env_x", "mp2", "clip_by_norm"])
def test_compressed_dp_knobs_refuse(knob, monkeypatch, clean_registry):
    """What the JAX package's compressed dp path refuses, with its
    messages: 4 bits, an env value that is no width, compression beside
    mp 2, and a clip by norm under the sharded update."""
    from paddle_tpu_torch.distributed import DistributedRunner
    if knob == "mp2":
        s = _init(clean_registry, dp_degree=2, mp_degree=2)
        s.quantized_allreduce = 8
        with pytest.raises(ValueError, match="other mesh axis.*'mp': 2"):
            tfleet.distributed_runner(*_tiny())
        return
    _init(clean_registry, dp_degree=2)
    net, opt = _tiny()
    if knob == "bits4":
        with pytest.raises(ValueError, match="must be 0 .off., 8 .int8 "
                           "ring. or 16"):
            DistributedRunner(net, opt, dp_compress_bits=4)
    elif knob == "env_x":
        monkeypatch.setenv("PADDLE_TPU_DP_COMPRESS", "x")
        with pytest.raises(ValueError, match="PADDLE_TPU_DP_COMPRESS='x': "
                           "expected 0, 8 or 16"):
            DistributedRunner(net, opt)
    else:
        opt._grad_clip = tpaddle.nn.ClipGradByNorm(1.0)
        with pytest.raises(ValueError, match="sharded_weight_update "
                           "supports ClipGradByGlobalNorm"):
            DistributedRunner(net, opt, dp_shard_update=True)


def test_fused_lmce_at_mp2_refuses(clean_registry):
    """At mp 2 ``enable_fused_lmce`` takes the vocab-parallel route (it
    refused before this route came); what stays refused beside the mp
    runs is a ``PipelinedRunner``'s runner checkpoint: the JAX runner
    tree needs ``place()``, which the JAX ``PipelinedRunner`` lacks."""
    from paddle_tpu_torch.distributed.checkpoint import save_runner_state
    from paddle_tpu_torch.distributed.runner import PipelinedRunner
    from paddle_tpu_torch.models import (GPTForCausalLMPipe,
                                         GPTPretrainingCriterion,
                                         enable_fused_lmce, gpt_tiny)
    _init(clean_registry, mp_degree=2)
    net, _ = _tiny()
    crit = GPTPretrainingCriterion()
    enable_fused_lmce(net, crit)
    assert net.skip_lm_head and crit._vocab_group is not None
    tfleet._fleet._hcg = None
    from paddle_tpu_torch.distributed import collective
    collective.set_mesh(None)
    pipe = GPTForCausalLMPipe(gpt_tiny(max_position_embeddings=64),
                              device="cpu")
    runner = PipelinedRunner(pipe, tpaddle.optimizer.SGD(
        learning_rate=0.1, parameters=pipe.parameters()))
    with pytest.raises(NotImplementedError, match="PipelinedRunner.*place"):
        save_runner_state(runner, "unused")


def test_enable_resilience_refuses():
    with pytest.raises(NotImplementedError, match="A11"):
        tfleet.enable_resilience(hang_timeout=10)


def test_world_one_defaults(clean_registry):
    """Without a world: rank 0 of 1, ``init_parallel_env`` starts nothing
    (as the JAX one), a collective on the default group leaves its
    tensor, ``fleet.init`` builds the one-rank topology, and the runner
    trains the whole batch on one process."""
    from paddle_tpu_torch import distributed as tdist
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.io import DistributedBatchSampler
    assert (tdist.get_rank(), tdist.get_world_size()) == (0, 1)
    tdist.init_parallel_env()
    assert not torch.distributed.is_initialized()
    t = torch.ones(3)
    tdist.all_reduce(t)
    assert torch.equal(t, torch.ones(3))
    sampler = DistributedBatchSampler(list(range(5)), batch_size=2)
    assert (sampler.nranks, sampler.local_rank) == (1, 0)
    _init(clean_registry)
    assert tfleet.get_hybrid_communicate_group().get_parallel_mode() == \
        "data"
    net, opt = _tiny()
    assert tfleet.distributed_model(net) is net
    x = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int64)
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    runner = DistributedRunner(net, opt, GPTPretrainingCriterion())
    losses = [runner.train_step([x], [np.roll(x, -1, 1)]) for _ in range(3)]
    assert losses[-1] < losses[0]


def test_per_tensor_norm_clip_refuses_under_mp(clean_registry):
    """``ClipGradByNorm`` would take the norm of a rank's shard only."""
    from paddle_tpu_torch.distributed import DistributedRunner
    _init(clean_registry, mp_degree=2)
    net, _ = _tiny()
    opt = tpaddle.optimizer.SGD(
        learning_rate=0.1, parameters=net.parameters(),
        grad_clip=tpaddle.nn.ClipGradByNorm(1.0))
    with pytest.raises(NotImplementedError, match="ClipGradByNorm"):
        DistributedRunner(net, opt)


@pytest.fixture
def two_rank_env(monkeypatch):
    """The env contract of rank 0 of 2, and the place restored after."""
    from paddle_tpu_torch import places
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_MASTER", "127.0.0.1:1")
    prev = places._current_place[0]
    yield monkeypatch
    places._current_place[0] = prev


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the refusal of a machine without a card")
def test_a_rank_that_finds_no_card_raises(two_rank_env):
    from paddle_tpu_torch.distributed import parallel
    two_rank_env.setattr(parallel, "_parallel_env_initialized", [False])
    tpaddle.set_device("gpu:0")
    with pytest.raises(RuntimeError, match="a card was asked for"):
        parallel.init_parallel_env()
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_two_ranks_on_one_card(two_rank_env):
    """The backend choice for ranks that share a card: gloo by default,
    and NCCL, when named, refused (one card faked for the choice)."""
    from paddle_tpu_torch import places
    from paddle_tpu_torch.distributed import parallel
    m = two_rank_env
    m.setattr(torch.cuda, "is_available", lambda: True)
    m.setattr(torch.cuda, "device_count", lambda: 1)
    m.setattr(torch.cuda, "set_device", lambda d: None)
    m.setattr(places, "set_device", lambda d: None)
    places._current_place[0] = places.CUDAPlace(0)
    env = parallel.ParallelEnv()
    assert parallel._choose(env) == ("gloo", torch.device("cuda", 0))
    m.setenv("PADDLE_DISTRI_BACKEND", "nccl")
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        parallel._choose(env)


def test_is_mp_split_reads_only_the_mark():
    """``torch.Tensor.is_distributed`` is a method: a parameter no mp
    layer marked reads as not split."""
    import torch
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        RowParallelLinear, is_mp_split)
    plain = torch.nn.Parameter(torch.zeros(2))
    assert callable(plain.is_distributed) and not is_mp_split(plain)
    norm = nn.LayerNorm(4, device="cpu")
    assert not is_mp_split(norm.weight) and not is_mp_split(norm.bias)
    marked = torch.nn.Parameter(torch.zeros(2))
    marked.is_distributed = True
    assert is_mp_split(marked)
    one = tpaddle.distributed.communication.Group([0])
    row = RowParallelLinear(4, 4, mp_group=one, device="cpu")  # mp 1
    assert not is_mp_split(row.weight) and not is_mp_split(row.bias)
