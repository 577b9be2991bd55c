"""Pipeline parallelism of the port at world 4 (gloo, four CPU
processes) against the JAX package's pipeline on its 8-device CPU mesh.

One world (``torch_dist_workers.pipeline_world``) runs the file's rank
side; the JAX references run here, in the test process, each once:

- ``GPTForCausalLMPipe`` on ``gpt_tiny(num_hidden_layers=4)`` (weights
  from numpy under the JAX pipe model's names, cut into each rank's
  stage and mp shard by ``state_dict_from_jax``) at pp4, pp2 x mp2 and
  pp2 x dp2 through ``fleet.distributed_model(...).train_batch`` (the
  ``PipelineParallelWrapper``), 4 micro-batches of 2 a step, SGD (lr
  0.5) with the global-norm clip at 1.0 (it binds), 3 steps, against the
  JAX ``PipelineParallel`` on the same layout: losses and every weight
  after the last step (the ranks' stages and shards joined by
  ``merge_mp_states``) at rtol 5e-4 / atol 1e-5, the bound the JAX
  package holds mp against serial with.  SGD moves each weight by its
  gradient, where Adam would turn a gradient of rounding noise into a
  step of ~lr;
- ``PipelinedRunner.train_step`` / ``eval_step`` at pp2 x dp2 against the
  same JAX run, its ``amp_level`` warning and its refusal of
  ``train_steps_folded``;
- the tied word embedding: the first stage's table and the last stage's
  head copy bit-equal after the 3 steps, and a planted control with the
  gradient sum of the pair switched off, whose copies part;
- ``pipeline_spmd`` (with and without ``remat_stage``) over the pp4
  group and ``pipeline_spmd_interleaved`` at 4 x 2 chunks: outputs and
  gradients against the JAX functions (1e-4 / 1e-5 forward, 1e-3 / 1e-5
  gradients: ``tests/test_distributed.py``'s bounds);
- ``PipelineLayer`` segmentation bound for bound against the JAX layer
  (no world), and ``split_pipeline_sections`` with its checks.
"""

import numpy as np
import pytest

from torch_dist_workers import shared_world
from torch_parity_helpers import torch_one_thread  # noqa: F401

WORLD = 4
CFG = dict(num_hidden_layers=4, max_position_embeddings=64)
LR, CLIP, ACC = 0.5, 1.0, 4
RTOL, ATOL = 5e-4, 1e-5
RUNS = {
    "pp4": dict(hybrid={"pp_degree": 4}, route="wrapper"),
    "pp2mp2": dict(hybrid={"pp_degree": 2, "mp_degree": 2}, route="wrapper"),
    "pp2dp2": dict(hybrid={"pp_degree": 2, "dp_degree": 2}, route="wrapper"),
    "runner": dict(hybrid={"pp_degree": 2, "dp_degree": 2}, route="runner"),
    "untied": dict(hybrid={"pp_degree": 4}, route="untied"),
}
JAX_MESH = {"pp4": {"pp": 4}, "pp2mp2": {"pp": 2, "mp": 2},
            "pp2dp2": {"pp": 2, "dp": 2}}
JAX_OF = {"pp4": "pp4", "pp2mp2": "pp2mp2", "pp2dp2": "pp2dp2",
          "runner": "pp2dp2"}


def _cfg():
    from paddle_tpu_torch.models import gpt_tiny
    return gpt_tiny(**CFG)


def _pipe_state():
    """gpt_tiny's weights from numpy under the pipe model's names: GPT's
    Normal(0, 0.02) matrices and embeddings, small random biases, unit
    LayerNorm scales; the head's ``lm_weight`` is the word embedding."""
    from paddle_tpu_torch.models.gpt import (_expected_shapes,
                                             pipe_state_from_causal)
    cfg = _cfg()
    rng = np.random.default_rng(0)
    state = {}
    for name, shape in _expected_shapes(cfg).items():
        if name.endswith(("ln1.weight", "ln2.weight", "final_norm.weight")):
            state[name] = np.ones(shape, np.float32)
        else:
            state[name] = (rng.standard_normal(shape) * 0.02).astype(
                np.float32)
    return pipe_state_from_causal(state, cfg)


def _batches():
    """One global batch taken three times, so the loss must fall."""
    x = np.random.default_rng(1).integers(0, 256, (8, 32)).astype(np.int64)
    return [(x, np.roll(x, -1, 1))] * 3


def _spmd_cases():
    """``spmd_noremat`` runs ``spmd``'s inputs with ``remat_stage`` off:
    the same numbers, held against the same JAX run."""
    r = np.random.RandomState(0)
    spmd = dict(xs=r.rand(8, 4, 16).astype(np.float32),
                ws=(r.rand(4, 16, 16) * 0.1).astype(np.float32), remat=True)
    return {
        "spmd": spmd, "spmd_noremat": dict(spmd, remat=False),
        "interleaved": dict(xs=r.rand(6, 3, 8).astype(np.float32),
                            ws=(r.rand(8, 8, 8) * 0.2).astype(np.float32)),
    }


def _inputs():
    return dict(cfg=CFG, state=_pipe_state(), batches=_batches(), acc=ACC,
                lr=LR, clip=CLIP, runs=RUNS, spmd=_spmd_cases())



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
    return shared_world(tmp_path_factory, "pipeline", "pipeline_world",
                        WORLD, _inputs, timeout=300)


def _joined(ranks, name):
    """The whole pipe state of run ``name`` from the data-rank-0 ranks'
    stages and shards."""
    from paddle_tpu_torch.models.gpt import merge_mp_states
    runs = [r["runs"][name] for r in ranks]
    mine = sorted((r for r in runs if r["coord"][0] == 0),
                  key=lambda r: r["coord"][1:])
    pp = max(r["coord"][1] for r in runs) + 1
    return merge_mp_states([r["state"] for r in mine], _cfg(), pp)


_JAX = {}


def _jax_pipe(name):
    """The JAX ``PipelineParallel`` on layout ``name`` (computed once)."""
    if name in _JAX:
        return _JAX[name]
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as joptimizer
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel \
        import PipelineParallel
    from paddle_tpu.models.gpt import GPTForCausalLMPipe as JPipe
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
    mesh = collective.build_mesh(JAX_MESH[name])
    collective.set_mesh(mesh)
    try:
        with jpaddle.LazyGuard():
            net = JPipe(jgpt_tiny(**CFG),
                        num_stages=JAX_MESH[name].get("pp", 1))
        net.set_state_dict(_pipe_state())
        opt = joptimizer.SGD(learning_rate=LR, parameters=net.parameters(),
                             grad_clip=jnn.ClipGradByGlobalNorm(CLIP))

        class _Strat:
            pipeline_configs = {"accumulate_steps": ACC,
                                "micro_batch_size": 2}

        eng = PipelineParallel(net, None, _Strat())
        losses = [float(eng.train_batch((x, y), opt))
                  for x, y in _batches()]
        state = {k: np.asarray(v.numpy())
                 for k, v in net.state_dict().items()}
    finally:
        collective.set_mesh(None)
    _JAX[name] = (losses, state)
    return _JAX[name]


@pytest.mark.parametrize("name", ["pp4", "pp2mp2", "pp2dp2", "runner"])
def test_pipeline_matches_the_jax_pipeline(ranks, name):
    losses, state = _jax_pipe(JAX_OF[name])
    for r in ranks:
        assert r["runs"][name]["losses"] == ranks[0]["runs"][name][
            "losses"], "the ranks report different losses"
    got = ranks[0]["runs"][name]["losses"]
    np.testing.assert_allclose(got, losses, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    joined = _joined(ranks, name)
    assert set(joined) == set(state)
    for k, v in state.items():
        np.testing.assert_allclose(joined[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")


def test_the_wrapper_route_and_the_runner_duck_type(ranks):
    """``fleet.distributed_model`` wraps the pipe model at pp > 1 and its
    ``train_batch`` returns a Paddle ``Tensor`` on every rank;
    ``PipelinedRunner`` warns on ``amp_level``, evaluates the batch and
    refuses the folded entry with its ROADMAP item."""
    for r in ranks:
        run = r["runs"]["pp4"]
        assert run["wrapper"] == "PipelineParallelWrapper"
        assert run["loss_types"] == ["Tensor"]
        rn = r["runs"]["runner"]
        assert any("amp_level is not supported" in w for w in rn["warnings"])
        assert "A10" in rn["folded"] and "mesh branch" in rn["folded"]
        assert rn["stats"] == {"entries": 0, "traces": 0}
        assert np.isfinite(rn["eval"]) and rn["eval"] < rn["losses"][0]


def _tied_pairs(ranks, name):
    """``(first stage's table, last stage's head copy)`` of each mp rank."""
    L = CFG["num_hidden_layers"]
    runs = [r["runs"][name] for r in ranks]
    pp = max(r["coord"][1] for r in runs) + 1
    pairs = []
    for first in (r for r in runs if r["coord"][1] == 0):
        last = next(r for r in runs if r["coord"][1] == pp - 1
                    and r["coord"][0] == first["coord"][0]
                    and r["coord"][2] == first["coord"][2])
        pairs.append((first["state"]["_layers_list.0.word_embeddings."
                                     "weight"],
                      last["state"][f"_layers_list.{L + 1}.lm_weight"]))
    return pairs


@pytest.mark.parametrize("name", ["pp4", "pp2mp2", "pp2dp2", "untied"])
def test_the_tied_copies_stay_bit_equal(ranks, name):
    """The (first, last) pair sums the two copies' gradients each step,
    so both copies take the same update; the planted control (that sum
    off) must part them."""
    pairs = _tied_pairs(ranks, name)
    assert pairs
    equal = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                for a, b in pairs)
    assert equal == (name != "untied"), name


def _jax_spmd(name, case):
    key = "spmd" if name.startswith("spmd") else name
    if key not in _JAX:
        _JAX[key] = _jax_spmd_run(key, case)
    return _JAX[key]


def _jax_spmd_run(name, case):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.fleet.meta_parallel import (
        pipeline_spmd, pipeline_spmd_interleaved)
    mesh = collective.build_mesh({"pp": 4}, devices=jax.devices()[:4])
    xs = jnp.asarray(case["xs"])

    def stage_fn(w, x):
        return jnp.tanh(x @ w)

    def run(w):
        if name == "interleaved":
            return pipeline_spmd_interleaved(stage_fn, w, xs, num_stages=4,
                                             vpp_degree=2, mesh=mesh)
        return pipeline_spmd(stage_fn, w, xs, num_stages=4, mesh=mesh,
                             remat_stage=True)

    ws = jnp.asarray(case["ws"])
    out = run(ws)
    g = jax.grad(lambda w: jnp.sum(run(w) ** 2))(ws)
    return np.asarray(out), np.asarray(g)


@pytest.mark.parametrize("name", ["spmd", "spmd_noremat", "interleaved"])
def test_pipeline_spmd_matches_jax(ranks, name):
    case = _spmd_cases()[name]
    out, g = _jax_spmd(name, case)
    for d, r in enumerate(ranks):
        got = r["spmd"][name]
        np.testing.assert_allclose(got["out"], out, rtol=1e-4, atol=1e-5)
        want = [g[d], g[4 + d]] if name == "interleaved" else [g[d]]
        for a, b in zip(got["grads"], want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5,
                                       err_msg=f"{name} rank {d}")


# -- segmentation, no world ----------------------------------------------------
def _items(pkg, n_blocks, callable_at=None):
    """``[Emb, Block x n, Head]`` descriptors of ``pkg`` (the JAX package
    or the port), with a plain callable at ``callable_at``."""
    nn = pkg.nn
    LayerDesc = pkg.distributed.fleet.meta_parallel.LayerDesc

    def cls(name, width):
        def init(self):
            nn.Layer.__init__(self)
            self.fc = nn.Linear(width, width)
        return type(name, (nn.Layer,), {"__init__": init,
                                        "forward": lambda s, x: s.fc(x)})

    Emb, Block, Head = cls("Emb", 4), cls("Block", 4), cls("Head", 4)
    items = [LayerDesc(Emb)] + [LayerDesc(Block) for _ in range(n_blocks)] \
        + [LayerDesc(Head)]
    if callable_at is not None:
        items.insert(callable_at, lambda x: x)
    return items


@pytest.fixture
def no_topology():
    from paddle_tpu_torch.distributed import collective
    prev = collective.get_mesh()
    collective.set_mesh(None)
    yield
    collective.set_mesh(prev)


@pytest.mark.parametrize("n_blocks,stages,seg,callable_at", [
    (2, 2, "layer:Block", None), (4, 2, "layer:Block", None),
    (5, 2, "layer:Block", None), (7, 3, "layer:Block", 3),
    (8, 4, "layer:Block", None), (3, 4, "layer:Block", None),
    (4, 2, "uniform", None), (6, 4, "uniform", 2), (9, 3, "uniform", None)])
def test_segmentation_matches_the_jax_layer(n_blocks, stages, seg,
                                            callable_at, no_topology):
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as tpaddle
    from paddle_tpu.distributed.fleet.meta_parallel import \
        PipelineLayer as JLayer
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer as TLayer
    with jpaddle.LazyGuard():
        jl = JLayer(_items(jpaddle, n_blocks, callable_at),
                    num_stages=stages, seg_method=seg)
    tl = TLayer(_items(tpaddle, n_blocks, callable_at), num_stages=stages,
                seg_method=seg)
    assert tl.segment_parts == jl.segment_parts
    for s in range(stages):
        assert [type(l).__name__ if l is not None else None
                for l, _ in tl.get_stage_layers(s)] == \
            [type(l).__name__ if l is not None else None
             for l, _ in jl.get_stage_layers(s)]


def test_gpt_pipe_segmentation_and_names_match_jax(no_topology):
    """The GPT pipe model's stages and state names are the JAX model's."""
    import paddle_tpu as jpaddle
    from paddle_tpu.models.gpt import GPTForCausalLMPipe as JPipe
    from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
    from paddle_tpu_torch.models import GPTForCausalLMPipe
    for stages in (1, 2, 4):
        with jpaddle.LazyGuard():
            jnet = JPipe(jgpt_tiny(**CFG), num_stages=stages)
        tnet = GPTForCausalLMPipe(_cfg(), num_stages=stages, device="cpu")
        assert tnet.segment_parts == jnet.segment_parts
        assert list(tnet.state_dict()) == list(jnet.state_dict())


def _sections_net(pkg, kinds):
    nn = pkg.nn
    PipelineLayer = pkg.distributed.fleet.meta_parallel.PipelineLayer

    class Body(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)

        def forward(self, x):
            return self.fc(x)

    class Wide(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 8)

        def forward(self, x):
            return self.fc(x)

    make = {"lin": lambda: nn.Linear(4, 4), "body": Body, "wide": Wide,
            "head": lambda: nn.Linear(4, 8)}
    return PipelineLayer([make[k]() for k in kinds], num_stages=3)


@pytest.mark.parametrize("kinds,pattern", [
    (["lin", "body", "body", "body", "head"], None),
    (["body", "body", "wide", "wide", "wide", "body"], None),
    (["lin", "body", "body", "body", "head"], "Body"),
    (["lin", "body", "wide", "body", "head"], "Body"),
    (["lin", "wide", "head"], "Body")])
def test_split_pipeline_sections_matches_jax(kinds, pattern, no_topology):
    """The pre / body / post split, and the refusals (a pattern that
    matches nothing, a body with gaps) with the JAX messages."""
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as tpaddle
    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel \
        import split_pipeline_sections as jsplit
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        split_pipeline_sections as tsplit
    jnet = _sections_net(jpaddle, kinds)
    tnet = _sections_net(tpaddle, kinds)
    try:
        want = jsplit(jnet, pattern)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsplit(tnet, pattern)
        assert str(got.value).split(";")[0] == str(e).split(";")[0]
        return
    got = tsplit(tnet, pattern)
    assert [len(p) for p in got] == [len(p) for p in want]
    assert [type(l).__name__ for l in got[1]] == \
        [type(l).__name__ for l in want[1]]
