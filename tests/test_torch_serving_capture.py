"""The decode step as one captured CUDA graph, and the sampling it
holds, against the JAX package and a numpy reimplementation.

On the CPU the engine runs the graph's body eagerly on the same static
buffers, so these tests hold everything but the capture itself: the
hashed Gumbel noise bit for bit against numpy ``uint64`` arithmetic,
``sample_tokens`` on ``[B]`` tensors against the JAX ``sample_tokens``
with the JAX package's noise injected (exact tokens), the static
buffers' addresses across a join/leave pattern, one fresh tensor per
dispatch behind the ``LazyStack``s, and greedy engine tokens equal to
the JAX engine's.  The ``cuda``-marked tests hold one capture per
variant and replays against ``reference_decode`` on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM, gpt_tiny
from paddle_tpu.inference.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import decode_model as jdm
from paddle_tpu.inference.serving import sample_tokens as jax_sample_tokens

from paddle_tpu_torch.inference.serving import (
    DecodeEngine, LLMServer, ServingModelConfig, gumbel_noise,
    params_from_numpy, reference_decode, sample_tokens)
from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
from paddle_tpu_torch.inference.serving.sampling import noise_bits
from torch_parity_helpers import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(0)
    cfg = gpt_tiny(use_flash_attention=False)
    net = GPTForCausalLM(cfg)
    net.eval()
    jparams = jdm.extract_decode_params(net)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jparams)
    return cfg, jparams, tree


def _prompts(seed, lens, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lens]


def _engine(tree, cfg, device="cpu", **kw):
    base = dict(params=params_from_numpy(tree, device=device),
                gpt_config=cfg, max_batch=2, block_size=8, num_blocks=64,
                device=device)
    base.update(kw)
    return DecodeEngine(**base)


# ---------------------------------------------------------------------------
# the hashed noise
# ---------------------------------------------------------------------------
_M32 = np.uint64(0xFFFFFFFF)


def _np_mul32(x, c):
    return (x * np.uint64(c)) & _M32          # uint64 wraps mod 2**64


def _np_fmix32(x):
    x = x ^ (x >> np.uint64(16))
    x = _np_mul32(x, 0x85EBCA6B)
    x = x ^ (x >> np.uint64(13))
    x = _np_mul32(x, 0xC2B2AE35)
    return x ^ (x >> np.uint64(16))


def _np_noise(seeds, positions, vocab):
    s = np.asarray(seeds, dtype=np.uint64) & _M32
    p = np.asarray(positions, dtype=np.uint64) & _M32
    row = _np_fmix32(_np_fmix32(s ^ np.uint64(0x9E3779B9)) ^ p)
    col = np.arange(vocab, dtype=np.uint64)
    h = _np_fmix32(row[:, None] ^ _np_mul32(col, 0x27D4EB2F)[None])
    u = ((h >> np.uint64(8)).astype(np.float64) + 0.5) * 2.0 ** -24
    return h, (-np.log(-np.log(u))).astype(np.float32)


def test_noise_matches_numpy_uint64_bit_for_bit():
    seeds = [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789]
    positions = [0, 1, 17, 4096, 32767, 2 ** 31 - 1]
    V = 1000
    h_ref, g_ref = _np_noise(seeds, positions, V)
    s = torch.tensor(seeds, dtype=torch.int64)
    p = torch.tensor(positions, dtype=torch.int64)
    h = noise_bits(s, p, V)
    assert h.dtype == torch.int64
    assert np.array_equal(h.numpy().astype(np.uint64), h_ref)
    g = gumbel_noise(s, p, V)
    assert g.dtype == torch.float32
    assert np.array_equal(g.numpy().view(np.uint32), g_ref.view(np.uint32))
    # the engine stages uint32 seeds as int32 bits: the same stream
    g32 = gumbel_noise(s.to(torch.int32), p.to(torch.int32), V)
    assert np.array_equal(g32.numpy(), g.numpy())
    assert np.isfinite(g_ref).all()


def test_noise_is_a_function_of_seed_and_position_only():
    V = 257
    a = gumbel_noise(torch.tensor([5, 9]), torch.tensor([3, 3]), V)
    b = gumbel_noise(torch.tensor([9, 7, 5]), torch.tensor([3, 1, 3]), V)
    assert torch.equal(a[0], b[2]) and torch.equal(a[1], b[0])
    assert not torch.equal(a[0], a[1])
    c = gumbel_noise(torch.tensor([5]), torch.tensor([4]), V)
    assert not torch.equal(a[0], c[0])
    # uniform from the top 24 bits: never 0 or 1, so the noise is finite
    # and spans the Gumbel's range
    g = gumbel_noise(torch.arange(64), torch.zeros(64, dtype=torch.long),
                     4096)
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.01


# ---------------------------------------------------------------------------
# sample_tokens against the JAX package
# ---------------------------------------------------------------------------
def _jax_noise(seeds, positions, V):
    def row(s, p):
        key = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return jax.random.gumbel(key, (V,), dtype=jnp.float32)
    return np.array(jax.vmap(row)(jnp.asarray(seeds, jnp.uint32),
                                  jnp.asarray(positions, jnp.int32)))


@pytest.mark.parametrize("temps,k,p", [
    ((0.0, 0.0, 0.0, 0.0), 0, 1.0),          # all greedy
    ((1.0, 0.0, 2.0, 0.7), 0, 1.0),          # mixed, no filter
    ((1.3, 1.3, 0.0, 1.3), 5, 1.0),          # top-k
    ((1.0, 0.9, 1.0, 0.0), 0, 0.6),          # top-p
    ((0.8, 1.1, 0.5, 2.0), 7, 0.9),          # both
    ((3.0, 3.0, 3.0, 3.0), 1, 1e-6),         # both collapse to argmax
])
def test_sample_tokens_matches_jax_with_its_noise_injected(temps, k, p):
    rng = np.random.RandomState(29)
    B, V = 4, 24
    logits = rng.randn(B, V).astype(np.float32) * 3
    seeds = [5, 6, 2 ** 32 - 1, 11]
    positions = [0, 3, 9, 100]
    want = np.asarray(jax_sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps, jnp.float32),
        jnp.full((B,), k, jnp.int32), jnp.full((B,), p, jnp.float32),
        jnp.asarray(seeds, jnp.uint32), jnp.asarray(positions, jnp.int32)))
    noise = torch.from_numpy(_jax_noise(seeds, positions, V))
    got = sample_tokens(
        torch.from_numpy(logits), torch.tensor(temps, dtype=torch.float32),
        torch.full((B,), k, dtype=torch.int32),
        torch.full((B,), p, dtype=torch.float32),
        torch.tensor(seeds, dtype=torch.int64),
        torch.tensor(positions, dtype=torch.int32), noise=noise)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()
    greedy = np.argmax(logits, axis=-1)
    for b in range(B):
        if temps[b] == 0.0:
            assert got[b] == greedy[b]


def test_sample_tokens_hashed_noise_stays_in_the_filters():
    rng = np.random.RandomState(29)
    B, V = 4, 24
    logits = torch.from_numpy(rng.randn(B, V).astype(np.float32) * 3)
    top5 = torch.topk(logits, 5, dim=-1).indices
    probs = torch.softmax(logits, dim=-1).numpy()

    def run(temp, k, p, seed):
        return sample_tokens(logits, torch.full((B,), temp),
                             torch.full((B,), k, dtype=torch.int32),
                             torch.full((B,), p),
                             torch.full((B,), seed, dtype=torch.int64),
                             torch.arange(B))

    seen = set()
    for seed in range(20):
        got = run(2.0, 5, 1.0, seed)
        for b in range(B):
            assert int(got[b]) in top5[b].tolist()
            seen.add((b, int(got[b])))
        got = run(1.0, 0, 0.6, seed)
        for b in range(B):
            order = np.argsort(-probs[b])
            csum = np.cumsum(probs[b][order])
            nucleus = order[:int(np.searchsorted(csum, 0.6,
                                                 side="left")) + 1]
            assert int(got[b]) in nucleus.tolist()
    assert len(seen) > B                      # it did sample
    assert torch.equal(run(1.3, 7, 0.9, 123), run(1.3, 7, 0.9, 123))


# ---------------------------------------------------------------------------
# the engine's static buffers
# ---------------------------------------------------------------------------
def _static_ptrs(eng):
    return {name: getattr(eng, name).data_ptr() for name in (
        "_layout_dev", "_table_dev", "_lengths_dev", "_samp_dev",
        "_temps_dev", "_seeds_dev", "_tokens", "_done")} | {
        "pool": eng._kv.pool.data_ptr()}


def test_static_buffers_keep_their_addresses_across_join_and_leave(tiny):
    cfg, _, tree = tiny
    eng = _engine(tree, cfg, eos_id=None)
    ptrs = _static_ptrs(eng)
    prompts = _prompts(3, (5, 12, 9, 20), cfg.vocab_size)
    for i, (p, m) in enumerate(zip(prompts, (3, 7, 2, 5))):
        eng.submit(p, max_tokens=m, temperature=0.8 * (i % 2), seed=i)
    while eng.step():
        assert _static_ptrs(eng) == ptrs
    assert eng.stats()["completed"] == 4


def test_each_dispatch_stacks_a_fresh_tensor(tiny):
    cfg, _, tree = tiny
    eng = _engine(tree, cfg)
    prompt = _prompts(4, (7,), cfg.vocab_size)[0]
    held = []                  # each token's stack tensor, at push time

    def on_token(rid, i, tok):
        held.append(tok._dev._dev)

    req = eng.submit(prompt, max_tokens=6, stream_cb=on_token)
    eng.run_until_idle()
    # token 0 comes from the prefill; tokens 1.. from one dispatch each,
    # each a tensor of its own that later dispatches never write
    devs = held[1:]
    assert len(devs) == 5
    assert len({id(t) for t in devs}) == len(devs)
    assert all(t.data_ptr() != eng._tokens.data_ptr() for t in devs)
    ref, _ = reference_decode(params_from_numpy(tree, device="cpu"),
                              ServingModelConfig.from_gpt_config(cfg),
                              prompt, 6)
    assert req.future.result(timeout=0).tokens == ref.tolist()
    assert [int(t[req.slot]) for t in devs] == ref.tolist()[1:]


def test_sampling_vectors_restage_only_when_they_change(tiny):
    cfg, _, tree = tiny
    eng = _engine(tree, cfg)
    prompts = _prompts(5, (6, 10), cfg.vocab_size)
    eng.submit(prompts[0], max_tokens=8)                  # greedy
    eng.step()
    assert eng._samp_stale                  # seated, greedy: not staged
    eng.submit(prompts[1], max_tokens=4, temperature=0.7, top_k=5,
               top_p=0.9, seed=2 ** 32 - 3)
    eng.step()                              # seats it, mixed dispatch
    assert not eng._samp_stale
    assert np.array_equal(eng._samp_dev.numpy(), eng._samp_host)
    assert eng._seeds_dev[1].item() & 0xFFFFFFFF == 2 ** 32 - 3
    before = eng._samp_dev.clone()
    eng.step()                              # nothing changed: no copy
    assert not eng._samp_stale and torch.equal(eng._samp_dev, before)
    eng.run_until_idle()
    assert eng._samp_stale                  # finalize cleared a slot
    # nothing captures on the CPU; the two prompts ran two group keys
    assert eng.compile_stats() == {
        "decode_captures": 0, "prefill_captures": 0, "chunk_captures": 0,
        "prefill_programs": 2, "chunk_programs": 0}


def test_warmup_runs_both_variants_before_traffic(tiny):
    cfg, _, tree = tiny
    eng = _engine(tree, cfg)
    w = eng.warmup([5])
    assert w["decode_captures"] == 0 and w["buckets"] == [8]
    assert eng._tokens.tolist() == [0, 0]             # pad on every slot
    eng.submit([1, 2, 3], max_tokens=30)
    eng.step()
    with pytest.raises(RuntimeError):
        eng.warmup([5])


def test_submit_never_touches_the_device(tiny, monkeypatch):
    """``submit`` (engine and server) runs on callers' threads: it must
    make no tensor at all, so it cannot reach a captured stream."""
    cfg, _, tree = tiny
    server = LLMServer(params=params_from_numpy(tree, device="cpu"),
                       gpt_config=cfg, max_batch=2, block_size=8,
                       num_blocks=64, device="cpu", auto_start=False)

    def refuse(*a, **k):
        raise AssertionError("submit made a tensor")

    for name in ("tensor", "as_tensor", "from_numpy", "empty", "zeros",
                 "ones", "full"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "to", refuse)
    server.engine.submit([1, 2, 3], max_tokens=2)
    fut = server.submit([4, 5], max_tokens=2, temperature=0.5, seed=1)
    monkeypatch.undo()
    server.start()
    try:
        assert len(fut.result(timeout=60).tokens) == 2
    finally:
        server.close()


# ---------------------------------------------------------------------------
# greedy tokens against the JAX engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_eos", [False, True])
def test_greedy_engine_tokens_equal_jax_engine_over_join_leave(tiny,
                                                                with_eos):
    cfg, jparams, tree = tiny
    prompts = _prompts(41, (3, 9, 17, 30, 5, 12, 21), cfg.vocab_size)
    maxt = [6, 9, 4, 7, 8, 5, 10]
    eos = None
    if with_eos:
        ref, _ = reference_decode(params_from_numpy(tree, device="cpu"),
                                  ServingModelConfig.from_gpt_config(cfg),
                                  prompts[1], maxt[1])
        eos = int(ref[3])
    jeng = JaxDecodeEngine(params=jparams, gpt_config=cfg, max_batch=3,
                           block_size=8, num_blocks=64, eos_id=eos,
                           attention="gather", done_poll_interval=2)
    jf = [jeng.submit(p, max_tokens=m).future
          for p, m in zip(prompts, maxt)]
    jeng.run_until_idle()
    teng = _engine(tree, cfg, max_batch=3, eos_id=eos,
                   done_poll_interval=2)
    tf = [teng.submit(p, max_tokens=m).future
          for p, m in zip(prompts[:3], maxt[:3])]
    for _ in range(3):
        teng.step()                    # leave and join mid-flight
    tf += [teng.submit(p, max_tokens=m).future
           for p, m in zip(prompts[3:], maxt[3:])]
    teng.run_until_idle()
    jt = [f.result(timeout=0).tokens for f in jf]
    tt = [f.result(timeout=0).tokens for f in tf]
    assert tt == jt
    if with_eos:
        assert any(t[-1] == eos and len(t) < m for t, m in zip(tt, maxt))
    st = teng.stats()
    assert st["kv"]["allocated"] == 0 and st["kv"]["reserved"] == 0
    assert st["dispatch_host_us_p50"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_one_capture_per_variant_and_replays_match_reference(
        tiny, cuda_device):
    cfg, _, tree = tiny
    params = params_from_numpy(tree, device=cuda_device)
    scfg = ServingModelConfig.from_gpt_config(cfg)
    eng = DecodeEngine(params=params, gpt_config=cfg, max_batch=3,
                       block_size=16, num_blocks=64, device=cuda_device)
    prompts = _prompts(43, (5, 17, 40, 9, 33, 12), cfg.vocab_size)
    kw = [dict(), dict(temperature=0.9, top_k=20, top_p=0.9, seed=7),
          dict(), dict(temperature=1.2, seed=3), dict(), dict()]
    pak.paged_ragged_attention.launches = 0
    futs, captures = {}, []
    # greedy only, then sampled rows joining greedy ones, then greedy
    for group in ((0, 2), (1, 3, 4), (5,)):
        for i in group:
            futs[i] = eng.submit(prompts[i], max_tokens=12, **kw[i]).future
        eng.run_until_idle()
        captures.append(eng.compile_stats()["decode_captures"])
    assert captures == [1, 2, 2]
    assert pak.paged_ragged_attention.launches == \
        eng.stats()["dispatches"] * cfg.num_hidden_layers
    for i, f in futs.items():
        ref, _ = reference_decode(params, scfg, prompts[i], 12, **kw[i])
        assert f.result(timeout=0).tokens == ref.tolist()


@pytest.mark.cuda
def test_cuda_hashed_noise_equals_the_cpu_bits(cuda_device):
    s = torch.arange(8, dtype=torch.int64) * 7919 + 2 ** 31
    p = torch.arange(8, dtype=torch.int64) * 4099
    cpu = gumbel_noise(s, p, 50304)
    card = gumbel_noise(s.to(cuda_device), p.to(cuda_device), 50304).cpu()
    assert torch.equal(noise_bits(s, p, 50304),
                       noise_bits(s.to(cuda_device), p.to(cuda_device),
                                  50304).cpu())
    assert torch.equal(cpu, card)
