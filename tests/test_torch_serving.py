"""The serving slice of the PyTorch port against the JAX package.

Same inputs (numpy, fixed seeds) and the same ``gpt_tiny`` weights,
carried across with ``params_from_numpy``, go through both packages on
the CPU.  Tolerances: 2e-6 for the attention functions (the reference's
own bound between its paths), 1e-5 on logits of the whole forward
(float32 matmuls reassociated by two libraries over a 2-layer model),
exact equality for greedy tokens, page contents and allocator state.
Sampled tokens cannot compare across packages (threefry vs Philox), so
the seeded-sampling contract is pinned within the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM, gpt_tiny
from paddle_tpu.inference.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import QueueFull as JaxQueueFull
from paddle_tpu.inference.serving import kv_cache as jkv
from paddle_tpu.inference.serving import ragged_attention as jra
from paddle_tpu.inference.serving import decode_model as jdm

from paddle_tpu_torch.framework.lazy import LazyScalar, LazyStack
from paddle_tpu_torch.inference.serving import (
    BlockAllocator, DecodeEngine, LLMServer, QueueFull, SCRATCH_BLOCK,
    ServingModelConfig, causal_prefill_attention, decode_forward,
    gather_pages, paged_append, params_from_numpy, prefill_group_forward,
    ragged_decode_attention, reference_decode, write_prompt_pages_group)
from paddle_tpu_torch.models import gpt_tiny as torch_gpt_tiny

ATTN_TOL = 2e-6
LOGIT_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny():
    paddle.seed(0)
    cfg = gpt_tiny(use_flash_attention=False)
    net = GPTForCausalLM(cfg)
    net.eval()
    jparams = jdm.extract_decode_params(net)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jparams)
    tparams = params_from_numpy(tree, device="cpu")
    scfg = jdm.ServingModelConfig.from_gpt_config(cfg)
    return net, cfg, jparams, tparams, scfg


def _prompts(seed, lens, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lens]


def _engine(tparams, cfg, **kw):
    base = dict(params=tparams, gpt_config=cfg, max_batch=2,
                block_size=8, num_blocks=64, device="cpu")
    base.update(kw)
    return DecodeEngine(**base)


# ---------------------------------------------------------------------------
# kv cache
# ---------------------------------------------------------------------------
def test_allocator_matches_jax_allocator_step_for_step():
    ops = [("a", 5), ("a", 3), ("f", 0), ("a", 2), ("a", 6), ("f", 2),
           ("a", 4), ("f", 1), ("a", 7)]
    ja, ta = jkv.BlockAllocator(33), BlockAllocator(33)
    held_j, held_t = [], []
    for op, arg in ops:
        if op == "a":
            held_j.append(ja.allocate(arg))
            held_t.append(ta.allocate(arg))
            assert held_t[-1] == held_j[-1]
            assert SCRATCH_BLOCK not in held_t[-1]
        else:
            ja.free(held_j.pop(arg))
            ta.free(held_t.pop(arg))
        js, ts = ja.stats(), ta.stats()
        for key in ts:
            assert ts[key] == js[key], key
    with pytest.raises(ValueError):
        ta.free([held_t[0][0], held_t[0][0]])        # double free


def test_allocator_reservations():
    a = BlockAllocator(9)                            # 8 usable
    assert a.reserve(5) and not a.can_reserve(4)
    assert a.reserve(3) and not a.reserve(1)
    a.release(5)
    assert a.reserve(5)
    a.release(8)
    assert a.reserved == 0
    with pytest.raises(ValueError):
        a.release(1)


def test_pool_ops_match_jax():
    rng = np.random.RandomState(3)
    L, NB, BS, H, Dh, G, nb = 2, 10, 4, 2, 8, 3, 2
    pool0 = rng.randn(L, 2, NB, BS, H, Dh).astype(np.float32)
    kv = rng.randn(L, 2, G, nb * BS, H, Dh).astype(np.float32)
    blocks = np.array([[3, 7], [5, SCRATCH_BLOCK], [SCRATCH_BLOCK,
                                                    SCRATCH_BLOCK]],
                      dtype=np.int32)
    jpool = jkv.write_prompt_pages_group(jnp.asarray(pool0),
                                         jnp.asarray(kv),
                                         jnp.asarray(blocks))
    tpool = torch.from_numpy(pool0.copy())
    write_prompt_pages_group(tpool, torch.from_numpy(kv),
                             torch.from_numpy(blocks))
    real = [b for b in range(1, NB)]                 # scratch is never read
    np.testing.assert_array_equal(tpool.numpy()[:, :, real],
                                  np.asarray(jpool)[:, :, real])

    k_new = rng.randn(3, H, Dh).astype(np.float32)
    v_new = rng.randn(3, H, Dh).astype(np.float32)
    bids = np.array([3, SCRATCH_BLOCK, 9], np.int32)
    offs = np.array([1, 0, 3], np.int32)
    jpool = jkv.paged_append(jpool, 1, jnp.asarray(k_new),
                             jnp.asarray(v_new), jnp.asarray(bids),
                             jnp.asarray(offs))
    paged_append(tpool, 1, torch.from_numpy(k_new),
                 torch.from_numpy(v_new), torch.from_numpy(bids),
                 torch.from_numpy(offs))
    np.testing.assert_array_equal(tpool.numpy()[:, :, real],
                                  np.asarray(jpool)[:, :, real])

    table = np.array([[3, 7, 0], [9, 5, 2]], np.int32)
    jk, jv = jkv.gather_pages(jpool, 1, jnp.asarray(table))
    tk, tv = gather_pages(tpool, 1, torch.from_numpy(table))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------
def test_ragged_decode_attention_matches_jax():
    rng = np.random.RandomState(0)
    B, T, H, Dh = 4, 24, 2, 8
    lengths = np.array([24, 7, 1, 0], dtype=np.int32)
    q = rng.randn(B, H, Dh).astype(np.float32)
    k = rng.randn(B, T, H, Dh).astype(np.float32)
    v = rng.randn(B, T, H, Dh).astype(np.float32)
    ref = np.asarray(jra.ragged_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths)), dtype=np.float32)
    out = ragged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL)
    assert np.all(out[3] == 0.0)


def test_causal_prefill_attention_matches_jax():
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 16, 2, 8).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jra.causal_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), dtype=np.float32)
    out = causal_prefill_attention(*(torch.from_numpy(a)
                                     for a in (q, k, v))).numpy()
    np.testing.assert_allclose(out, ref, rtol=ATTN_TOL, atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# model forwards
# ---------------------------------------------------------------------------
def test_prefill_and_three_decode_steps_match_jax(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    tcfg = ServingModelConfig.from_gpt_config(cfg)
    assert tcfg == ServingModelConfig(**scfg.__dict__)
    BS, NB, MAXNB, Lb = 8, 16, 4, 16
    lens = np.array([11, 5], np.int32)
    ids = np.zeros((2, Lb), np.int32)
    for g, n in enumerate(lens):
        ids[g, :n] = _prompts(g, [n], cfg.vocab_size)[0]
    zf, zi, one, zu = (np.zeros(2, np.float32), np.zeros(2, np.int32),
                       np.ones(2, np.float32), np.zeros(2, np.uint32))
    jkvs, jtok, jlog = jdm.prefill_group_forward(
        jparams, scfg, jnp.asarray(ids), jnp.asarray(lens),
        jnp.asarray(zf), jnp.asarray(zi), jnp.asarray(one),
        jnp.asarray(zu))
    tkvs, ttok, tlog = prefill_group_forward(
        tparams, tcfg, torch.from_numpy(ids), lens, zf, zi, one, zu)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog, np.float32),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tkvs.numpy(), np.asarray(jkvs, np.float32),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert ttok.dtype == torch.int32
    assert ttok.tolist() == np.asarray(jtok, np.int32).tolist()

    table = np.zeros((2, MAXNB), np.int32)
    table[0, :3] = [4, 9, 2]
    table[1, :2] = [7, 11]
    blocks = table[:, :Lb // BS]
    jpool = jnp.zeros((cfg.num_hidden_layers, 2, NB, BS, scfg.num_heads,
                       scfg.head_dim), jnp.float32)
    jpool = jkv.write_prompt_pages_group(jpool, jkvs, jnp.asarray(blocks))
    tpool = torch.zeros(tuple(jpool.shape))
    write_prompt_pages_group(tpool, tkvs, torch.from_numpy(blocks))
    lengths = lens.copy()
    jtoks = jnp.asarray(np.asarray(jtok, np.int32))
    ttoks = ttok
    ok = np.array([True, True])
    for _ in range(3):
        jpool, jl = jdm.decode_forward(
            jparams, scfg, jpool, jnp.asarray(table), jnp.asarray(lengths),
            jtoks, jnp.asarray(ok))
        tl = decode_forward(tparams, tcfg, tpool, torch.from_numpy(table),
                            torch.from_numpy(lengths), ttoks,
                            torch.from_numpy(ok))
        jl = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
        assert tl.argmax(-1).tolist() == jl.argmax(-1).tolist()
        jtoks = jnp.asarray(jl.argmax(-1).astype(np.int32))
        ttoks = tl.argmax(-1).to(torch.int32)
        lengths = lengths + 1


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
def test_engine_token_identical_to_jax_engine(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    prompts = _prompts(11, (3, 9, 17, 30, 5, 12), cfg.vocab_size)
    maxt = [6, 9, 4, 7, 8, 5]
    jeng = JaxDecodeEngine(params=jparams, gpt_config=cfg, max_batch=2,
                           block_size=8, num_blocks=64,
                           attention="gather", done_poll_interval=4)
    jf = [jeng.submit(p, max_tokens=m).future
          for p, m in zip(prompts, maxt)]
    jeng.run_until_idle()
    teng = _engine(tparams, cfg)
    tf = [teng.submit(p, max_tokens=m).future
          for p, m in zip(prompts, maxt)]
    teng.run_until_idle()
    jt = [f.result(timeout=0).tokens for f in jf]
    tt = [f.result(timeout=0).tokens for f in tf]
    assert tt == jt
    assert [len(t) for t in tt] == maxt
    st = teng.stats()
    assert st["completed"] == 6 and st["total_tokens"] == sum(maxt)
    assert st["kv"]["allocated"] == 0 and st["kv"]["reserved"] == 0
    # and the port's own sequential oracle agrees
    ref, _ = reference_decode(tparams, ServingModelConfig.from_gpt_config(
        cfg), prompts[3], maxt[3])
    assert ref.tolist() == tt[3]


def test_eos_truncation_matches_jax(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    prompt = _prompts(5, (7,), cfg.vocab_size)[0]
    ref, _ = reference_decode(tparams,
                              ServingModelConfig.from_gpt_config(cfg),
                              prompt, 12)
    toks = ref.tolist()
    eos = toks[4]
    jeng = JaxDecodeEngine(params=jparams, gpt_config=cfg, max_batch=2,
                           block_size=8, num_blocks=64, eos_id=eos,
                           attention="gather", done_poll_interval=2)
    jf = jeng.submit(prompt, max_tokens=12).future
    jeng.run_until_idle()
    teng = _engine(tparams, cfg, eos_id=eos, done_poll_interval=2)
    tf = teng.submit(prompt, max_tokens=12).future
    teng.run_until_idle()
    got = tf.result(timeout=0).tokens
    assert got == jf.result(timeout=0).tokens
    assert got[-1] == eos and got == toks[:toks.index(eos) + 1]
    assert teng.stats()["kv"]["allocated"] == 0


def test_queue_full_and_oversize_rejection_match_jax(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    jeng = JaxDecodeEngine(params=jparams, gpt_config=cfg, max_batch=2,
                           block_size=8, num_blocks=9, max_queue=2,
                           attention="gather")
    teng = _engine(tparams, cfg, num_blocks=9, max_queue=2)
    cases = [
        ([1] * 200, 4),          # prompt beyond the largest bucket
        ([1] * 40, 40),          # worst case > 8 usable blocks
        ([1] * 100, 40),         # prompt + max_tokens > max context
    ]
    for prompt, m in cases:
        for eng in (jeng, teng):
            with pytest.raises(ValueError):
                eng.submit(prompt, max_tokens=m)
    for eng, exc in ((jeng, JaxQueueFull), (teng, QueueFull)):
        eng.submit([1, 2], max_tokens=2)
        eng.submit([1, 2], max_tokens=2)
        with pytest.raises(exc):
            eng.submit([1, 2], max_tokens=2)
    with pytest.raises(ValueError):
        teng.submit([], max_tokens=2)
    with pytest.raises(ValueError):
        teng.submit([1], max_tokens=0)


def test_seeded_sampling_deterministic_within_the_port(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    prompts = _prompts(21, (6, 13, 4, 9), cfg.vocab_size)
    kw = dict(max_tokens=8, temperature=0.9, top_k=20, top_p=0.9)

    def run(batch, seeds):
        eng = _engine(tparams, cfg, max_batch=batch)
        futs = [eng.submit(p, seed=s, **kw).future
                for p, s in zip(prompts, seeds)]
        eng.run_until_idle()
        return [f.result(timeout=0).tokens for f in futs]

    a = run(1, [1, 2, 3, 4])             # alone, one at a time
    b = run(2, [1, 2, 3, 4])             # churning batch of two
    c = run(2, [1, 2, 3, 4])
    d = run(2, [5, 6, 7, 8])
    assert a == b == c
    assert d != a
    ref, _ = reference_decode(tparams,
                              ServingModelConfig.from_gpt_config(cfg),
                              prompts[1], 8, temperature=0.9, top_k=20,
                              top_p=0.9, seed=2)
    assert ref.tolist() == a[1]
    greedy = run(2, [0, 0, 0, 0])
    assert greedy != a                   # sampling actually sampled


def test_llm_server_pump_thread_and_streaming(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    prompts = _prompts(31, (5, 17, 8), cfg.vocab_size)
    streamed = {}

    def on_token(rid, i, tok):
        streamed.setdefault(rid, []).append((i, int(tok)))

    server = LLMServer(params=tparams, gpt_config=cfg, max_batch=2,
                       block_size=8, num_blocks=64, device="cpu",
                       auto_start=False)
    warm = server.warmup([5, 17])
    assert warm["buckets"] == [8, 32]
    with server.start():
        futs = [server.submit(p, max_tokens=6, stream_cb=on_token)
                for p in prompts]
        results = [f.result(timeout=120) for f in futs]
    for p, r in zip(prompts, results):
        ref, _ = reference_decode(
            tparams, ServingModelConfig.from_gpt_config(cfg), p, 6)
        assert r.tokens == ref.tolist()
        assert streamed[r.request_id] == list(enumerate(r.tokens))
    st = server.stats()
    assert st["completed"] == 3 and st["dispatches"] > 0
    assert st["ttft_p50_s"] is not None and "warmup" in st
    assert not server.running


def test_deferred_features_raise(tiny):
    net, cfg, jparams, tparams, scfg = tiny
    for kw in (dict(prefill_chunk=16), dict(prefix_cache=True),
               dict(role="decode"), dict(spec_k=2),
               dict(draft_params=tparams), dict(done_poll_interval=None)):
        with pytest.raises(NotImplementedError):
            _engine(tparams, cfg, **kw)
    with pytest.raises(NotImplementedError):
        DecodeEngine(net, device="cpu")


def test_lazy_stack_fetches_once():
    calls = []

    class Dev:
        def detach(self):
            calls.append(1)
            return torch.tensor([4, 5, 6], dtype=torch.int32)

    stack = LazyStack(Dev())
    views = [LazyScalar(stack, post=(lambda a, i=i: a[i]))
             for i in range(3)]
    assert [int(v) for v in views] == [4, 5, 6]
    assert len(calls) == 1


def test_port_gpt_configs_match_jax():
    from paddle_tpu.models import gpt2_small, gpt3_1p3b
    from paddle_tpu_torch.models import gpt2_small as t_small
    from paddle_tpu_torch.models import gpt3_1p3b as t_1p3b
    for jf, tf in ((gpt_tiny, torch_gpt_tiny), (gpt2_small, t_small),
                   (gpt3_1p3b, t_1p3b)):
        assert jf().__dict__ == tf().__dict__
