"""Chunked prefill and the shared-prefix cache of the PyTorch port
against the JAX package (the counterpart of
``tests/test_serving_longcontext.py``).

Same ``gpt_tiny`` weights (``params_from_numpy`` of the JAX package's
``extract_decode_params``) and the same numpy prompts go through both
packages on the CPU.  Tolerances: 2e-6 for the chunk attention (the
reference's own bound between its paths), 1e-5 on a chunk's logits
(float32 matmuls reassociated by two libraries over a 2-layer model),
exact equality for greedy tokens, page contents written from the same
K/V, allocator and prefix-cache state.  Sampled tokens compare within
the port (its hashed noise is not the JAX package's threefry).

The JAX file's kernel-seam tests select the JAX engine's ``attention=``
mode (the Pallas kernel or its gather reference); the port has one
decode-attention seam that picks by device, so they have no
counterpart here (``tests/test_torch_paged_attention.py`` holds the
kernel's plain version against the JAX kernel).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM, gpt_tiny
from paddle_tpu.inference.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import PrefixCache as JaxPrefixCache
from paddle_tpu.inference.serving import BlockAllocator as JaxAllocator
from paddle_tpu.inference.serving import decode_model as jdm
from paddle_tpu.inference.serving import ragged_attention as jra

from paddle_tpu_torch.inference.serving import (
    BlockAllocator, DecodeEngine, OutOfBlocks, PrefixCache, SCRATCH_BLOCK,
    ServingModelConfig, chunk_prefill_forward, chunked_prefill_attention,
    params_from_numpy, reference_decode)
from torch_parity_helpers import torch_one_thread  # noqa: F401

ATTN_TOL = 2e-6
LOGIT_TOL = 1e-5


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
    return cfg, jparams, tparams


def _engine(tparams, cfg, **kw):
    base = dict(params=tparams, gpt_config=cfg, max_batch=2,
                block_size=8, num_blocks=64, device="cpu")
    base.update(kw)
    return DecodeEngine(**base)


def _jax_engine(jparams, cfg, **kw):
    base = dict(params=jparams, gpt_config=cfg, max_batch=2,
                block_size=8, num_blocks=64, attention="gather")
    base.update(kw)
    return JaxDecodeEngine(**base)


def _ref(tparams, cfg, prompt, n, **kw):
    toks, _ = reference_decode(tparams, ServingModelConfig.from_gpt_config(
        cfg), prompt, n, **kw)
    return toks.tolist()


# ---------------------------------------------------------------------------
# the composed pieces against the JAX functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ctx_len,T,C", [(0, 8, 16), (13, 24, 16),
                                         (40, 40, 8)])
def test_chunked_prefill_attention_matches_jax(ctx_len, T, C):
    rng = np.random.RandomState(ctx_len + T)
    B, H, Dh = 2, 4, 16
    q, kc, vc = (rng.randn(B, C, H, Dh).astype(np.float32)
                 for _ in range(3))
    kx, vx = (rng.randn(B, T, H, Dh).astype(np.float32) for _ in range(2))
    want = np.asarray(jra.chunked_prefill_attention(
        jnp.asarray(q), jnp.asarray(kx), jnp.asarray(vx), ctx_len,
        jnp.asarray(kc), jnp.asarray(vc)))
    got = chunked_prefill_attention(*(torch.from_numpy(a) for a in (
        q, kx, vx)), ctx_len, torch.from_numpy(kc), torch.from_numpy(vc))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTN_TOL)


def test_chunk_prefill_forward_matches_jax(tiny):
    """Two chunks of one prompt through both packages' chunk forward on
    identical pools: the last logits, the first token and every page
    the chunks wrote."""
    cfg, jparams, tparams = tiny
    scfg = jdm.ServingModelConfig.from_gpt_config(cfg)
    tcfg = ServingModelConfig.from_gpt_config(cfg)
    L, BS, NB = cfg.num_hidden_layers, 8, 16
    H = cfg.num_attention_heads
    Dh = cfg.hidden_size // H
    prompt = np.random.RandomState(7).randint(0, cfg.vocab_size, 27)
    jpool = jnp.zeros((L, 2, NB, BS, H, Dh), jnp.float32)
    tpool = torch.zeros((L, 2, NB, BS, H, Dh))
    table = np.array([[3, 9, 4, 11]], dtype=np.int32)
    ctx = 0
    for chunk, blocks in ((16, [3, 9]), (11, [4, 11])):
        ids = np.zeros((1, 16), dtype=np.int32)
        ids[0, :chunk] = prompt[ctx:ctx + chunk]
        nb_ctx = max(1, ctx // BS)
        jpool, jtok, jlog = jdm.chunk_prefill_forward(
            jparams, scfg, jpool, jnp.asarray(table[:, :nb_ctx]),
            np.int32(ctx), jnp.asarray(ids), np.int32(chunk),
            jnp.asarray(blocks, jnp.int32), np.float32(0.0), np.int32(0),
            np.float32(1.0), np.uint32(0))
        ttok, tlog = chunk_prefill_forward(
            tparams, tcfg, tpool, torch.from_numpy(table[:, :nb_ctx]), ctx,
            torch.from_numpy(ids), chunk, torch.tensor(blocks), 0.0, 0, 1.0,
            0)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=0, atol=LOGIT_TOL)
        assert int(ttok) == int(jtok)
        ctx += chunk
    got = tpool.numpy()[:, :, [3, 9, 4, 11]].reshape(L, 2, -1, H, Dh)
    want = np.asarray(jpool)[:, :, [3, 9, 4, 11]].reshape(L, 2, -1, H, Dh)
    np.testing.assert_allclose(got[:, :, :27], want[:, :, :27], rtol=0,
                               atol=LOGIT_TOL)
    # and the whole prompt in one causal prefill gives the same logits
    ref = _ref(tparams, cfg, prompt.tolist(), 1)
    assert int(ttok) == ref[0]


def test_allocator_pins_match_jax():
    for alloc in (BlockAllocator(10), JaxAllocator(10)):
        assert alloc.reserve(6) and alloc.pinned == 0
        alloc.pin(2)
        assert not alloc.can_reserve(2) and alloc.can_reserve(1)
        alloc.unpin(2)
        assert alloc.can_reserve(3)
    with pytest.raises(ValueError):
        BlockAllocator(4).unpin(1)


# ---------------------------------------------------------------------------
# shared-prefix KV cache
# ---------------------------------------------------------------------------
def test_prefix_cache_exactness_and_hit_accounting(tiny):
    """Greedy tokens equal the dense oracle and the JAX engine with the
    cache on, for the request that hits too (its suffix runs through the
    chunk path against blocks another request computed); the hit/miss
    counts and the pool match the JAX engine's."""
    cfg, jparams, tparams = tiny
    rng = np.random.RandomState(11)
    system = rng.randint(0, cfg.vocab_size, (24,)).tolist()   # 3 blocks
    p1 = system + rng.randint(0, cfg.vocab_size, (5,)).tolist()
    p2 = system + rng.randint(0, cfg.vocab_size, (3,)).tolist()
    out = {}
    for name, eng in (("torch", _engine(tparams, cfg, prefix_cache=True)),
                      ("jax", _jax_engine(jparams, cfg,
                                          prefix_cache=True))):
        f1 = eng.submit(p1, max_tokens=10).future
        eng.run_until_idle()
        st1 = dict(eng._prefix.stats())
        f2 = eng.submit(p2, max_tokens=10).future
        eng.run_until_idle()
        kv = eng._kv.allocator.stats()
        out[name] = (f1.result(timeout=0).tokens, f2.result(timeout=0).tokens,
                     st1, dict(eng._prefix.stats()),
                     {k: kv[k] for k in ("capacity", "free", "allocated",
                                         "reserved", "pinned", "free_runs",
                                         "largest_run")},
                     eng._prefix.live_refs)
    t1, t2, st1, st2, kv, refs = out["torch"]
    assert out["torch"] == out["jax"]
    assert st1["hits"] == 0 and st1["misses"] == 3
    assert st2["hits"] == 3 and st2["cached_blocks"] == 3
    assert t1 == _ref(tparams, cfg, p1, 10)
    assert t2 == _ref(tparams, cfg, p2, 10)
    assert refs == 0 and kv["allocated"] == 3 and kv["reserved"] == 0


def test_prefix_refcount_lifecycle_under_eviction():
    """The unit contract, step for step beside the JAX PrefixCache:
    leaf-first LRU eviction frees idle entries, referenced entries are
    unevictable, and ensure_free fails only when every cached block is
    pinned by a live table."""
    got_all = []
    for Alloc, Cache in ((BlockAllocator, PrefixCache),
                         (JaxAllocator, JaxPrefixCache)):
        alloc = Alloc(10)                       # 9 usable
        pc = Cache(alloc, block_size=4)
        prompt_a = list(range(13))              # 3 shareable blocks
        got, chain = pc.match(prompt_a)
        assert got == [] and pc.misses == 3
        blocks = alloc.allocate(3)
        entries, leftover = pc.insert(prompt_a, 0, chain, blocks)
        assert len(entries) == 3 and leftover == []
        assert pc.cached_blocks == 3 and pc.live_refs == 3
        pc.release(entries)
        first = pc.evict_one()
        assert first == entries[2].block        # deepest leaf first
        got2, _ = pc.match(prompt_a)
        assert [e.block for e in got2] == [e.block for e in entries[:2]]
        alloc.allocate(alloc.num_free)          # drain the pool
        with pytest.raises(Exception) as err:
            pc.ensure_free(1)                   # everything is pinned
        assert type(err.value).__name__ == "OutOfBlocks"
        pc.release(got2)
        pc.ensure_free(2)                       # now evictable (LRU)
        got_all.append((pc.stats(), alloc.num_free, first, chain))
    assert got_all[0] == got_all[1]
    assert got_all[0][0]["evictions"] == 3 and got_all[0][1] == 2
    assert issubclass(OutOfBlocks, RuntimeError)


def test_prefix_cache_eviction_pressure_end_to_end(tiny):
    """A small pool serving many distinct prompts keeps admitting
    because idle cached prefixes are evicted to honour reservations."""
    cfg, jparams, tparams = tiny
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, cfg.vocab_size, (17,)).tolist()
               for _ in range(6)]                          # 2 shareable
    res = {}
    for name, eng in (("torch", _engine(tparams, cfg, num_blocks=12,
                                        prefix_cache=True)),
                      ("jax", _jax_engine(jparams, cfg, num_blocks=12,
                                          prefix_cache=True))):
        futs = []
        for p in prompts:
            futs.append(eng.submit(p, max_tokens=6).future)
            eng.run_until_idle()
        st = eng._kv.allocator.stats()
        assert st["allocated"] == eng._prefix.cached_blocks
        assert st["reserved"] == 0 and eng._prefix.live_refs == 0
        res[name] = ([f.result(timeout=0).tokens for f in futs],
                     eng._prefix.evictions)
    assert res["torch"] == res["jax"] and res["torch"][1] > 0


def test_reservation_discount_pins_and_stays_exact(tiny):
    cfg, jparams, tparams = tiny
    with pytest.raises(ValueError):
        _engine(tparams, cfg, prefix_reserve_discount=True)
    rng = np.random.RandomState(5)
    system = rng.randint(0, cfg.vocab_size, (16,)).tolist()
    prompts = [system + rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (3, 6, 2)]
    res = {}
    for name, eng in (("torch", _engine(tparams, cfg, prefix_cache=True,
                                        prefix_reserve_discount=True)),
                      ("jax", _jax_engine(jparams, cfg, prefix_cache=True,
                                          prefix_reserve_discount=True))):
        f0 = eng.submit(prompts[0], max_tokens=5).future
        eng.run_until_idle()
        futs = [eng.submit(p, max_tokens=5).future for p in prompts[1:]]
        eng.step()
        pinned = eng._kv.allocator.pinned        # live refs pin blocks
        eng.run_until_idle()
        res[name] = ([f.result(timeout=0).tokens for f in [f0] + futs],
                     pinned, eng._kv.allocator.pinned,
                     eng._kv.allocator.reserved, eng._prefix.stats())
    assert res["torch"] == res["jax"]
    assert res["torch"][1] == 2 and res["torch"][2] == 0
    for p, toks in zip(prompts, res["torch"][0]):
        assert toks == _ref(tparams, cfg, p, 5)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------
def test_chunked_prefill_token_exactness(tiny):
    """A prompt admitted in chunks decodes token-identically to the
    dense oracle and to the JAX engine's chunked prefill; one chunk per
    engine step, and a prompt beyond the largest bucket is admitted."""
    cfg, jparams, tparams = tiny
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).tolist()
               for n in (61, 35)]              # 4 and 3 chunks
    eng = _engine(tparams, cfg, prefill_chunk=16)
    futs = [eng.submit(p, max_tokens=8).future for p in prompts]
    eng.run_until_idle()
    jeng = _jax_engine(jparams, cfg, prefill_chunk=16)
    jfuts = [jeng.submit(p, max_tokens=8).future for p in prompts]
    jeng.run_until_idle()
    for p, f, jf in zip(prompts, futs, jfuts):
        toks = f.result(timeout=0).tokens
        assert toks == _ref(tparams, cfg, p, 8)
        assert toks == jf.result(timeout=0).tokens
    assert eng.stats()["prefill_chunks"] == 4 + 3
    assert eng.stats()["prefill_chunk"] == 16
    # prompts past the largest bucket: refused unchunked, admitted chunked
    small = _engine(tparams, cfg, prefill_buckets=[8, 16, 32])
    with pytest.raises(ValueError):
        small.submit(prompts[0], max_tokens=2)
    chunked = _engine(tparams, cfg, prefill_buckets=[8, 16, 32],
                      prefill_chunk=16)
    f = chunked.submit(prompts[0], max_tokens=3).future
    chunked.run_until_idle()
    assert f.result(timeout=0).tokens == _ref(tparams, cfg, prompts[0], 3)


def test_chunked_prefill_interleaves_with_decode(tiny):
    """While a long prompt chunk-prefills, the running decode batch
    keeps emitting a token per engine step between chunks."""
    cfg, jparams, tparams = tiny
    eng = _engine(tparams, cfg, prefill_chunk=16)
    rng = np.random.RandomState(19)
    pa = rng.randint(0, cfg.vocab_size, (4,)).tolist()
    pb = rng.randint(0, cfg.vocab_size, (61,)).tolist()
    a = eng.submit(pa, max_tokens=40)
    eng.step()                                  # a admitted + decoding
    assert len(a.lazy_tokens) >= 1
    b = eng.submit(pb, max_tokens=4)            # 4 chunks of 16
    toks_before = len(a.lazy_tokens)
    for _ in range(3):
        eng.step()                              # chunk + decode each
    assert len(b.lazy_tokens) == 0 and b.prefilling
    assert len(a.lazy_tokens) == toks_before + 3
    eng.run_until_idle()
    assert a.future.result(timeout=0).tokens == _ref(tparams, cfg, pa, 40)
    assert b.future.result(timeout=0).tokens == _ref(tparams, cfg, pb, 4)
    st = eng._kv.allocator.stats()
    assert st["allocated"] == 0 and st["reserved"] == 0


def test_chunked_prefill_with_prefix_and_sampling_composes(tiny):
    """A sampled request whose prompt partly hits the prefix cache and
    chunk-prefills its suffix reproduces the sampled sequential oracle,
    and greedy requests through the same path equal the JAX engine."""
    cfg, jparams, tparams = tiny
    rng = np.random.RandomState(23)
    system = rng.randint(0, cfg.vocab_size, (32,)).tolist()
    p1 = system + rng.randint(0, cfg.vocab_size, (7,)).tolist()
    p2 = system + rng.randint(0, cfg.vocab_size, (21,)).tolist()
    eng = _engine(tparams, cfg, prefill_chunk=16, prefix_cache=True)
    f1 = eng.submit(p1, max_tokens=6, temperature=0.9, top_k=8,
                    seed=42).future
    eng.run_until_idle()
    f2 = eng.submit(p2, max_tokens=6, temperature=0.9, top_k=8,
                    seed=43).future
    eng.run_until_idle()
    assert eng._prefix.stats()["hits"] >= 4     # p2 reused the system
    for p, f, seed in ((p1, f1, 42), (p2, f2, 43)):
        assert f.result(timeout=0).tokens == _ref(
            tparams, cfg, p, 6, temperature=0.9, top_k=8, seed=seed)
    greedy = {}
    for name, e in (("torch", _engine(tparams, cfg, prefill_chunk=16,
                                      prefix_cache=True)),
                    ("jax", _jax_engine(jparams, cfg, prefill_chunk=16,
                                        prefix_cache=True))):
        fs = [e.submit(p, max_tokens=6).future for p in (p1, p2)]
        e.run_until_idle()
        fs.append(e.submit(p2, max_tokens=4).future)
        e.run_until_idle()
        greedy[name] = ([f.result(timeout=0).tokens for f in fs],
                        e._prefix.stats())
    assert greedy["torch"] == greedy["jax"]


def test_long_context_knobs_and_validation(tiny, monkeypatch):
    cfg, jparams, tparams = tiny
    with pytest.raises(ValueError):
        _engine(tparams, cfg, prefill_chunk=12)     # not a block multiple
    assert _engine(tparams, cfg, prefill_chunk=0).prefill_chunk is None
    assert _engine(tparams, cfg, prefill_chunk=4096).prefill_chunk == \
        _engine(tparams, cfg)._buckets[-1]
    monkeypatch.setenv("PADDLE_TORCH_PREFILL_CHUNK", "16")
    monkeypatch.setenv("PADDLE_TORCH_PREFIX_CACHE", "1")
    eng = _engine(tparams, cfg)
    assert eng.prefill_chunk == 16 and eng._prefix is not None
    assert _engine(tparams, cfg, prefill_chunk=8,
                   prefix_cache=False).prefill_chunk == 8
    monkeypatch.setenv("PADDLE_TORCH_PREFIX_CACHE", "0")
    monkeypatch.setenv("PADDLE_TORCH_PREFILL_CHUNK", " ")
    eng = _engine(tparams, cfg)
    assert eng.prefill_chunk is None and eng._prefix is None
    assert eng.stats().get("prefix_cache") is None
    assert SCRATCH_BLOCK == 0
