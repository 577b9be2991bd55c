"""Captured prefill, the auto-tuned poll cadence, ``Model.prepare_serving``
and the rest of ``tests/test_serving.py`` for the port, against the JAX
package.

The same ``gpt_tiny`` weights go through both packages on the CPU, from
the same numpy inputs.  On the CPU the engine runs each prefill
program's body eagerly on the program's static buffers, so these tests
hold everything but the capture: the device-tensor forms of
``prefill_group_forward`` and ``chunk_prefill_forward`` (a context table
padded to its extent bucket included) against the JAX functions
(logits and pages within 1e-5, tokens equal), the shape keys an engine
runs (``prefill_programs``, ``chunk_programs``) equal to the JAX
engine's trace counts (``prefill_traces``, ``chunk_traces``) for the
same traffic, greedy tokens equal to the JAX engine's with chunk and
context buckets and prefix hits, the keys ``warmup`` reaches, the
auto-tuned poll cadence, and ``Model.prepare_serving``.  Sampled tokens
compare only within the port (the JAX package's noise is threefry).
The ``cuda``-marked tests hold one capture per key, a replay equal to
the eager body bit for bit, and no capture after warm-up, on the card.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny
from paddle_tpu.inference.serving import BlockAllocator as JaxAllocator
from paddle_tpu.inference.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import decode_model as jdm

from paddle_tpu_torch.framework import env_knobs
from paddle_tpu_torch.inference.serving import (
    SCRATCH_BLOCK, BlockAllocator, DecodeEngine, LLMServer,
    ServingModelConfig, chunk_prefill_forward, params_from_numpy,
    prefill_forward, prefill_group_forward, reference_decode)
from paddle_tpu_torch.models import GPTForCausalLM, state_dict_from_jax
from paddle_tpu_torch.models import gpt_tiny as torch_gpt_tiny
from torch_parity_helpers import torch_one_thread  # noqa: F401

LOGIT_TOL = 1e-5          # 2-layer fp32 forward, two libraries' sum orders


@pytest.fixture(scope="module")
def tiny():
    """The JAX ``gpt_tiny`` network (seed 0), its decode params, the
    port's weights carried across as numpy, and the serving config."""
    paddle.seed(0)
    cfg = gpt_tiny(use_flash_attention=False)
    net = JaxGPT(cfg)
    net.eval()
    jparams = jdm.extract_decode_params(net)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, dtype=np.float32), jparams)
    return dict(net=net, cfg=cfg, jparams=jparams, tree=tree,
                tparams=params_from_numpy(tree, device="cpu"),
                scfg=ServingModelConfig.from_gpt_config(cfg))


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lens]


def _engine(t, **kw):
    base = dict(params=t["tparams"], gpt_config=t["cfg"], max_batch=2,
                block_size=8, num_blocks=64, device="cpu")
    base.update(kw)
    return DecodeEngine(**base)


def _jax_engine(t, **kw):
    base = dict(params=t["jparams"], gpt_config=t["cfg"], max_batch=2,
                block_size=8, num_blocks=64, attention="gather")
    base.update(kw)
    return JaxDecodeEngine(**base)


def _ref(t, prompt, n, **kw):
    toks, _ = reference_decode(t["tparams"], t["scfg"], prompt, n, **kw)
    return toks.tolist()


def _drained(eng):
    st = eng._kv.allocator.stats()
    return st["allocated"] == 0 and st["reserved"] == 0


def _run_both(t, waves, **kw):
    """The same traffic through the port's and the JAX engine: each
    wave's prompts submitted together, then run to idle.  Returns both
    engines and both token lists."""
    teng, jeng = _engine(t, **kw), _jax_engine(t, **kw)
    tt, jt = [], []
    for wave in waves:
        tf = [teng.submit(p, max_tokens=m).future for p, m in wave]
        jf = [jeng.submit(p, max_tokens=m).future for p, m in wave]
        teng.run_until_idle()
        jeng.run_until_idle()
        tt += [f.result(timeout=0).tokens for f in tf]
        jt += [f.result(timeout=0).tokens for f in jf]
    return teng, jeng, tt, jt


# ---------------------------------------------------------------------------
# the prefill bodies on device tensors
# ---------------------------------------------------------------------------
def test_device_tensor_prefill_group_forward_matches_jax(tiny):
    """Every input a tensor (the captured body's form), the seeds as
    int32 bits of uint32 values: logits, K/V and greedy tokens against
    the JAX function; a sampled row equals the host-argument form's."""
    t = tiny
    G, Lb = 4, 16
    lens = np.array([11, 5, 16, 0], np.int32)         # a padded row last
    ids = np.zeros((G, Lb), np.int32)
    for g, n in enumerate(lens):
        ids[g, :n] = _prompts(g, [n])[0]
    temps = np.zeros(G, np.float32)
    topks = np.zeros(G, np.int32)
    topps = np.ones(G, np.float32)
    seeds = np.array([0, 2 ** 32 - 5, 7, 0], np.uint32)
    jkvs, jtok, jlog = jdm.prefill_group_forward(
        t["jparams"], t["scfg"], *(jnp.asarray(a) for a in (
            ids, lens, temps, topks, topps, seeds)))
    tkvs, ttok, tlog = prefill_group_forward(
        t["tparams"], t["scfg"], torch.from_numpy(ids),
        torch.from_numpy(lens), torch.from_numpy(temps),
        torch.from_numpy(topks), torch.from_numpy(topps),
        torch.from_numpy(seeds.view(np.int32)))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(tkvs.numpy(), np.asarray(jkvs), rtol=0,
                               atol=LOGIT_TOL)
    assert ttok.dtype == torch.int32
    assert ttok[:3].tolist() == np.asarray(jtok)[:3].tolist()
    # a sampled row: the device form and the host form draw the same
    temps[1], topks[1], topps[1] = 0.8, 20, 0.9
    dev = prefill_group_forward(
        t["tparams"], t["scfg"], torch.from_numpy(ids),
        torch.from_numpy(lens), torch.from_numpy(temps),
        torch.from_numpy(topks), torch.from_numpy(topps),
        torch.from_numpy(seeds.view(np.int32)))[1]
    host = prefill_group_forward(t["tparams"], t["scfg"],
                                 torch.from_numpy(ids), lens.tolist(),
                                 temps.tolist(), topks.tolist(),
                                 topps.tolist(), seeds.tolist())[1]
    assert dev.tolist() == host.tolist()


@pytest.mark.parametrize("nb_ctx", [3, 4, 8])
def test_device_tensor_chunk_forward_at_a_padded_context_bucket(tiny,
                                                                nb_ctx):
    """The second chunk of a prompt with its context table padded past
    the context (3 real blocks; 4 and 8 are its extent buckets, whose
    extra columns name the chunk's own pages and scratch) and every
    scalar a ``[1]`` tensor: logits, token and pages against the JAX
    function given the same padded table, and equal to the unpadded
    table's."""
    t = tiny
    cfg, scfg = t["cfg"], t["scfg"]
    L, BS, NB = cfg.num_hidden_layers, 8, 16
    H = cfg.num_attention_heads
    Dh = cfg.hidden_size // H
    prompt = np.random.RandomState(8).randint(0, cfg.vocab_size, 37)
    table = np.full((1, 8), SCRATCH_BLOCK, np.int32)
    table[0, :5] = [3, 9, 4, 11, 6]
    jpool = jnp.zeros((L, 2, NB, BS, H, Dh), jnp.float32)
    tpool = torch.zeros((L, 2, NB, BS, H, Dh))
    base = None
    for ctx, chunk, blocks in ((0, 24, [3, 9, 4]), (24, 13, [11, 6])):
        ids = np.zeros((1, 16 if ctx else 24), np.int32)
        ids[0, :chunk] = prompt[ctx:ctx + chunk]
        cb = np.full(ids.shape[1] // BS, SCRATCH_BLOCK, np.int32)
        cb[:len(blocks)] = blocks
        nbc = nb_ctx if ctx else 1
        jpool, jtok, jlog = jdm.chunk_prefill_forward(
            t["jparams"], scfg, jpool, jnp.asarray(table[:, :nbc]),
            np.int32(ctx), jnp.asarray(ids), np.int32(chunk),
            jnp.asarray(cb), np.float32(0.0), np.int32(0),
            np.float32(1.0), np.uint32(0))
        ttok, tlog = chunk_prefill_forward(
            t["tparams"], scfg, tpool, torch.from_numpy(table[:, :nbc]),
            torch.tensor([ctx], dtype=torch.int32), torch.from_numpy(ids),
            torch.tensor([chunk], dtype=torch.int32), torch.from_numpy(cb),
            torch.zeros(1), torch.zeros(1, dtype=torch.int32),
            torch.ones(1), torch.zeros(1, dtype=torch.int32))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=LOGIT_TOL)
        assert int(ttok) == int(jtok)
        if ctx:
            # the host-argument form on the unpadded table: same token
            pool2 = tpool.clone()
            tok2, lg2 = chunk_prefill_forward(
                t["tparams"], scfg, pool2, torch.from_numpy(table[:, :3]),
                ctx, torch.from_numpy(ids), chunk, torch.from_numpy(cb),
                0.0, 0, 1.0, 0)
            assert int(tok2) == int(ttok)
            np.testing.assert_allclose(lg2.numpy(), tlog.numpy(), rtol=0,
                                       atol=LOGIT_TOL)
            base = int(ttok)
    got = tpool.numpy()[:, :, [3, 9, 4, 11, 6]].reshape(L, 2, -1, H, Dh)
    want = np.asarray(jpool)[:, :, [3, 9, 4, 11, 6]].reshape(L, 2, -1, H,
                                                             Dh)
    np.testing.assert_allclose(got[:, :, :37], want[:, :, :37], rtol=0,
                               atol=LOGIT_TOL)
    assert base == _ref(t, prompt.tolist(), 1)[0]


@pytest.mark.parametrize("L,bucket", [(11, 16), (11, 32), (16, 64)])
def test_prefill_bucket_padding_is_harmless(tiny, L, bucket):
    """``tests/test_serving.py::test_prefill_bucket_padding_is_harmless``
    for the port: a prompt prefilled at a larger bucket gives the exact
    length's first token and logits (1e-5), and the JAX package's."""
    t = tiny
    prompt = np.random.RandomState(3).randint(0, t["cfg"].vocab_size, (L,))
    exact = np.zeros((1, L), np.int32)
    exact[0] = prompt
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :L] = prompt
    _, tok_e, lg_e = prefill_forward(t["tparams"], t["scfg"],
                                     torch.from_numpy(exact), L)
    _, tok_p, lg_p = prefill_forward(t["tparams"], t["scfg"],
                                     torch.from_numpy(padded), L)
    _, jtok, jlg = jdm.prefill_forward(t["jparams"], t["scfg"],
                                       jnp.asarray(padded), jnp.int32(L))
    assert int(tok_e) == int(tok_p) == int(jtok)
    np.testing.assert_allclose(lg_p.numpy(), lg_e.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lg_p.numpy(), np.asarray(jlg), rtol=0,
                               atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# shape keys against the JAX engine's traces
# ---------------------------------------------------------------------------
def test_engine_buckets_equal_the_jax_engines():
    paddle.seed(0)
    for kw in (dict(), dict(prefill_chunk=32), dict(max_blocks_per_seq=11),
               dict(prefill_chunk=24, block_size=8)):
        cfg = gpt_tiny(use_flash_attention=False)
        j = JaxDecodeEngine(JaxGPT(cfg), num_blocks=32, **kw)
        tree = jax.tree_util.tree_map(
            lambda a: np.asarray(a, dtype=np.float32), j._params)
        p = DecodeEngine(params=params_from_numpy(tree, device="cpu"),
                         gpt_config=cfg, num_blocks=32, device="cpu", **kw)
        assert p._buckets == j._buckets
        assert p._chunk_buckets == j._chunk_buckets
        assert p._ctx_buckets == j._ctx_buckets
        assert p._group_buckets == j._group_buckets


def test_grouped_programs_equal_jax_prefill_traces(tiny):
    """Grouped traffic: same-bucket groups of 1–4 at several buckets, in
    three waves; tokens equal, and the port's (group, bucket) keys seen
    equal the JAX engine's prefill traces after each wave."""
    waves = [list(zip(_prompts(1, (3, 5, 12, 30)), (4, 6, 3, 5))),
             list(zip(_prompts(2, (6, 7, 9, 2)), (3, 3, 5, 2))),
             list(zip(_prompts(3, (60, 17)), (4, 4)))]
    teng, jeng = _engine(tiny, max_batch=4, num_blocks=96), \
        _jax_engine(tiny, max_batch=4, num_blocks=96)
    for wave in waves:
        tf = [teng.submit(p, max_tokens=m).future for p, m in wave]
        jf = [jeng.submit(p, max_tokens=m).future for p, m in wave]
        teng.run_until_idle()
        jeng.run_until_idle()
        assert [f.result(timeout=0).tokens for f in tf] == \
            [f.result(timeout=0).tokens for f in jf]
        tc, jc = teng.compile_stats(), jeng.compile_stats()
        assert tc["prefill_programs"] == jc["prefill_traces"]
        assert tc["chunk_programs"] == jc["chunk_traces"] == 0
    assert set(teng._prefill_progs) >= {(2, 8), (1, 16), (1, 32), (4, 8),
                                        (1, 64)}
    assert tc["prefill_captures"] == tc["chunk_captures"] == 0
    assert _drained(teng)


def test_chunk_and_prefix_programs_equal_jax_chunk_traces(tiny):
    """Long prompts chunked (chunk bucket 16 and residues), repeats that
    hit the prefix cache (a residue at a deep context), a shared system
    prefix and a prefix hit with chunking off: greedy tokens equal the
    JAX engine's and ``reference_decode``'s, the key counts equal the
    JAX trace counts, and the pool drains."""
    system = _prompts(4, (24,))[0]
    own = _prompts(5, (5, 9, 3))
    long_a, long_b = _prompts(6, (45, 61))
    waves = [[(long_a, 4)], [(long_a, 5)], [(long_b, 3), (system + own[0], 4)],
             [(system + own[1], 3), (system + own[2], 6)], [(long_b, 2)]]
    for kw in (dict(prefill_chunk=16, prefix_cache=True),
               dict(prefix_cache=True)):
        teng, jeng, tt, jt = _run_both(tiny, waves, num_blocks=96, **kw)
        assert tt == jt
        for (p, m), got in zip([x for w in waves for x in w], tt):
            assert got == _ref(tiny, p, m)
        tc, jc = teng.compile_stats(), jeng.compile_stats()
        assert tc["prefill_programs"] == jc["prefill_traces"]
        assert tc["chunk_programs"] == jc["chunk_traces"] > 0
        assert teng.stats()["prefix_cache"]["hits"] == \
            jeng.stats()["prefix_cache"]["hits"] > 0
        kv = teng.stats()["kv"]             # the cache keeps its blocks
        assert kv["reserved"] == 0
        assert kv["allocated"] == teng._prefix.cached_blocks
    # the chunked run padded a context to its extent bucket: ctx 24
    # tokens = 3 blocks ran at 4
    keys = set(_engine(tiny, prefill_chunk=16)._chunk_keys(45, 0))
    assert keys == {(16, 1), (16, 2), (16, 4)}


def test_sampled_chunked_prefill_equals_the_oracle(tiny):
    """The chunk program's sampling values: a sampled long prompt and a
    sampled prefix hit equal ``reference_decode`` with the same
    settings (the chunk's token is drawn at ``ctx_len + chunk_len``)."""
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, seed=2 ** 32 - 9)
    prompt = _prompts(9, (41,))[0]
    eng = _engine(tiny, prefill_chunk=16, prefix_cache=True, num_blocks=96)
    f1 = eng.submit(prompt, max_tokens=6, **kw).future
    eng.run_until_idle()
    f2 = eng.submit(prompt, max_tokens=6, **kw).future
    eng.run_until_idle()
    want = _ref(tiny, prompt, 6, **kw)
    assert f1.result(timeout=0).tokens == want
    assert f2.result(timeout=0).tokens == want
    assert eng.stats()["prefix_cache"]["hits"] == 5


def test_join_leave_pins_decode_captures_and_programs(tiny):
    """``tests/test_serving.py::test_join_leave_across_groups_zero_recompiles``
    for the port: requests join and leave across three groups; the JAX
    engine stays at one decode trace, the port at 0 decode captures on
    the CPU, and its prefill keys equal the JAX prefill traces at every
    stage; the pool drains."""
    teng, jeng = _engine(tiny), _jax_engine(tiny)
    rng = np.random.RandomState(4)
    p = [rng.randint(0, 256, (n,)).tolist() for n in (5, 9, 12, 3)]

    def both(fn):
        return fn(teng), fn(jeng)

    def run_some(n):
        for eng in (teng, jeng):
            for _ in range(n):
                if not eng.step():
                    break

    def pins():
        tc, jc = teng.compile_stats(), jeng.compile_stats()
        assert jc["decode_traces"] == 1 and tc["decode_captures"] == 0
        assert tc["prefill_programs"] == jc["prefill_traces"]

    f1 = both(lambda e: e.submit(p[0], 4).future)
    f2 = both(lambda e: e.submit(p[1], 10).future)
    run_some(3)
    pins()
    f3 = both(lambda e: e.submit(p[2], 6).future)
    run_some(3)
    assert f1[0].done() and f1[1].done()
    pins()
    f4 = both(lambda e: e.submit(p[3], 8).future)
    for eng in (teng, jeng):
        eng.run_until_idle()
    pins()
    for tf, jf in (f1, f2, f3, f4):
        assert tf.result(timeout=0).tokens == jf.result(timeout=0).tokens
    assert teng._dispatches >= 9 and _drained(teng)


# ---------------------------------------------------------------------------
# warm-up
# ---------------------------------------------------------------------------
def test_warmup_reaches_every_key_of_its_lengths(tiny):
    """``warmup(lengths)``: each grouped length's bucket at every group
    bucket, each longer one's chunk keys, each repeat's prefix-hit keys;
    traffic of those lengths afterwards adds no key (on the card: no
    capture)."""
    eng = _engine(tiny, prefill_chunk=16, prefix_cache=True, num_blocks=96)
    w = eng.warmup([5, 20, 45])
    assert w["buckets"] == [8, 32, 64]
    assert w["prefill_keys"] == [(1, 8), (2, 8)]
    # 20: chunks 16 + 4; 45: 16 + 16 + 13; repeats: 20 from 16 tokens,
    # 45 from 40
    assert w["chunk_keys"] == [(8, 2), (8, 8), (16, 1), (16, 2), (16, 4)]
    assert (w["prefill_programs"], w["chunk_programs"]) == (2, 5)
    assert w["prefill_captures"] == w["chunk_captures"] == 0
    assert eng._kv.allocator.stats()["allocated"] == 0
    before = eng.compile_stats()
    prompts = _prompts(10, (5, 3, 20, 45))
    futs = [eng.submit(q, max_tokens=3).future for q in prompts]
    eng.run_until_idle()
    futs += [eng.submit(q, max_tokens=3).future for q in prompts[2:]]
    eng.run_until_idle()
    assert eng.compile_stats() == before
    for q, f in zip(prompts + prompts[2:], futs):
        assert f.result(timeout=0).tokens == _ref(tiny, q, 3)


def test_warmup_keeps_its_roles(tiny):
    """A decode-role engine warms no prefill program; a prefill-role
    engine warms its programs and runs no decode step; warm-up writes
    nothing outside the scratch block."""
    dec = _engine(tiny, role="decode")
    w = dec.warmup([5, 20])
    assert w["buckets"] == [] and w["prefill_programs"] == 0
    pre = _engine(tiny, role="prefill", prefill_chunk=16)
    pool0 = pre._kv.pool.clone()
    w = pre.warmup([5, 20])
    assert w["prefill_keys"] == [(1, 8), (2, 8)]
    assert w["chunk_keys"] == [(8, 2), (16, 1)]
    assert pre.stats()["dispatches"] == 0
    changed = (pre._kv.pool != pool0).flatten(3).any(-1).any(0).any(0)
    assert changed.nonzero().flatten().tolist() in ([], [SCRATCH_BLOCK])


def test_prefill_programs_keep_their_buffers(tiny):
    """A program's static buffers keep their addresses across runs (a
    graph holds them), and each run's tokens are a fresh tensor, so a
    later run of the key leaves an earlier run's tokens alone."""
    eng = _engine(tiny)
    eng.submit(_prompts(11, (5,))[0], max_tokens=1)
    eng.run_until_idle()
    prog = eng._prefill_progs[(1, 8)]
    ptrs = (prog.inputs.data_ptr(), prog.out.data_ptr())
    host, image = eng._host_image(prog)
    views = prog.views(image)
    views[0][0, :3] = [1, 2, 3]
    views[1][0] = 3
    a = prog.run(host, lambda: eng._group_body(prog))
    views[0][0, :3] = [4, 5, 6]
    b = prog.run(host, lambda: eng._group_body(prog))
    assert (prog.inputs.data_ptr(), prog.out.data_ptr()) == ptrs
    assert a.data_ptr() != b.data_ptr() != prog.out.data_ptr()
    assert int(a[0]) == _ref(tiny, [1, 2, 3], 1)[0]
    assert int(b[0]) == _ref(tiny, [4, 5, 6], 1)[0]


def test_import_waits_for_its_gather_while_decoding(tiny, monkeypatch):
    """A decode-role engine that is decoding leaves a ticket whose
    gather has not run (its event not complete) at the head of the
    inbox and keeps dispatching; once the event completes, the next step
    imports it; tokens equal the sequential oracle's."""
    pre = _engine(tiny, role="prefill")
    dec = _engine(tiny, role="decode")
    a, b = _prompts(13, (5, 9))
    ra = pre.submit(a, 12)
    pre.step()
    dec.submit_migration(pre.pop_ready_migrations()[0])
    dec.step()
    assert dec.active_count == 1
    rb = pre.submit(b, 6)
    pre.step()
    mig = pre.pop_ready_migrations()[0]

    class Pending:                 # stands in for the gather's CUDA event
        done = False

        def query(self):
            return self.done

    mig.ready = ev = Pending()
    waits = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type(
                            "S", (), {"wait_event": staticmethod(
                                waits.append)})())
    dec.submit_migration(mig)
    d0 = dec.stats()["dispatches"]
    for _ in range(3):
        dec.step()
    assert dec.pending_migrations == 1 and dec.active_count == 1
    assert dec.stats()["dispatches"] == d0 + 3 and not waits
    ev.done = True
    dec.step()
    assert dec.pending_migrations == 0 and dec.active_count == 2
    assert waits == [ev]
    dec.run_until_idle()
    assert ra.future.result(timeout=0).tokens == _ref(tiny, a, 12)
    assert rb.future.result(timeout=0).tokens == _ref(tiny, b, 6)


# ---------------------------------------------------------------------------
# the poll cadence
# ---------------------------------------------------------------------------
def test_done_poll_interval_auto_tunes(tiny):
    """``tests/test_serving.py::test_done_poll_interval_auto_tunes`` for
    the port: the default calibrates over the first polls and freezes a
    bounded decision, recorded under the JAX engine's keys; tokens equal
    the JAX engine's (auto too)."""
    eng = _engine(tiny, eos_id=999_999)          # never emitted
    jeng = _jax_engine(tiny, eos_id=999_999)
    assert eng._poll_auto and eng.done_poll_interval == 8
    prompts = ([1, 2, 3], [4, 5, 6])
    tf = [eng.submit(p, max_tokens=64).future for p in prompts]
    jf = [jeng.submit(p, max_tokens=64).future for p in prompts]
    eng.run_until_idle()
    jeng.run_until_idle()
    d = eng._poll_decision
    assert d is not None
    assert 1 <= d["done_poll_interval"] <= eng._poll_tuner.max_fold == 64
    assert eng.done_poll_interval == d["done_poll_interval"]
    assert eng.stats()["done_poll_decision"] == d
    assert set(d) == set(jeng._poll_decision)
    assert d["target"] == 0.05 and d["max"] == 64
    assert [f.result(timeout=0).tokens for f in tf] == \
        [f.result(timeout=0).tokens for f in jf]


def test_done_poll_interval_explicit_stays_fixed(tiny):
    """``tests/test_serving.py::test_done_poll_interval_explicit_stays_fixed``
    for the port."""
    eng = _engine(tiny, max_batch=1, eos_id=999_999, done_poll_interval=2)
    assert not eng._poll_auto and eng._poll_tuner is None
    eng.submit([1, 2, 3], max_tokens=48)
    eng.run_until_idle()
    assert eng.done_poll_interval == 2
    assert eng._poll_decision is None
    assert "done_poll_decision" not in eng.stats()


def test_poll_knobs_bound_the_decision(tiny, monkeypatch):
    """``PADDLE_TORCH_SERVING_POLL_MAX`` / ``_CALIB`` / ``_TARGET``: a
    tuner calibrated over one poll decides after the second, within the
    bound; an EOS the stream emits truncates it as at a fixed interval."""
    monkeypatch.setenv("PADDLE_TORCH_SERVING_POLL_MAX", "2")
    monkeypatch.setenv("PADDLE_TORCH_SERVING_POLL_CALIB", "1")
    monkeypatch.setenv("PADDLE_TORCH_SERVING_POLL_TARGET", "1e-9")
    assert env_knobs.get_int("PADDLE_TORCH_SERVING_POLL_MAX", 64) == 2
    prompt = _prompts(17, (7,))[0]
    full = _ref(tiny, prompt, 40)
    # an EOS first emitted past the first poll (at dispatch 8): the second
    # poll, which finds it, is the one the tuner decides on
    eos = next(tok for j, tok in enumerate(full)
               if j > 8 and tok not in full[:j])
    eng = _engine(tiny, max_batch=1, eos_id=eos)
    f = eng.submit(prompt, max_tokens=40).future
    eng.run_until_idle()
    d = eng._poll_decision
    assert d is not None and d["done_poll_interval"] == 2 == d["max"]
    fixed = _engine(tiny, max_batch=1, eos_id=eos, done_poll_interval=8)
    g = fixed.submit(prompt, max_tokens=40).future
    fixed.run_until_idle()
    want = full[:full.index(eos) + 1]
    assert f.result(timeout=0).tokens == g.result(timeout=0).tokens == want


# ---------------------------------------------------------------------------
# Model.prepare_serving
# ---------------------------------------------------------------------------
def test_prepare_serving_export(tiny):
    """``tests/test_serving.py::test_hapi_prepare_serving_export`` for
    the port: ``Model.prepare_serving`` hands the network to a warmed,
    started ``LLMServer``; its tokens equal the JAX ``prepare_serving``
    server's on the same weights, and the served weights are a copy."""
    import paddle_tpu_torch as ptt
    t = tiny
    net = GPTForCausalLM(torch_gpt_tiny(), device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in t["net"].state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, torch_gpt_tiny()))
    net.eval()
    srv = ptt.Model(net, device="cpu").prepare_serving(
        prompt_lengths=[8], max_batch=2, block_size=8, num_blocks=64,
        start=True)
    jsrv = paddle.Model(t["net"]).prepare_serving(
        prompt_lengths=[8], max_batch=2, block_size=8, num_blocks=64,
        start=True)
    try:
        assert srv.running and srv.engine.device.type == "cpu"
        res = srv.submit([5, 6, 7, 8], 4).result(timeout=120)
        jres = jsrv.submit([5, 6, 7, 8], 4).result(timeout=120)
        assert len(res.tokens) == 4 and res.tokens == jres.tokens
        assert srv.stats()["warmup"]["buckets"] == [8]
        assert srv.stats()["warmup"]["prefill_keys"] == [(1, 8), (2, 8)]
        served = {p.data_ptr() for p in srv.engine._params.parameters()}
        assert not served & {p.data_ptr() for p in net.parameters()}
    finally:
        srv.close()
        jsrv.close()
    cold = ptt.Model(net, device="cpu").prepare_serving(
        warmup=False, start=False, max_batch=1, num_blocks=16)
    assert not cold.running and "warmup" not in cold.stats()
    cold.close()


# ---------------------------------------------------------------------------
# the rest of tests/test_serving.py
# ---------------------------------------------------------------------------
def test_allocator_contiguous_best_fit_and_fragmentation():
    """``tests/test_serving.py:60`` for the port, step for step beside
    the JAX allocator."""
    allocs = (BlockAllocator(17), JaxAllocator(17))
    for a in allocs:
        a.free(a.allocate(16))
        assert a.stats()["fragmentation"] == 0.0
    blocks = [a.allocate(16) for a in allocs]
    assert blocks[0] == blocks[1]
    for a in allocs:
        a.free(blocks[0][2:5])
        a.free(blocks[0][8:14])
    st = [a.stats() for a in allocs]
    assert st[0] == st[1]
    assert st[0]["free_runs"] == 2 and st[0]["largest_run"] == 6
    assert 0.0 < st[0]["fragmentation"] < 1.0
    got = [a.allocate(3) for a in allocs]
    assert sorted(got[0]) == sorted(got[1]) == sorted(blocks[0][2:5])
    for a in allocs:
        assert a.stats()["largest_run"] == 6
        a.free(blocks[0][0:1])
    got7 = [a.allocate(7) for a in allocs]
    assert got7[0] == got7[1] and len(set(got7[0])) == 7


def test_page_table_grows_lazily_across_blocks(tiny):
    """``tests/test_serving.py:247`` for the port."""
    eng = _engine(tiny, max_batch=1, num_blocks=32)
    req = eng.submit(list(range(1, 7)), max_tokens=20)
    eng.step()                      # admit + prefill: 6 tokens, 1 block
    assert len(req.blocks) == 1
    assert eng._tables[0, 0] == req.blocks[0]
    assert eng._tables[0, 1] == SCRATCH_BLOCK
    eng.step()
    eng.step()                      # 8 tokens in cache: block 2 now
    assert len(req.blocks) == 2 and eng._tables[0, 1] == req.blocks[1]
    eng.run_until_idle()
    assert req.future.result(timeout=0).stats.generated == 20
    assert eng._kv.allocator.stats()["allocated"] == 0


def test_streaming_callbacks_ordered_and_match_result(tiny):
    """``tests/test_serving.py:262`` for the port: per-request callbacks
    in order, their lazy values equal to the result, which equals the
    JAX engine's."""
    eng, jeng = _engine(tiny), _jax_engine(tiny)
    events = {}
    lock = threading.Lock()

    def cb(rid, idx, lazy_tok):
        with lock:
            events.setdefault(rid, []).append((idx, lazy_tok))

    prompts = _prompts(5, (4, 10))
    reqs = [eng.submit(p, 7, stream_cb=cb) for p in prompts]
    jf = [jeng.submit(p, 7).future for p in prompts]
    eng.run_until_idle()
    jeng.run_until_idle()
    for req, f in zip(reqs, jf):
        got = req.future.result(timeout=0).tokens
        ev = events[req.id]
        assert [i for i, _ in ev] == list(range(7))
        assert [int(v) for _, v in ev] == got == f.result(timeout=0).tokens


def test_admission_waits_for_block_budget(tiny):
    """``tests/test_serving.py:306`` for the port: a request the pool
    cannot cover worst-case now stays queued until a reservation frees."""
    eng = _engine(tiny, num_blocks=10)       # 9 usable blocks of 8
    big = [eng.submit(list(range(1, 17)), max_tokens=17) for _ in range(3)]
    eng.step()
    assert eng.active_count == 2 and eng.scheduler.queue_depth == 1
    eng.run_until_idle()
    assert all(r.future.done() for r in big)
    assert len({tuple(r.future.result(timeout=0).tokens) for r in big}) == 1
    assert _drained(eng)


def test_server_close_fails_pending_futures(tiny):
    """``tests/test_serving.py:398`` for the port."""
    srv = LLMServer(params=tiny["tparams"], gpt_config=tiny["cfg"],
                    max_batch=1, block_size=8, num_blocks=64, device="cpu",
                    auto_start=False)
    fut = srv.submit([1, 2, 3], 4)
    srv.close()
    with pytest.raises(RuntimeError):
        fut.result(timeout=0)


def test_server_close_releases_pool_and_fails_backlog(tiny):
    """``tests/test_serving.py:408`` for the port: close() with a slot in
    flight and a backlog held back by its reservation fails every future
    and returns every block and reservation."""
    srv = LLMServer(params=tiny["tparams"], gpt_config=tiny["cfg"],
                    max_batch=1, block_size=8, num_blocks=10, device="cpu",
                    auto_start=False)
    eng = srv.engine
    mid = srv.submit(list(range(1, 17)), max_tokens=17)
    blocked = srv.submit(list(range(1, 17)), max_tokens=17)
    eng.step()
    assert eng.active_count == 1 and eng.scheduler.queue_depth == 1
    srv.close()
    for fut in (mid, blocked):
        with pytest.raises(RuntimeError):
            fut.result(timeout=0)
    assert _drained(eng)


def test_default_buckets_floor_to_block_multiple():
    """``tests/test_serving.py:428`` for the port: a ``max_position``
    that is not a block multiple floors the top bucket; the engine
    serves a prompt in it."""
    paddle.seed(0)
    cfg = gpt_tiny(use_flash_attention=False, max_position_embeddings=100)
    jnet = JaxGPT(cfg)
    jnet.eval()
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jdm.extract_decode_params(jnet))
    eng = DecodeEngine(params=params_from_numpy(tree, device="cpu"),
                       gpt_config=cfg, max_batch=1, block_size=16,
                       num_blocks=32, device="cpu")
    assert eng._buckets[-1] == 96
    assert eng._chunk_buckets[-1] == 96
    fut = eng.submit(list(range(1, 20)), 3).future
    eng.run_until_idle()
    assert len(fut.result(timeout=0).tokens) == 3


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
def test_cuda_one_capture_per_key_and_none_after_warmup(tiny, cuda_device):
    params = params_from_numpy(tiny["tree"], device=cuda_device)
    eng = DecodeEngine(params=params, gpt_config=tiny["cfg"], max_batch=2,
                       block_size=8, num_blocks=96, prefill_chunk=16,
                       prefix_cache=True, device=cuda_device)
    w = eng.warmup([5, 20, 45])
    assert w["prefill_captures"] == len(w["prefill_keys"]) == 2
    assert w["chunk_captures"] == len(w["chunk_keys"]) == 5
    prompts = _prompts(10, (5, 3, 20, 45))
    futs = [eng.submit(q, max_tokens=4).future for q in prompts]
    eng.run_until_idle()
    futs += [eng.submit(q, max_tokens=4).future for q in prompts[2:]]
    eng.run_until_idle()
    st = eng.compile_stats()
    assert (st["prefill_captures"], st["chunk_captures"]) == (2, 5)
    assert eng.stats()["graph_pool_bytes"] > 0
    # every graph of the engine captured on its one capture stream
    assert {p.call._stream for p in list(eng._prefill_progs.values())
            + list(eng._chunk_progs.values())} == {eng._capture_stream}
    for q, f in zip(prompts + prompts[2:], futs):
        ref, _ = reference_decode(params, tiny["scfg"], q, 4)
        assert f.result(timeout=0).tokens == ref.tolist()
    eng.release_graphs()


@pytest.mark.cuda
def test_cuda_replay_equals_the_eager_body(tiny, cuda_device):
    """A group key and a chunk key: the replay's tokens and pool equal
    the eager body's on a copy of the same pool, bit for bit."""
    params = params_from_numpy(tiny["tree"], device=cuda_device)
    eng = DecodeEngine(params=params, gpt_config=tiny["cfg"], max_batch=2,
                       block_size=8, num_blocks=64, device=cuda_device)
    eng.warmup([5])
    for kind, key in (("prefill", (2, 8)), ("chunk", (16, 4))):
        prog = (eng._group_program(*key) if kind == "prefill"
                else eng._chunk_program(*key))
        body = (eng._group_body if kind == "prefill" else eng._chunk_body)
        host, image = eng._host_image(prog)
        v = prog.views(image)
        if kind == "prefill":
            v[0][0, :5], v[0][1, :7] = [1, 2, 3, 4, 5], [9] * 7
            v[1][:] = [5, 7]
            v[6][:, 0] = [3, 4]
        else:
            v[0][0, :3] = [3, 4, 5]
            v[1][0], v[3][0] = 24, 11
            v[2][0, :11] = np.arange(11) + 20
            v[4][:2] = [6, 7]
        with torch.no_grad(), eng._on_stream():
            prog.run(host, lambda: body(prog))      # warm-up + capture
            pool0 = eng._kv.pool.clone()
            got = prog.run(host, lambda: body(prog))
            pool_replay = eng._kv.pool.clone()
            eng._kv.pool.copy_(pool0)
            body(prog)
            want = prog.out.clone()
        torch.cuda.synchronize()
        assert prog.captures == 1
        assert torch.equal(got, want)
        assert torch.equal(pool_replay, eng._kv.pool)
    eng.release_graphs()
