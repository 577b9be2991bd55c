"""Speculative decoding, ``network=`` and ``refresh_weights`` of the
port against the JAX package.

The same ``gpt_tiny`` weights (a target from seed 0 and an adversarial
draft from seed 7, built in the JAX package) reach the port through
``params_from_numpy`` and, as networks, through ``state_dict_from_jax``.
On the CPU the engine runs its captured step's body eagerly, so these
tests hold everything but the capture: ``spec_score_forward``'s logits
and page writes against the JAX function on the same pool (1e-5, a
window past the table's reach included), ``sample_tokens_grid`` bit for
bit against ``sample_tokens`` on the flattened grid,
``spec_decode_step`` against the JAX one (the same emitted window, last
token and count), and the engine's greedy tokens equal to the JAX
``reference_decode``'s with a self-draft and with an adversarial draft.
Sampled tokens compare only within the port (the JAX package's noise is
threefry).  The ``cuda``-marked tests hold the two captures of a
speculative engine and a refresh without a recapture on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny
from paddle_tpu.inference.serving import decode_model as jdm
from paddle_tpu.inference.serving import spec_decode as jsd

from paddle_tpu_torch.framework import env_knobs
from paddle_tpu_torch.inference.serving import (
    SPEC_SENTINEL, DecodeEngine, LLMServer, ServingModelConfig,
    extract_decode_params, filter_spec_stream, params_from_numpy,
    reference_decode, sample_tokens, sample_tokens_grid,
    spec_decode_step, spec_score_forward)
from paddle_tpu_torch.inference.serving import paged_attention_kernel as pak
from paddle_tpu_torch.models import GPTForCausalLM, state_dict_from_jax
from paddle_tpu_torch.models import gpt_tiny as torch_gpt_tiny
from torch_parity_helpers import torch_one_thread  # noqa: F401

LOGIT_TOL = 1e-5          # 2-layer fp32 forward, two libraries' sum orders
K = 4


def _tree(jnet):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32),
                                  jdm.extract_decode_params(jnet))


def _port_net(jnet, cfg):
    net = GPTForCausalLM(torch_gpt_tiny(), device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, torch_gpt_tiny()))
    net.eval()
    return net


@pytest.fixture(scope="module")
def nets():
    """The JAX target and adversary, their numpy trees, the port's
    weights and the port's networks."""
    cfg = gpt_tiny(use_flash_attention=False)
    paddle.seed(0)
    jt = JaxGPT(cfg)
    jt.eval()
    paddle.seed(7)
    ja = JaxGPT(cfg)
    ja.eval()
    tt, ta = _tree(jt), _tree(ja)
    return dict(cfg=cfg, jt=jt, ja=ja, jparams=jdm.extract_decode_params(jt),
                jadv=jdm.extract_decode_params(ja),
                tparams=params_from_numpy(tt, device="cpu"),
                tadv=params_from_numpy(ta, device="cpu"),
                net=_port_net(jt, cfg), adv_net=_port_net(ja, cfg),
                scfg=ServingModelConfig.from_gpt_config(cfg))


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lens]


def _engine(n, draft="self", **kw):
    base = dict(params=n["tparams"], gpt_config=n["cfg"], max_batch=2,
                block_size=8, num_blocks=64, device="cpu", spec_k=K)
    if draft is not None:
        base["draft_params"] = n["tparams"] if draft == "self" else n["tadv"]
    base.update(kw)
    return DecodeEngine(**base)


def _jax_ref(n):
    def ref(prompt, m):
        toks, _ = jdm.reference_decode(n["jparams"], n["scfg"], prompt, m)
        return [int(t) for t in toks]
    return ref


def _port_ref(n):
    def ref(prompt, m, **kw):
        toks, _ = reference_decode(n["tparams"], n["scfg"], prompt, m, **kw)
        return toks.tolist()
    return ref


def _drained(eng):
    st = eng._kv.allocator.stats()
    return st["allocated"] == 0 and st["reserved"] == 0


# ---------------------------------------------------------------------------
# the functions: against the JAX package
# ---------------------------------------------------------------------------
def _pool_case(n, seed, B=3, MAXNB=3, BS=8, NB=12):
    cfg = n["scfg"]
    rng = np.random.RandomState(seed)
    pool = rng.standard_normal((cfg.num_layers, 2, NB, BS, cfg.num_heads,
                                cfg.head_dim)).astype(np.float32)
    # disjoint pages per request (block 0 is scratch)
    table = rng.permutation(np.arange(1, NB))[:B * MAXNB].reshape(
        B, MAXNB).astype(np.int32)
    return pool, table, rng


@pytest.mark.parametrize("lengths", [(3, 9, 13), (22, 5, 20)])
def test_spec_score_forward_matches_jax(nets, lengths):
    """Logits and every page write against the JAX function on the same
    pool; ``(22, 5, 20)`` at MAXNB*BS = 24 puts three of request 0's
    window rows past the table's reach, which must land in the scratch
    block and leave position 23 (the last real slot) with row 1's K/V."""
    n = nets
    pool, table, rng = _pool_case(n, 11)
    B, S = len(lengths), K + 1
    lens = np.asarray(lengths, dtype=np.int32)
    toks = rng.randint(0, 256, (B, S)).astype(np.int32)
    ok = np.array([True, True, False])
    jpool, jlog = jdm.spec_score_forward(
        n["jparams"], n["scfg"], jnp.asarray(pool), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(toks), jnp.asarray(ok))
    tpool = torch.from_numpy(pool.copy())
    tlog = spec_score_forward(n["tparams"], n["scfg"], tpool,
                              torch.from_numpy(table), torch.from_numpy(lens),
                              torch.from_numpy(toks), torch.from_numpy(ok))
    assert tlog.shape == (B, S, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=0)
    # every real block as the JAX scatter left it (the scratch block
    # takes colliding masked writes in an order neither defines)
    np.testing.assert_allclose(tpool.numpy()[:, :, 1:],
                               np.asarray(jpool)[:, :, 1:],
                               atol=LOGIT_TOL, rtol=0)
    # the inactive request wrote nothing outside scratch
    assert np.array_equal(tpool.numpy()[:, :, table[2]], pool[:, :, table[2]])


def test_spec_score_forward_routes_past_reach_rows_to_scratch(nets):
    """The last real slot keeps the K/V of the row at its own position,
    never a clamped later row's."""
    n = nets
    pool, table, rng = _pool_case(n, 12, B=1)
    lens = np.array([22], dtype=np.int32)
    toks = rng.randint(0, 256, (1, K + 1)).astype(np.int32)
    tpool = torch.from_numpy(pool.copy())
    spec_score_forward(n["tparams"], n["scfg"], tpool,
                       torch.from_numpy(table), torch.from_numpy(lens),
                       torch.from_numpy(toks), torch.tensor([True]))
    # the window's first two rows alone: positions 22 and 23, nothing
    # past the reach
    solo = torch.from_numpy(pool.copy())
    spec_score_forward(n["tparams"], n["scfg"], solo,
                       torch.from_numpy(table), torch.from_numpy(lens),
                       torch.from_numpy(toks[:, :2].copy()),
                       torch.tensor([True]))
    last = int(table[0, 2])
    np.testing.assert_allclose(tpool[:, :, last, 7].numpy(),
                               solo[:, :, last, 7].numpy(),
                               atol=LOGIT_TOL, rtol=0)
    assert not np.allclose(solo[:, :, last, 7].numpy(),
                           pool[:, :, last, 7])      # it was written


def test_sample_tokens_grid_is_sample_tokens_on_the_flat_grid(nets):
    g = torch.Generator().manual_seed(3)
    B, S, V = 3, K + 1, 256
    logits = torch.randn(B, S, V, generator=g) * 3
    temps = torch.tensor([0.0, 0.8, 1.3])
    topks = torch.tensor([0, 20, 0])
    topps = torch.tensor([1.0, 0.9, 0.7])
    seeds = torch.tensor([5, 2 ** 32 - 9, 77], dtype=torch.int64)
    pos = torch.tensor([[7], [30], [2]]) + torch.arange(S)[None]
    got = sample_tokens_grid(logits, temps, topks, topps, seeds, pos)
    flat = sample_tokens(logits.reshape(B * S, V), temps.repeat_interleave(S),
                         topks.repeat_interleave(S),
                         topps.repeat_interleave(S),
                         seeds.repeat_interleave(S), pos.reshape(-1))
    assert got.dtype == torch.int32
    assert torch.equal(got, flat.reshape(B, S))
    # slot (b, i) is the one-token draw at that position
    for i in range(S):
        one = sample_tokens(logits[:, i], temps, topks, topps, seeds, pos[:, i])
        assert torch.equal(got[:, i], one)
    greedy = sample_tokens_grid(logits, temps, topks, topps, seeds, pos,
                                greedy=True)
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))


@pytest.mark.parametrize("draft", ["self", "adversary"])
@pytest.mark.parametrize("greedy", [True, False])
def test_spec_decode_step_matches_jax_greedy(nets, draft, greedy):
    """Greedy rows (temperature 0), through the greedy variant and the
    mixed one: the same emitted window, last token and count as the JAX
    step, and the same pool."""
    n = nets
    pool, table, rng = _pool_case(n, 21, B=3, MAXNB=4, NB=14)
    lens = np.array([5, 17, 0], dtype=np.int32)
    toks = rng.randint(0, 256, (3,)).astype(np.int32)
    active = lens > 0
    z = np.zeros(3, np.float32)
    jd = n["jparams"] if draft == "self" else n["jadv"]
    td = n["tparams"] if draft == "self" else n["tadv"]
    jpool, jemit, jlast, jn = jsd.spec_decode_step(
        n["jparams"], jd, n["scfg"], K, jnp.asarray(pool),
        jnp.asarray(table), jnp.asarray(lens), jnp.asarray(toks),
        jnp.asarray(active), jnp.asarray(z), jnp.zeros(3, jnp.int32),
        jnp.ones(3, jnp.float32), jnp.zeros(3, jnp.uint32))
    tpool = torch.from_numpy(pool.copy())
    emit, last, n_emit = spec_decode_step(
        n["tparams"], td, n["scfg"], K, tpool, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(toks),
        torch.from_numpy(active), torch.from_numpy(z),
        torch.zeros(3, dtype=torch.int32), torch.ones(3),
        torch.zeros(3, dtype=torch.int64), greedy=greedy)
    assert emit.tolist() == np.asarray(jemit).tolist()
    assert last.tolist() == np.asarray(jlast).tolist()
    assert n_emit.tolist() == np.asarray(jn).tolist()
    if draft == "self":
        assert n_emit.tolist() == [K + 1, K + 1, 0]
    else:
        assert (emit[:2] == SPEC_SENTINEL).any()    # it did reject
    assert emit[2].tolist() == [SPEC_SENTINEL] * (K + 1)
    np.testing.assert_allclose(tpool.numpy()[:, :, 1:],
                               np.asarray(jpool)[:, :, 1:],
                               atol=LOGIT_TOL, rtol=0)


def test_extract_decode_params_is_bit_equal_to_the_jax_tree(nets):
    n = nets
    got = extract_decode_params(n["net"])
    want = n["tparams"]
    names = [k for k, _ in want.named_parameters()]
    assert [k for k, _ in got.named_parameters()] == names
    w = dict(want.named_parameters())
    for k, p in got.named_parameters():
        assert p.dtype == torch.float32 and not p.requires_grad
        assert torch.equal(p, w[k]), k
    # a copy, not a view of the training weights
    wte = n["net"].gpt.embeddings.word_embeddings.weight
    assert got.wte.data_ptr() != wte.data_ptr()
    with pytest.raises(TypeError):
        extract_decode_params(torch.nn.Linear(4, 4))


# ---------------------------------------------------------------------------
# the engine: exactness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("draft", ["self", "adversary"])
def test_spec_greedy_tokens_equal_jax_reference(nets, draft):
    """Mixed lengths, ``max_tokens`` 3 landing inside the first window
    (k = 4): every request equals the JAX sequential reference."""
    n = nets
    ref = _jax_ref(n)
    eng = _engine(n, draft, max_batch=4)
    prompts = _prompts(1, (5, 11, 3, 17))
    lens = (12, 3, 5, 9)
    futs = [eng.submit(p, max_tokens=m).future for p, m in zip(prompts, lens)]
    eng.run_until_idle()
    for p, m, f in zip(prompts, lens, futs):
        assert f.result(timeout=0).tokens == ref(p, m)
    assert eng.compile_stats()["decode_captures"] == 0     # the CPU
    assert _drained(eng)
    spec = eng.stats()["spec"]
    assert spec["k"] == K and spec["dispatches"] > 0
    assert 1.0 <= spec["tokens_per_dispatch"] <= K + 1
    if draft == "self":
        assert spec["accept_rate"] == 1.0
    else:
        assert 0.0 <= spec["accept_rate"] < 1.0


@pytest.mark.parametrize("draft", ["self", "adversary"])
def test_spec_seeded_sampling_equals_port_reference(nets, draft):
    n = nets
    ref = _port_ref(n)
    prompt = _prompts(3, (9,))[0]
    kw = dict(temperature=0.9, top_k=12, top_p=0.85, seed=42)
    eng = _engine(n, draft)
    fut = eng.submit(prompt, max_tokens=11, **kw).future
    eng.run_until_idle()
    assert fut.result(timeout=0).tokens == ref(prompt, 11, **kw)


def test_spec_mixed_greedy_and_sampled_batch(nets):
    n = nets
    ref = _port_ref(n)
    eng = _engine(n, max_batch=3, spec_k=3)
    prompts = _prompts(4, (4, 8, 6))
    kws = [dict(), dict(temperature=1.1, seed=5),
           dict(temperature=0.7, top_k=8, seed=9)]
    futs = [eng.submit(p, max_tokens=7, **kw).future
            for p, kw in zip(prompts, kws)]
    eng.run_until_idle()
    for p, kw, f in zip(prompts, kws, futs):
        assert f.result(timeout=0).tokens == ref(p, 7, **kw)
    assert _jax_ref(n)(prompts[0], 7) == futs[0].result(timeout=0).tokens


@pytest.mark.parametrize("draft", ["self", "adversary"])
def test_spec_eos_inside_a_window(nets, draft):
    """EOS emitted inside a window: the result stops at (and keeps) it,
    and the device's done mask frees the slot before max_tokens."""
    n = nets
    prompt = list(range(3, 9))
    toks = _jax_ref(n)(prompt, 10)
    eos = toks[4]
    cut = toks.index(eos)
    eng = _engine(n, draft, max_batch=1, eos_id=eos, done_poll_interval=2)
    fut = eng.submit(prompt, 10).future
    eng.run_until_idle()
    got = fut.result(timeout=0).tokens
    assert got == toks[:cut + 1] and got[-1] == eos
    assert eng.active_count == 0 and _drained(eng)


@pytest.mark.parametrize("max_tokens", [1, 2, 3, 6, 7])
def test_spec_max_tokens_inside_a_window(nets, max_tokens):
    """The device stops after the window that crosses max_tokens; the
    result is cut to it exactly, and the poll without an EOS id fires
    only once some lane may have reached it."""
    n = nets
    prompt = _prompts(9, (7,))[0]
    eng = _engine(n, max_batch=1)
    polls = []
    real = eng._poll_done
    eng._poll_done = lambda: (polls.append(eng._dispatches), real())
    fut = eng.submit(prompt, max_tokens).future
    eng.run_until_idle()
    assert fut.result(timeout=0).tokens == _jax_ref(n)(prompt, max_tokens)
    # token 0 comes from the prefill, each window commits k+1
    windows = -(-(max_tokens - 1) // (K + 1))
    assert eng.stats()["dispatches"] == windows
    assert polls == ([windows] if windows else [])
    assert _drained(eng)


def test_spec_join_and_leave_across_groups(nets):
    n = nets
    ref = _jax_ref(n)
    eng = _engine(n)
    p1, p2, p3, p4 = _prompts(5, (5, 9, 12, 3))
    f1 = eng.submit(p1, 4).future
    f2 = eng.submit(p2, 10).future
    for _ in range(4):
        if not eng.step():
            break
    f3 = eng.submit(p3, 6).future
    f4 = eng.submit(p4, 8).future
    eng.run_until_idle()
    for p, m, f in ((p1, 4, f1), (p2, 10, f2), (p3, 6, f3), (p4, 8, f4)):
        assert f.result(timeout=0).tokens == ref(p, m)
    assert eng.compile_stats()["decode_captures"] == 0
    assert _drained(eng)
    # every slot left the device loop: length 0, done
    assert eng._lengths_dev.tolist() == [0, 0]
    assert eng._done.tolist() == [True, True]


def test_spec_static_buffers_keep_their_addresses(nets):
    n = nets
    eng = _engine(n, eos_id=None)
    names = ("_table_dev", "_lengths_dev", "_gen", "_spec_state", "_emit",
             "_samp_dev", "_maxt_dev", "_tokens", "_done")
    ptrs = {k: getattr(eng, k).data_ptr() for k in names}
    for i, (p, m) in enumerate(zip(_prompts(6, (5, 12, 9)), (3, 7, 9))):
        eng.submit(p, max_tokens=m, temperature=0.8 * (i % 2), seed=i)
    while eng.step():
        assert {k: getattr(eng, k).data_ptr() for k in names} == ptrs
    assert eng.stats()["completed"] == 3


# ---------------------------------------------------------------------------
# the look-ahead envelope
# ---------------------------------------------------------------------------
def test_spec_admission_reserves_k_lookahead(nets):
    """A request the plain engine admits at the pool's edge is refused by
    the speculative door: its uncommitted window writes could outrun the
    allocation."""
    n = nets
    prompt = list(range(1, 9))                 # 8 + 9 - 1 = 16 = 2 blocks
    plain = _engine(n, None, max_batch=1, num_blocks=3, spec_k=None)
    plain.submit(prompt, 9)
    spec = _engine(n, max_batch=1, num_blocks=3)
    assert spec.scheduler.lookahead == K
    with pytest.raises(ValueError):
        spec.submit(prompt, 9)                 # 16 + 4 > 2 blocks
    req = spec.submit(prompt, 5)               # 8 + 4 + 4 = 16: admitted
    spec.run_until_idle()
    assert req.block_budget == 2 and _drained(spec)


def test_spec_no_oom_under_rejection_churn(nets):
    n = nets
    ref = _jax_ref(n)
    eng = _engine(n, "adversary", num_blocks=12, max_queue=8)
    jobs = []
    for p in _prompts(6, (5, 11, 7, 3)):
        jobs.append((p, eng.submit(p, max_tokens=9).future))
    eng.run_until_idle()
    for p, f in jobs:
        assert f.result(timeout=0).tokens == ref(p, 9)
    assert _drained(eng)


def test_spec_composes_with_prefix_cache_and_chunked_prefill(nets):
    n = nets
    ref = _jax_ref(n)
    eng = _engine(n, prefix_cache=True, prefill_chunk=8)
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 256, (16,)).tolist()
    a = shared + rng.randint(0, 256, (5,)).tolist()
    b = shared + rng.randint(0, 256, (3,)).tolist()
    c = rng.randint(0, 256, (30,)).tolist()         # four chunks
    fa = eng.submit(a, max_tokens=8).future
    eng.run_until_idle()
    fb = eng.submit(b, max_tokens=8).future         # prefix now cached
    fc = eng.submit(c, max_tokens=11).future
    eng.run_until_idle()
    assert fa.result(timeout=0).tokens == ref(a, 8)
    assert fb.result(timeout=0).tokens == ref(b, 8)
    assert fc.result(timeout=0).tokens == ref(c, 11)
    assert eng._prefix.stats()["hits"] > 0
    assert eng.stats()["prefill_chunks"] > 0


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------
def test_filter_spec_stream_drops_sentinels_and_renumbers():
    seen = []
    wrapped = filter_spec_stream(
        lambda rid, idx, tok: seen.append((rid, idx, tok)), max_tokens=4)
    feed = [3, SPEC_SENTINEL, 5, SPEC_SENTINEL, SPEC_SENTINEL, 7, 9, 11]
    for i, t in enumerate(feed):
        wrapped(1, i, t)
    wrapped(2, 0, 8)                           # numbered per request
    assert seen == [(1, 0, 3), (1, 1, 5), (1, 2, 7), (1, 3, 9), (2, 0, 8)]


@pytest.mark.parametrize("draft", ["self", "adversary"])
def test_spec_stream_equals_the_result(nets, draft):
    n = nets
    server = LLMServer(params=n["tparams"], gpt_config=n["cfg"],
                       draft_params=n["tparams"] if draft == "self"
                       else n["tadv"], spec_k=K, max_batch=1, block_size=8,
                       num_blocks=64, device="cpu")
    got, raw = [], []
    cb = filter_spec_stream(lambda rid, idx, tok: got.append((idx, tok)),
                            max_tokens=9)
    try:
        fut = server.submit(list(range(2, 9)), max_tokens=9,
                            stream_cb=lambda *a: (raw.append(a), cb(*a)))
        toks = fut.result(timeout=60).tokens
    finally:
        server.close()
    assert [i for i, _ in got] == list(range(len(toks)))
    assert [t for _, t in got] == toks
    assert SPEC_SENTINEL not in toks and len(toks) == 9
    # token 0 from the prefill, then k+1 views a dispatch
    assert (len(raw) - 1) % (K + 1) == 0


# ---------------------------------------------------------------------------
# configuration and refusals
# ---------------------------------------------------------------------------
def test_spec_refusals(nets):
    n = nets
    with pytest.raises(ValueError, match="spec_k"):
        _engine(n, None)                        # spec_k without a draft
    with pytest.raises(ValueError, match="spec_k"):
        _engine(n, spec_k=0)
    one_layer = GPTForCausalLM(torch_gpt_tiny(num_hidden_layers=1),
                               device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        DecodeEngine(network=n["net"], draft=one_layer, device="cpu")
    tree = _tree(n["jt"])
    tree["layers"] = tree["layers"][:1]
    with pytest.raises(ValueError, match="shapes"):
        _engine(n, draft_params=params_from_numpy(tree, device="cpu"))
    with pytest.raises(ValueError, match="bfloat16"):
        _engine(n, draft_params=params_from_numpy(
            _tree(n["jt"]), device="cpu", dtype=torch.bfloat16))
    # the auto-tuned poll cadence is the default on a speculative engine
    # too (its calibration runs only with an EOS id)
    auto = _engine(n, done_poll_interval=None)
    assert auto._poll_auto and auto.done_poll_interval == 8
    # a speculative engine may be a decode replica, never a prefill one
    assert _engine(n, role="decode").spec_k == K
    with pytest.raises(ValueError, match="prefill-role"):
        _engine(n, role="prefill")


def test_spec_k_env_knob(nets, monkeypatch):
    n = nets
    monkeypatch.setenv("PADDLE_TORCH_SPEC_K", "2")
    assert env_knobs.get_int("PADDLE_TORCH_SPEC_K", 4) == 2
    eng = _engine(n, spec_k=None)
    assert eng.spec_k == 2 and eng.scheduler.lookahead == 2
    assert eng._emit.shape == (2, 3)
    plain = _engine(n, None, spec_k=None)
    assert plain.spec_k == 0 and plain.scheduler.lookahead == 0
    monkeypatch.delenv("PADDLE_TORCH_SPEC_K")
    assert _engine(n, spec_k=None).spec_k == 4


def test_release_all_clears_speculative_slots(nets):
    """The server's fail-all path: every slot leaves the device loop, so
    a restarted pump runs no dead lane, and the next request is exact."""
    n = nets
    eng = _engine(n)
    futs = [eng.submit(p, 20).future for p in _prompts(8, (6, 10))]
    eng.step()
    eng.step()
    assert eng._lengths_dev.tolist() != [0, 0]
    eng.release_all(RuntimeError("pump died"))
    assert all(isinstance(f.exception(timeout=0), RuntimeError) for f in futs)
    assert eng._lengths_dev.tolist() == [0, 0] and eng._gen.tolist() == [0, 0]
    assert eng._done.tolist() == [True, True]
    assert _drained(eng)
    p = _prompts(9, (5,))[0]
    fut = eng.submit(p, 7).future
    eng.run_until_idle()
    assert fut.result(timeout=0).tokens == _jax_ref(n)(p, 7)


# ---------------------------------------------------------------------------
# network= and refresh_weights
# ---------------------------------------------------------------------------
def test_network_engine_with_network_draft(nets):
    """``DecodeEngine(network=, draft=)`` on the port's networks: the
    tokens of the JAX reference, and the params engine's."""
    n = nets
    eng = DecodeEngine(n["net"], draft=n["adv_net"], spec_k=3, max_batch=2,
                       block_size=8, num_blocks=64, device="cpu")
    assert eng.spec_k == 3
    plain = DecodeEngine(n["net"], max_batch=2, block_size=8, num_blocks=64,
                         device="cpu")
    prompts = _prompts(10, (6, 13))
    futs = [e.submit(p, 9).future for e in (eng, plain) for p in prompts]
    eng.run_until_idle()
    plain.run_until_idle()
    want = [_jax_ref(n)(p, 9) for p in prompts]
    assert [f.result(timeout=0).tokens for f in futs] == want * 2


@pytest.mark.parametrize("spec", [False, True])
def test_refresh_weights_equals_a_fresh_server(nets, spec):
    n = nets
    kw = dict(max_batch=2, block_size=8, num_blocks=64, device="cpu",
              auto_start=False)
    if spec:
        kw.update(draft=n["net"], spec_k=K)
    prompts = _prompts(12, (5, 9))
    server = LLMServer(n["net"], **kw)
    fresh = LLMServer(n["adv_net"], **kw)

    def run(srv):
        srv.start()
        try:
            return [srv.submit(p, 8).result(timeout=60).tokens
                    for p in prompts]
        finally:
            srv.stop()

    before = run(server)
    assert before == [_jax_ref(n)(p, 8) for p in prompts]
    weights = server.engine._params.wte
    ptr = weights.data_ptr()
    server.start()
    with pytest.raises(RuntimeError, match="stop the server"):
        server.refresh_weights(n["adv_net"])
    server.stop()
    server.refresh_weights(n["adv_net"],
                           draft=n["adv_net"] if spec else None)
    assert server.engine._params.wte.data_ptr() == ptr       # in place
    assert server.engine._params.wte is weights
    assert run(server) == run(fresh)
    if spec:
        assert torch.equal(server.engine._draft_params.wte,
                           fresh.engine._params.wte)
    else:
        with pytest.raises(ValueError, match="non-speculative"):
            server.refresh_weights(n["net"], draft=n["net"])
    wide = GPTForCausalLM(torch_gpt_tiny(hidden_size=128), device="cpu")
    with pytest.raises(ValueError, match="shape or dtype"):
        server.refresh_weights(wide)
    server.close()
    fresh.close()


def test_refresh_of_a_self_draft_sharing_the_weights(nets):
    """``draft_params=params``: one set of weights serves both, so a
    refresh of the target refreshes the draft, and a separate draft is
    refused (it would overwrite the target)."""
    n = nets
    params = params_from_numpy(_tree(n["jt"]), device="cpu")
    server = LLMServer(params=params, gpt_config=n["cfg"],
                       draft_params=params, spec_k=K, max_batch=2,
                       block_size=8, num_blocks=64, device="cpu",
                       auto_start=False)
    with pytest.raises(ValueError, match="own weights"):
        server.refresh_weights(n["adv_net"], draft=n["net"])
    server.refresh_weights(n["adv_net"])
    assert server.engine._draft_params is server.engine._params
    assert torch.equal(params.wte, n["tadv"].wte)
    p = _prompts(13, (7,))[0]
    fut = server.submit(p, 6)
    server.engine.run_until_idle()
    ref, _ = reference_decode(n["tadv"], n["scfg"], p, 6)
    assert fut.result(timeout=0).tokens == ref.tolist()
    server.close()


def test_stop_that_times_out_keeps_refresh_refused(nets):
    """A pump still inside a step when ``stop`` gives up: ``stop``
    raises, the server stays running, and ``refresh_weights`` (an
    in-place copy into the weights the step reads) and ``warmup`` keep
    refusing until the step has ended and ``stop`` succeeds."""
    import threading
    n = nets
    server = LLMServer(n["net"], draft=n["net"], spec_k=K, max_batch=2,
                       block_size=8, num_blocks=64, device="cpu",
                       auto_start=False)
    inside, release = threading.Event(), threading.Event()
    step = server.engine.step

    def slow_step():
        inside.set()
        release.wait(30.0)
        return step()

    server.engine.step = slow_step
    server.start()
    assert inside.wait(30.0)
    with pytest.raises(RuntimeError, match="still in flight"):
        server.stop(timeout=0.05)
    assert server.running
    with pytest.raises(RuntimeError, match="stop the server"):
        server.refresh_weights(n["adv_net"])
    with pytest.raises(RuntimeError, match="exclusive"):
        server.warmup()
    release.set()
    server.stop()
    assert not server.running
    server.refresh_weights(n["adv_net"])
    assert torch.equal(server.engine._params.wte, n["tadv"].wte)
    server.close()


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
def test_cuda_spec_two_captures_and_replays_match_reference(nets,
                                                            cuda_device):
    n = nets
    cfg = n["cfg"]
    params = extract_decode_params(n["net"], device=cuda_device)
    adv = extract_decode_params(n["adv_net"], device=cuda_device)
    eng = DecodeEngine(params=params, gpt_config=cfg, draft_params=adv,
                       spec_k=K, max_batch=3, block_size=16, num_blocks=64,
                       device=cuda_device)
    assert eng.warmup([8, 40])["decode_captures"] == 2
    prompts = _prompts(43, (5, 17, 40, 9))
    kw = [dict(), dict(temperature=0.9, top_k=20, top_p=0.9, seed=7),
          dict(), dict()]
    pak.paged_ragged_attention.launches = 0
    pak._cuda_core_paged.launches = 0
    futs = [eng.submit(p, max_tokens=12, **k).future
            for p, k in zip(prompts, kw)]
    eng.run_until_idle()
    assert eng.compile_stats()["decode_captures"] == 2
    assert pak.paged_ragged_attention.launches == \
        eng.stats()["dispatches"] * cfg.num_hidden_layers * (K + 1)
    assert pak._cuda_core_paged.launches == 0
    scfg = n["scfg"]
    for p, k, f in zip(prompts, kw, futs):
        ref, _ = reference_decode(params, scfg, p, 12, **k)
        assert f.result(timeout=0).tokens == ref.tolist()
    assert _drained(eng)


@pytest.mark.cuda
def test_cuda_refresh_replays_new_weights_without_a_recapture(nets,
                                                              cuda_device):
    n = nets
    server = LLMServer(n["net"], draft=n["net"], spec_k=K, max_batch=2,
                       block_size=16, num_blocks=64, device=cuda_device,
                       auto_start=False)
    server.warmup([8])
    steps = dict(server.engine._steps)
    prompts = _prompts(44, (6, 11))
    server.start()
    try:
        [server.submit(p, 10).result(timeout=120) for p in prompts]
    finally:
        server.stop()
    server.refresh_weights(n["adv_net"], draft=n["adv_net"])
    server.start()
    try:
        got = [server.submit(p, 10).result(timeout=120).tokens
               for p in prompts]
        assert server.engine._steps == steps       # the same graphs
        assert server.engine.compile_stats()["decode_captures"] == 2
    finally:
        server.close()
    params = extract_decode_params(n["adv_net"], device=cuda_device)
    for p, t in zip(prompts, got):
        ref, _ = reference_decode(params, n["scfg"], p, 10)
        assert t == ref.tolist()
