"""The port's disaggregated tier against the JAX package's
(``tests/test_serving_disagg.py`` case for case, and the spec handoff
of ``tests/test_serving_spec.py``).

Same ``gpt_tiny`` weights in both packages (carried across with
``params_from_numpy``), engines on the CPU.  Tolerances: none.  Greedy
tokens after a prefill → decode handoff equal the JAX engines' handoff
and the JAX ``reference_decode`` exactly; migrated pages are bit-equal
to the source pages; the allocators' export/import accounting equals
the JAX allocator's step for step.  Seeded sampled tokens cannot
compare across packages (threefry against the port's hashed noise), so
a sampled handoff is held against the port's own role-"both" engine.
The ``cuda``-marked tests (skipped without a card) hold an import into
a captured decode graph and the cross-stream event.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models import GPTForCausalLM, gpt_tiny
from paddle_tpu.inference.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.inference.serving import decode_model as jdm
from paddle_tpu.inference.serving import kv_cache as jkv
from paddle_tpu.inference.serving import migration as jmig

from paddle_tpu_torch.inference.serving import (
    BlockAllocator, DecodeEngine, DisaggRouter, LLMServer, MigrationError,
    PageMigration, PrefixCache, QueueFull, SCRATCH_BLOCK,
    ServingRouter, gather_request_pages, params_from_numpy,
    scatter_request_pages)
from paddle_tpu_torch.observability import metrics as tmetrics
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
    tparams = params_from_numpy(tree, device="cpu")
    scfg = jdm.ServingModelConfig.from_gpt_config(cfg)

    def oracle(prompt, n, **kw):
        toks, _ = jdm.reference_decode(jparams, scfg, prompt, n, **kw)
        return [int(t) for t in toks]
    return net, cfg, tparams, oracle


def _engine(tparams, cfg, **kw):
    base = dict(params=tparams, gpt_config=cfg, max_batch=2, block_size=8,
                num_blocks=64, device="cpu")
    base.update(kw)
    return DecodeEngine(**base)


def _prompts(seed, lens, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).tolist() for n in lens]


def _drain(eng, max_steps=500):
    for _ in range(max_steps):
        busy = eng.step()
        if not busy and eng.active_count == 0 \
                and eng.pending_migrations == 0:
            return
    raise AssertionError("engine did not drain")


def _handoff_all(pre, dec, max_steps=500):
    """Direct-drive a prefill engine until every staged ticket has
    reached the decode engine."""
    for _ in range(max_steps):
        busy = pre.step()
        for mig in pre.pop_ready_migrations():
            dec.submit_migration(mig)
        if not busy:
            return
    raise AssertionError("prefill engine did not drain")


def _empty(eng):
    st = eng._kv.allocator.stats()
    return (st["free"] == st["capacity"] and st["reserved"] == 0
            and st["pinned"] == 0)


# ---------------------------------------------------------------------------
# migration unit lifecycle
# ---------------------------------------------------------------------------
def test_allocator_export_import_accounting_matches_jax_step_for_step():
    ja, ta = jkv.BlockAllocator(17), BlockAllocator(17)
    held_j, held_t = {}, {}
    ops = [("a", "x", 3), ("a", "y", 5), ("e", "x", 0), ("i", "z", 4),
           ("a", "w", 2), ("e", "y", 0), ("f", "z", 0), ("i", "v", 6),
           ("e", "w", 0), ("f", "v", 0)]
    for op, key, n in ops:
        if op == "a":
            held_j[key], held_t[key] = ja.allocate(n), ta.allocate(n)
        elif op == "i":
            held_j[key], held_t[key] = ja.import_blocks(n), \
                ta.import_blocks(n)
        elif op == "e":
            assert ta.export_blocks(held_t.pop(key)) == \
                ja.export_blocks(held_j.pop(key))
        else:
            ja.free(held_j.pop(key))
            ta.free(held_t.pop(key))
        assert held_t == held_j
        assert ta.stats() == ja.stats(), (op, key)
    assert ta.stats()["exported_blocks"] == 10
    assert ta.stats()["imported_blocks"] == 10
    got = ta.allocate(2)
    ta.export_blocks(got)
    with pytest.raises(ValueError):
        ta.export_blocks(got)          # a double export is a double free


def test_pinned_blocks_tighten_the_admission_envelope():
    a = BlockAllocator(11)             # capacity 10
    assert a.reserve(6)
    a.pin(3)
    assert not a.can_reserve(2)        # 6 + 3 + 2 > 10
    assert a.can_reserve(1)
    a.unpin(3)
    assert a.can_reserve(4)
    with pytest.raises(ValueError):
        a.unpin(1)


def test_prefix_cache_pin_referenced_mode():
    a = BlockAllocator(17)
    pc = PrefixCache(a, block_size=4, pin_referenced=True)
    prompt = list(range(13))           # 3 shareable blocks
    entries, _ = pc.insert(prompt, 0, b"", a.allocate(3))
    assert a.pinned == 3
    got, _ = pc.match(prompt)
    assert len(got) == 3 and a.pinned == 3
    pc.release(got)
    assert a.pinned == 3
    pc.release(entries)
    assert a.pinned == 0


def test_gather_scatter_pages_match_jax_and_are_bit_exact():
    rng = np.random.RandomState(4)
    L, NB, BS, H, Dh = 2, 12, 4, 2, 8
    src = rng.randn(L, 2, NB, BS, H, Dh).astype(np.float32)
    dst = rng.randn(L, 2, NB, BS, H, Dh).astype(np.float32)
    ids = np.array([5, 2, 9, SCRATCH_BLOCK], dtype=np.int32)
    to = np.array([7, 1, 3, SCRATCH_BLOCK], dtype=np.int32)
    jkvs = jmig.gather_request_pages(jnp.asarray(src), jnp.asarray(ids))
    tkv = gather_request_pages(torch.from_numpy(src), torch.from_numpy(ids))
    np.testing.assert_array_equal(tkv.numpy(), np.asarray(jkvs))
    tpool = torch.from_numpy(dst.copy())
    ptr = tpool.data_ptr()
    assert scatter_request_pages(tpool, tkv, torch.from_numpy(to)) is None
    assert tpool.data_ptr() == ptr                  # in place
    jpool = jmig.scatter_request_pages(jnp.asarray(dst), jkvs,
                                       jnp.asarray(to))
    real = [b for b in range(1, NB)]                # scratch is never read
    np.testing.assert_array_equal(tpool.numpy()[:, :, real],
                                  np.asarray(jpool)[:, :, real])
    np.testing.assert_array_equal(tpool.numpy()[:, :, [7, 1, 3]],
                                  src[:, :, [5, 2, 9]])


def test_migration_ticket_single_use_and_geometry(tiny):
    _, cfg, tparams, _ = tiny
    eng = _engine(tparams, cfg, num_blocks=32)
    kvc = eng._kv
    good = {"num_layers": kvc.num_layers, "block_size": kvc.block_size,
            "num_heads": kvc.num_heads, "head_dim": kvc.head_dim,
            "dtype": str(kvc.pool.dtype)}

    class _Req:
        id, prompt, max_tokens = 1, [1, 2, 3], 4
    mig = PageMigration(_Req(), kv=None, nb=1, token=None, t_start=0.0,
                        geometry=dict(good, block_size=16))
    with pytest.raises(MigrationError):
        mig.check_geometry(eng)
    mig2 = PageMigration(_Req(), kv=None, nb=1, token=None, t_start=0.0,
                         geometry=good)
    mig2.check_geometry(eng)
    mig2.consume()
    with pytest.raises(MigrationError):
        mig2.consume()
    with pytest.raises(MigrationError):
        eng.submit_migration(mig2)     # consumed ticket at the door


def test_role_contract(tiny):
    _, cfg, tparams, _ = tiny
    with pytest.raises(ValueError):
        _engine(tparams, cfg, role="training")
    with pytest.raises(ValueError):
        _engine(tparams, cfg, prefix_reserve_discount=True,
                prefix_cache=False)
    with pytest.raises(ValueError, match="prefill-role"):
        _engine(tparams, cfg, role="prefill", draft_params=tparams)
    dec = _engine(tparams, cfg, role="decode")
    with pytest.raises(ValueError):
        dec.submit([1, 2, 3], max_tokens=4)
    pre = _engine(tparams, cfg, role="prefill")
    with pytest.raises(MigrationError):
        pre.submit_migration(PageMigration(object(), None, 0, None, 0.0, {}))
    # the prefill door counts prompt blocks only: a stream longer than
    # the prefill pool holds is admitted there (its decode is elsewhere)
    small = _engine(tparams, cfg, role="prefill", num_blocks=4)
    small.submit([1] * 9, max_tokens=100)
    with pytest.raises(ValueError):
        _engine(tparams, cfg, num_blocks=4).submit([1] * 9, max_tokens=100)


# ---------------------------------------------------------------------------
# handoff: token-exact against the JAX package, pages bit-exact
# ---------------------------------------------------------------------------
def test_handoff_token_exact_against_the_jax_handoff_and_no_leaks(tiny):
    net, cfg, tparams, oracle = tiny
    prompts = _prompts(1, (5, 11, 3), cfg.vocab_size)
    jpre = JaxDecodeEngine(net, max_batch=4, block_size=8, num_blocks=64,
                           role="prefill", prefix_cache=False)
    jdec = JaxDecodeEngine(net, max_batch=4, block_size=8, num_blocks=64,
                           role="decode", prefix_cache=False)
    pre = _engine(tparams, cfg, max_batch=4, role="prefill",
                  prefix_cache=False)
    dec = _engine(tparams, cfg, max_batch=4, role="decode",
                  prefix_cache=False)
    both = _engine(tparams, cfg, max_batch=4)
    jreqs = [jpre.submit(p, max_tokens=10) for p in prompts]
    reqs = [pre.submit(p, max_tokens=10) for p in prompts]
    kw = dict(temperature=0.8, top_k=7, seed=99)
    sreq = pre.submit(prompts[1], max_tokens=10, **kw)
    sboth = both.submit(prompts[1], max_tokens=10, **kw)
    jpre.submit(prompts[1], max_tokens=10, **kw)
    _handoff_all(jpre, jdec)
    _drain(jdec)
    _handoff_all(pre, dec)
    _drain(dec)
    both.run_until_idle()
    for p, r, jr in zip(prompts, reqs, jreqs):
        got = r.future.result(timeout=5).tokens
        assert got == jr.future.result(timeout=5).tokens == oracle(p, 10)
    assert sreq.future.result(timeout=5).tokens == \
        sboth.future.result(timeout=5).tokens
    # the phase contract: the prefill engine never decoded
    assert pre.stats()["dispatches"] == 0 and dec.stats()["dispatches"] > 0
    for eng in (pre, dec):
        assert _empty(eng)
    assert pre._kv.allocator.stats() == jpre._kv.allocator.stats()
    assert dec._kv.allocator.stats() == jdec._kv.allocator.stats()
    assert pre._kv.allocator.exported_blocks == \
        dec._kv.allocator.imported_blocks > 0
    assert int(dec._c_migrations.collect(materialize=False)) == 4
    assert int(pre._c_migrations.collect(materialize=False)) == 0
    assert dec._h_migration.collect()["count"] == 4
    assert int(dec._c_migrated_blocks.collect()) == \
        dec._kv.allocator.imported_blocks


def test_migrated_pages_are_bit_equal_to_the_source_pages(tiny):
    _, cfg, tparams, _ = tiny
    pre = _engine(tparams, cfg, role="prefill", prefix_cache=False)
    dec = _engine(tparams, cfg, role="decode", prefix_cache=False)
    prompt = _prompts(2, (21,), cfg.vocab_size)[0]
    pre.submit(prompt, max_tokens=4)
    migs = []
    while not migs:
        pre.step()
        migs = pre.pop_ready_migrations()
    mig = migs[0]
    assert mig.nb == 3 and tuple(mig.kv.shape[2:3]) == (3,)
    # the source blocks are exported already; the ticket owns a copy
    src = mig.kv.clone()
    dec.submit_migration(mig)
    dec._drain_migration_inbox()
    req = mig.request
    got = dec._kv.pool[:, :, req.blocks]
    assert torch.equal(got, src)
    slot = req.slot
    assert list(dec._tables[slot, :3]) == req.blocks
    assert int(dec._lengths[slot]) == len(prompt)
    _drain(dec)
    assert _empty(pre) and _empty(dec)


def test_handoff_with_both_engines_pinned_to_the_cpu(tiny):
    """The JAX package pins each phase replica to its own device; the
    port's one-card counterpart pins both to a device explicitly, here
    the CPU."""
    _, cfg, tparams, oracle = tiny
    pre = _engine(tparams, cfg, role="prefill", prefix_cache=False,
                  device=torch.device("cpu"))
    dec = _engine(tparams, cfg, role="decode", prefix_cache=False,
                  device="cpu")
    assert pre._kv.pool.device == dec._kv.pool.device == torch.device("cpu")
    p = _prompts(11, (9,), cfg.vocab_size)[0]
    r1 = pre.submit(p, max_tokens=8)
    r2 = pre.submit(p, max_tokens=8, temperature=0.7, top_k=5, seed=123)
    both = _engine(tparams, cfg)
    r3 = both.submit(p, max_tokens=8, temperature=0.7, top_k=5, seed=123)
    _handoff_all(pre, dec)
    _drain(dec)
    both.run_until_idle()
    assert r1.future.result(timeout=5).tokens == oracle(p, 8)
    assert r2.future.result(timeout=5).tokens == \
        r3.future.result(timeout=5).tokens
    assert dec._kv.pool.device == torch.device("cpu")


def test_prefix_chains_preserved_across_migration(tiny):
    net, cfg, tparams, oracle = tiny
    pre = _engine(tparams, cfg, role="prefill", prefix_cache=True,
                  prefill_chunk=8)
    dec = _engine(tparams, cfg, role="decode", prefix_cache=True)
    jpre = JaxDecodeEngine(net, max_batch=2, block_size=8, num_blocks=64,
                           role="prefill", prefix_cache=True,
                           prefill_chunk=8)
    jdec = JaxDecodeEngine(net, max_batch=2, block_size=8, num_blocks=64,
                           role="decode", prefix_cache=True)
    rng = np.random.RandomState(3)
    shared = rng.randint(0, cfg.vocab_size, (16,)).tolist()
    p1 = shared + rng.randint(0, cfg.vocab_size, (5,)).tolist()
    p2 = shared + rng.randint(0, cfg.vocab_size, (3,)).tolist()
    for a, b in ((pre, dec), (jpre, jdec)):
        r1 = a.submit(p1, max_tokens=6)
        _handoff_all(a, b)
        hits0 = a._prefix.hits
        r2 = a.submit(p2, max_tokens=6)
        _handoff_all(a, b)
        _drain(b)
        assert r1.future.result(timeout=5).tokens == oracle(p1, 6)
        assert r2.future.result(timeout=5).tokens == oracle(p2, 6)
        assert a._prefix.hits > hits0
        assert a._prefix.cached_blocks > 0 and a._prefix.live_refs == 0
        assert b._prefix.cached_blocks > 0 and b._prefix.live_refs == 0
    assert pre._prefix.stats() == jpre._prefix.stats()
    assert dec._prefix.stats() == jdec._prefix.stats()
    assert pre._kv.allocator.stats() == jpre._kv.allocator.stats()
    assert dec._kv.allocator.stats() == jdec._kv.allocator.stats()


def test_double_import_refused_at_the_engine_door(tiny):
    _, cfg, tparams, _ = tiny
    pre = _engine(tparams, cfg, role="prefill", num_blocks=32)
    dec = _engine(tparams, cfg, role="decode", num_blocks=32)
    req = pre.submit([1, 2, 3, 4, 5], max_tokens=4)
    migs = []
    for _ in range(50):
        pre.step()
        migs += pre.pop_ready_migrations()
        if migs:
            break
    assert len(migs) == 1
    dec.submit_migration(migs[0])
    _drain(dec)
    assert req.future.result(timeout=5) is not None
    with pytest.raises(MigrationError):
        dec.submit_migration(migs[0])


def test_max_tokens_one_finishes_on_the_prefill_side(tiny):
    _, cfg, tparams, oracle = tiny
    pre = _engine(tparams, cfg, role="prefill")
    p = _prompts(6, (7,), cfg.vocab_size)[0]
    r = pre.submit(p, max_tokens=1)
    pre.run_until_idle()
    assert pre.pop_ready_migrations() == []
    assert r.future.result(timeout=5).tokens == oracle(p, 1)
    assert _empty(pre)


# ---------------------------------------------------------------------------
# reservation discount (role both, as in the JAX file)
# ---------------------------------------------------------------------------
def test_reserve_discount_admits_shared_prompts_exactly(tiny):
    _, cfg, tparams, oracle = tiny
    eng = _engine(tparams, cfg, max_batch=4, prefix_cache=True,
                  prefill_chunk=8, prefix_reserve_discount=True)
    rng = np.random.RandomState(5)
    shared = rng.randint(0, cfg.vocab_size, (24,)).tolist()
    p1, p2 = shared + [7], shared + [11]
    r1 = eng.submit(p1, max_tokens=6)
    eng.run_until_idle()
    r2 = eng.submit(p2, max_tokens=6)
    for _ in range(5):
        eng.step()
        if r2.reserved_blocks:
            break
    worst = r2.worst_case_blocks(eng.block_size)
    assert r2.reserved_blocks < worst and r2.block_budget == worst
    assert eng._kv.allocator.pinned > 0
    eng.run_until_idle()
    assert r1.future.result(timeout=5).tokens == oracle(p1, 6)
    assert r2.future.result(timeout=5).tokens == oracle(p2, 6)
    st = eng._kv.allocator.stats()
    assert st["reserved"] == 0 and st["pinned"] == 0


def test_reserve_discount_envelope_refuses_overdemand():
    for a in (BlockAllocator(11), jkv.BlockAllocator(11)):
        assert a.reserve(2)
        a.pin(4)
        assert a.reserved + 5 <= a.capacity
        assert not a.reserve(5)
        assert a.reserve(4)


# ---------------------------------------------------------------------------
# router: phase knobs, failover, round-trip
# ---------------------------------------------------------------------------
class _StubEngine:
    def __init__(self):
        reg = tmetrics.registry()
        self.scheduler = type("S", (), {"queue_depth": 0})()
        self.active_count = 0
        self.pending_migrations = 0
        self._h_latency = reg.histogram("serving_latency_s",
                                        labels={"engine": "stub"})
        self._h_intertoken = reg.histogram("serving_intertoken_s",
                                           labels={"engine": "stub"})


class _StubServer:
    def __init__(self, role="both"):
        self.role = role
        self.running = True
        self.engine = _StubEngine()
        self.closed = False

    def close(self, unregister_metrics=False):
        self.closed = True
        self.running = False


def test_router_phase_refuses_wrong_role_replicas():
    built = []

    def factory():
        s = _StubServer(role="both")
        built.append(s)
        return s
    with pytest.raises(ValueError, match="refused"):
        ServingRouter(factory, phase="decode", decision_interval_s=0)
    assert built and built[0].closed
    with pytest.raises(ValueError):
        ServingRouter(factory, phase="training", decision_interval_s=0)
    r = ServingRouter(lambda: _StubServer("prefill"), phase="prefill",
                      decision_interval_s=0)
    assert r.num_replicas == 1
    with pytest.raises(ValueError):
        r.submit_migration(object())
    r.close()


def test_router_config_round_trip_refuses_unknown_knobs():
    r = ServingRouter(lambda: _StubServer("decode"), phase="decode",
                      min_replicas=1, max_replicas=3, slo_p99_s=0.25,
                      decision_interval_s=0)
    cfg = r.to_config()
    assert cfg["phase"] == "decode" and cfg["slo_p99_s"] == 0.25
    assert set(cfg) == set(ServingRouter.CONFIG_KNOBS)
    r.close()
    r2 = ServingRouter.from_config(cfg, lambda: _StubServer("decode"),
                                   decision_interval_s=0)
    assert r2.to_config()["slo_p99_s"] == 0.25
    assert r2.to_config()["phase"] == "decode"
    r2.close()
    with pytest.raises(ValueError, match="refused"):
        ServingRouter.from_config(dict(cfg, slo_p99=0.25),
                                  lambda: _StubServer("decode"))


def test_decode_phase_router_refuses_prompts():
    r = ServingRouter(lambda: _StubServer("decode"), phase="decode",
                      decision_interval_s=0)
    with pytest.raises(ValueError, match="submit_migration"):
        r.submit([1, 2], max_tokens=2)
    r.close()


def test_decode_full_fails_over_to_next_replica(tiny):
    _, cfg, tparams, oracle = tiny
    pre = _engine(tparams, cfg, role="prefill")
    decs = [_engine(tparams, cfg, max_batch=1, num_blocks=32,
                    role="decode") for _ in range(2)]
    prompts = _prompts(9, (6, 6), cfg.vocab_size)
    reqs = [pre.submit(p, max_tokens=8) for p in prompts]
    for _ in range(100):
        busy = pre.step()
        for mig in pre.pop_ready_migrations():
            try:
                decs[0].submit_migration(mig)
            except QueueFull:
                decs[1].submit_migration(mig)
        if not busy:
            break
    for d in decs:
        _drain(d)
    for p, r in zip(prompts, reqs):
        assert r.future.result(timeout=5).tokens == oracle(p, 8)
    assert all(d._kv.allocator.imported_blocks > 0 for d in decs)


def _servers(tparams, cfg, **kw):
    base = dict(params=tparams, gpt_config=cfg, block_size=8,
                num_blocks=64, device="cpu")
    base.update(kw)
    return lambda: LLMServer(**base)


def test_disagg_prefill_death_readmits_from_prompt(tiny):
    _, cfg, tparams, oracle = tiny
    router = DisaggRouter(
        _servers(tparams, cfg, max_batch=2, role="prefill",
                 prefill_chunk=8),
        _servers(tparams, cfg, max_batch=4, role="decode"),
        prefill_pool={"min_replicas": 2, "max_replicas": 2,
                      "decision_interval_s": 0},
        decode_pool={"decision_interval_s": 0})
    try:
        prompts = _prompts(11, (40,) * 4, cfg.vocab_size)
        futs = [router.submit(p, max_tokens=6) for p in prompts]
        sfut = router.submit(prompts[0], max_tokens=6, temperature=0.7,
                             top_k=5)
        router.prefill.replicas[0].close()
        for p, f in zip(prompts, futs):
            assert f.result(timeout=60).tokens == oracle(p, 6)
        assert len(sfut.result(timeout=60).tokens) == 6
        st = router.stats()
        assert st["pending_handoffs"] == 0 and st["decode_replicas"] == 1
    finally:
        router.close()


def test_disagg_router_token_exact_and_drains(tiny):
    """Mixed long and short traffic through the whole pipeline (the JAX
    file's mixed-load case at a smaller size): greedy tokens equal the
    JAX oracle, seeded sampled ones the port's role-both engine, both
    pools drain clean and the parked tickets are placed."""
    _, cfg, tparams, oracle = tiny
    router = DisaggRouter(
        _servers(tparams, cfg, max_batch=4, num_blocks=128, role="prefill",
                 prefill_chunk=16, prefix_cache=True),
        _servers(tparams, cfg, max_batch=2, num_blocks=128, role="decode",
                 prefix_cache=True),
        prefill_pool={"decision_interval_s": 0},
        decode_pool={"decision_interval_s": 0}, retry_interval_s=0.005)
    both = _engine(tparams, cfg, max_batch=4, num_blocks=128)
    try:
        prompts = _prompts(13, (5, 48, 9, 100, 17, 33), cfg.vocab_size)
        futs, want, sampled = [], [], []
        for i, p in enumerate(prompts):
            if i % 3 == 2:
                kw = dict(temperature=0.9, top_k=9, seed=1000 + i)
                futs.append(router.submit(p, max_tokens=8, **kw))
                sampled.append(both.submit(p, max_tokens=8, **kw))
                want.append(None)
            else:
                futs.append(router.submit(p, max_tokens=8))
                want.append(oracle(p, 8))
        both.run_until_idle()
        got = [f.result(timeout=120).tokens for f in futs]
        for g, w in zip(got, want):
            if w is not None:
                assert g == w
        assert [g for g, w in zip(got, want) if w is None] == \
            [r.future.result(timeout=0).tokens for r in sampled]
        assert router.pending_handoffs == 0
        pre = router.prefill.replicas[0].engine
        dec = router.decode.replicas[0].engine
        assert pre.stats()["dispatches"] == 0
        assert dec._kv.allocator.stats()["reserved"] == 0
        assert pre._kv.allocator.stats()["reserved"] == 0
        assert int(dec._c_migrations.collect()) == len(prompts)
        cfg_out = router.to_config()
        assert cfg_out["prefill_pool"]["phase"] == "prefill"
        assert cfg_out["decode_pool"]["phase"] == "decode"
        rounds = router.control_round()
        assert rounds["handoffs_placed"] == 0
        assert rounds["decode"]["decision"] == "hold"
    finally:
        router.close()


def test_disagg_parks_tickets_when_the_decode_pool_is_full(tiny):
    _, cfg, tparams, oracle = tiny
    router = DisaggRouter(
        _servers(tparams, cfg, max_batch=4, role="prefill"),
        _servers(tparams, cfg, max_batch=1, role="decode"),
        prefill_pool={"decision_interval_s": 0},
        decode_pool={"decision_interval_s": 0}, retry_interval_s=0)
    try:
        eng = router.decode.replicas[0].engine
        drain = eng._drain_migration_inbox
        eng._drain_migration_inbox = lambda: None  # the inbox holds
        prompts = _prompts(14, (5, 7, 9), cfg.vocab_size)
        futs = [router.submit(p, max_tokens=4) for p in prompts]
        deadline = time.monotonic() + 60
        while router.pending_handoffs < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert router.pending_handoffs == 2      # one in the inbox
        assert eng.pending_migrations == 1
        shed = router.decode._c_shed.collect()
        assert router.pump_pending() == 0        # still full
        assert router.decode._c_shed.collect() == shed + 2
        eng._drain_migration_inbox = drain
        while router.pending_handoffs and time.monotonic() < deadline:
            router.pump_pending()
            time.sleep(0.01)
        for p, f in zip(prompts, futs):
            assert f.result(timeout=60).tokens == oracle(p, 4)
    finally:
        router.close()
    with pytest.raises(RuntimeError):
        router.submit([1], max_tokens=2)


# ---------------------------------------------------------------------------
# server-level handoff plumbing
# ---------------------------------------------------------------------------
def test_server_parks_handoffs_without_hook(tiny):
    _, cfg, tparams, oracle = tiny
    pre = _servers(tparams, cfg, max_batch=2, num_blocks=32,
                   role="prefill")()
    dec = _servers(tparams, cfg, max_batch=2, num_blocks=32,
                   role="decode")()
    try:
        assert (pre.role, dec.role) == ("prefill", "decode")
        p = [3, 1, 4, 1, 5]
        fut = pre.submit(p, max_tokens=5)
        deadline = time.monotonic() + 30
        migs = []
        while not migs and time.monotonic() < deadline:
            migs = pre.pop_handoffs()
            time.sleep(0.01)
        assert len(migs) == 1
        dec.submit_migration(migs[0])
        assert fut.result(timeout=30).tokens == oracle(p, 5)
    finally:
        pre.close()
        dec.close()


def test_server_handoff_hook_failure_fails_only_that_request(tiny):
    _, cfg, tparams, oracle = tiny
    dec = _servers(tparams, cfg, max_batch=2, role="decode")()
    calls = []

    def hook(mig):
        calls.append(mig)
        if len(calls) == 1:
            raise RuntimeError("no route")
        dec.submit_migration(mig)
    pre = _servers(tparams, cfg, max_batch=2, role="prefill",
                   on_handoff=hook)()
    try:
        p = [2, 7, 1, 8]
        bad = pre.submit(p, max_tokens=4)
        with pytest.raises(RuntimeError, match="handoff failed"):
            bad.result(timeout=30)
        assert pre.running
        good = pre.submit(p, max_tokens=4)
        assert good.result(timeout=30).tokens == oracle(p, 4)
    finally:
        pre.close(unregister_metrics=True)
        dec.close()
    want = f'engine="{pre.engine._obs_id}"'
    assert not [i for i in tmetrics.registry().instruments()
                if want in i.key()]


def test_close_fails_tickets_in_flight(tiny):
    _, cfg, tparams, _ = tiny
    dec = _servers(tparams, cfg, max_batch=2, role="decode",
                   auto_start=False)()
    pre = _engine(tparams, cfg, role="prefill")
    r = pre.submit([4, 4, 4], max_tokens=3)
    pre.run_until_idle()
    dec.submit_migration(pre.pop_ready_migrations()[0])
    assert dec.engine.pending_migrations == 1
    dec.close()
    with pytest.raises(RuntimeError, match="closed"):
        r.future.result(timeout=5)
    assert dec.engine.pending_migrations == 0


# ---------------------------------------------------------------------------
# speculation composes with the handoff (tests/test_serving_spec.py:288)
# ---------------------------------------------------------------------------
def test_spec_composes_with_disagg_handoff(tiny):
    _, cfg, tparams, oracle = tiny
    pre = _engine(tparams, cfg, role="prefill")
    dec = _engine(tparams, cfg, role="decode", draft_params=tparams,
                  spec_k=4)
    prompt = _prompts(8, (11,), cfg.vocab_size)[0]
    fut = pre.submit(prompt, max_tokens=9).future
    _handoff_all(pre, dec)
    dec.run_until_idle()
    assert fut.result(timeout=0).tokens == oracle(prompt, 9)
    assert dec.stats()["spec"]["dispatches"] > 0
    for e in (pre, dec):
        st = e._kv.allocator.stats()
        assert st["allocated"] == 0 and st["reserved"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the captured decode graph and the "
                    "engines' streams exist only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_params(tiny, device):
    return params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, dtype=np.float32),
                               jdm.extract_decode_params(tiny[0])),
        device=device)


@pytest.mark.cuda
def test_cuda_import_into_the_captured_decode_graph(tiny, cuda_device):
    """Imports land in the pool the captured step reads: tokens equal
    a role-both engine's on the card (the same kernels and shapes), no
    import captures again, the pool keeps its address, and the prefill
    engine never captures."""
    _, cfg, _, _ = tiny
    kw = dict(params=_cuda_params(tiny, cuda_device), gpt_config=cfg,
              max_batch=4, block_size=16, num_blocks=64, device=cuda_device)
    pre = DecodeEngine(role="prefill", **kw)
    dec = DecodeEngine(role="decode", **kw)
    both = DecodeEngine(**kw)
    pre.warmup([16])
    dec.warmup()
    both.warmup([16])
    assert pre.compile_stats()["decode_captures"] == 0
    assert dec.compile_stats()["decode_captures"] == 2
    ptr = dec._kv.pool.data_ptr()
    prompts = _prompts(21, (5, 17, 40, 29), cfg.vocab_size)
    reqs = [pre.submit(p, max_tokens=12) for p in prompts]
    want = [both.submit(p, max_tokens=12) for p in prompts]
    _handoff_all(pre, dec)
    _drain(dec)
    both.run_until_idle()
    for r, w in zip(reqs, want):
        assert r.future.result(timeout=60).tokens == \
            w.future.result(timeout=60).tokens
    assert dec.compile_stats()["decode_captures"] == 2
    assert dec._kv.pool.data_ptr() == ptr
    assert pre.stream is not None and pre.stream != dec.stream
    assert _empty(pre) and _empty(dec)
    dec.release_graphs()
    both.release_graphs()


@pytest.mark.cuda
def test_cuda_ticket_event_orders_the_scatter_after_the_gather(
        tiny, cuda_device):
    """The ticket's event: the importer's stream waits for the gather
    and for nothing the exporter's stream queued after it.  A first
    migration loads the gather's and the scatter's kernels (a kernel's
    first launch may wait for the whole device)."""
    _, cfg, _, _ = tiny
    kw = dict(params=_cuda_params(tiny, cuda_device), gpt_config=cfg,
              block_size=16, num_blocks=64, device=cuda_device)
    pre = DecodeEngine(max_batch=2, role="prefill", **kw)
    dec = DecodeEngine(max_batch=2, role="decode", **kw)
    first, second = _prompts(22, (33, 35), cfg.vocab_size)
    pre.submit(first, max_tokens=4)
    _handoff_all(pre, dec)
    _drain(dec)
    torch.cuda.synchronize()
    pre.submit(second, max_tokens=4)
    pre.step()
    mig = pre.pop_ready_migrations()[0]
    assert isinstance(mig.ready, torch.cuda.Event)
    with torch.cuda.stream(pre.stream):
        src = mig.kv.clone()
        torch.cuda._sleep(200_000_000)  # keep the exporter's stream busy
    dec.submit_migration(mig)
    with torch.no_grad(), dec._on_stream():
        dec._drain_migration_inbox()
    dec.stream.synchronize()
    assert not pre.stream.query()      # the import did not wait for it
    torch.cuda.synchronize()
    req = mig.request
    assert torch.equal(dec._kv.pool[:, :, req.blocks], src)
    _drain(dec)
    assert _empty(dec)
