"""The ``[B*H, S, D]`` flash configuration of the PyTorch port against
the JAX package: the head-packed forward (``flash_fwd_hpack``, JAX
``_flash_kernel_hpack``) and the single-sweep backward
(``flash_bwd_fused``, JAX ``_flash_bwd_fused_kernel``), selected by
``PADDLE_TORCH_FLASH_NO_PACKED/HEADPACK/FUSED_BWD`` in the port and by
``PADDLE_TPU_FLASH_NO_PACKED/HEADPACK/FUSED_BWD`` in the JAX package,
set side by side.

Inputs are numpy arrays from a seed.  The JAX side runs its Pallas
kernels in interpret mode (``PADDLE_TPU_PALLAS_INTERPRET=1``) with
``PADDLE_TPU_FLASH_BQ=BK=128`` at S=256, so each sweep crosses two
blocks, as ``tests/test_flash_attention.py`` runs the fused backward
and the head-pair kernel; the port runs the wrappers' plain versions on
the CPU.  Tolerances are the JAX package's own for its kernels against
the composed form: 2e-4 relative / 2e-5 absolute on outputs, 5e-4 /
5e-5 on gradients (fp32, blockwise online softmax against whole-row
sums).  The GPT model comparison uses ``tests/test_torch_training.py``'s
2e-5.  The ``cuda``-marked tests hold the CUDA kernels against their
plain versions and against ``flash_fwd`` and the split pair on the card
and skip without one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as jpaddle
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import \
    GPTPretrainingCriterion as JGPTPretrainingCriterion
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.ops import pallas_ops

from paddle_tpu_torch.framework import env_knobs
from paddle_tpu_torch.models import (GPTForCausalLM, GPTPretrainingCriterion,
                                     gpt_tiny, state_dict_from_jax)
from paddle_tpu_torch.nn.functional import flash_attention
from paddle_tpu_torch.ops import flash_attention_kernel as fk
from torch_parity_helpers import torch_one_thread  # noqa: F401

OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
MODEL_TOL = 2e-5
KNOBS = ("NO_PACKED", "HEADPACK", "FUSED_BWD")


def _set_knobs(monkeypatch, no_packed=True, hp=1, fused=False):
    """The JAX package's knobs and the port's, side by side (unset =
    off; the JAX package turns a flag on for any non-empty value)."""
    values = {"NO_PACKED": "1" if no_packed else None,
              "HEADPACK": str(hp) if hp != 1 else None,
              "FUSED_BWD": "1" if fused else None}
    for name in KNOBS:
        for prefix in ("PADDLE_TPU_FLASH_", "PADDLE_TORCH_FLASH_"):
            if values[name] is None:
                monkeypatch.delenv(prefix + name, raising=False)
            else:
                monkeypatch.setenv(prefix + name, values[name])


@pytest.fixture()
def interpret(monkeypatch):
    """JAX kernels in interpret mode over 128-row blocks; the one-time
    kernel probe taken eagerly so it cannot fail inside a trace."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BQ", "128")
    monkeypatch.setenv("PADDLE_TPU_FLASH_BK", "128")
    pallas_ops._PALLAS_HEALTH.pop("ok", None)
    assert pallas_ops._pallas_healthy()


def _inputs(seed, b=2, s=256, h=4, d=64):
    rng = np.random.default_rng(seed)
    q, k, v = [(rng.standard_normal((b, s, h, d)) * 0.5).astype(np.float32)
               for _ in range(3)]
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, g


def _jax(q, k, v, g, causal, seg=None):
    def f(q_, k_, v_):
        return pallas_ops.flash_attention.raw(q_, k_, v_, causal=causal,
                                              segment_ids=seg)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port(q, k, v, g, causal, seg=None, kv_seg=None):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
    fk.reset_counts()
    out, _ = flash_attention(
        *ts, causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        kv_segment_ids=None if kv_seg is None else torch.from_numpy(kv_seg))
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _compare(q, k, v, g, causal, seg=None):
    ref, rgrads = _jax(q, k, v, g, causal, seg)
    out, grads = _port(q, k, v, g, causal, seg)
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, **OUT_TOL)
    for name, a, b in zip("qkv", grads, rgrads):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)
    return out, grads


def _plain_calls():
    return {f.__name__: f.plain_calls for f in fk.ALL_WRAPPERS}


COMBOS = {"split": (1, False), "hpack": (2, False), "fused": (1, True),
          "hpack+fused": (2, True)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("combo", list(COMBOS))
def test_public_flash_attention_matches_jax_in_every_combination(
        interpret, monkeypatch, combo, causal):
    hp, fused = COMBOS[combo]
    _set_knobs(monkeypatch, hp=hp, fused=fused)
    _compare(*_inputs(0), causal=causal)
    calls = _plain_calls()
    assert calls["flash_fwd_hpack" if hp > 1 else "flash_fwd"] == 1
    assert calls["flash_bwd_fused"] == (1 if fused else 0)
    assert calls["flash_bwd_dq"] == calls["flash_bwd_dkv"] == \
        (0 if fused else 1)


@pytest.mark.parametrize("case", ["hp=4", "odd H straddles batches",
                                  "D=16", "D=32"])
def test_head_packing_shapes_match_jax(interpret, monkeypatch, case):
    kw, hp = {"hp=4": (dict(b=1, h=4), 4),
              "odd H straddles batches": (dict(b=2, h=3), 2),
              "D=16": (dict(d=16), 2), "D=32": (dict(d=32), 2)}[case]
    _set_knobs(monkeypatch, hp=hp, fused=True)
    _compare(*_inputs(1, **kw), causal=True)
    assert _plain_calls()["flash_fwd_hpack"] == 1


def test_segment_ids_and_empty_rows_through_the_fused_backward(
        interpret, monkeypatch):
    """Segment ids keep the forward off the head-packed kernel (as in
    the JAX package) and run through the fused backward; a query whose
    segment matches no key gets 0 output and 0 gradient, never NaN."""
    _set_knobs(monkeypatch, hp=2, fused=True)
    q, k, v, g = _inputs(2)
    seg = np.repeat(np.arange(4, dtype=np.int32), 64)[None].repeat(2, 0)
    seg[1] = np.repeat(np.array([0, 1], np.int32), 128)
    _compare(q, k, v, g, True, seg)
    assert _plain_calls()["flash_fwd"] == 1
    assert _plain_calls()["flash_bwd_fused"] == 1
    qseg = np.zeros((2, 256), np.int32)
    qseg[:, 130] = 9                        # no key carries segment 9
    out, grads = _port(q, k, v, g, False, qseg, np.zeros_like(qseg))
    assert np.isfinite(out).all() and all(np.isfinite(x).all()
                                          for x in grads)
    assert (out[:, 130] == 0).all() and (grads[0][:, 130] == 0).all()


@pytest.mark.parametrize("case,want", [
    ("D=128 takes flash_fwd", "flash_fwd"),
    ("segment ids take flash_fwd", "flash_fwd"),
    ("odd B*H takes flash_fwd", "flash_fwd"),
    ("D=64 even B*H takes flash_fwd_hpack", "flash_fwd_hpack"),
])
def test_dispatch_follows_the_jax_head_pack_rule(monkeypatch, case, want):
    _set_knobs(monkeypatch, hp=2, fused=True)
    shape = {"D=128": (2, 16, 4, 128), "odd B": (1, 16, 3, 64)}
    b, s, h, d = next((v for key, v in shape.items() if key in case),
                      (2, 16, 4, 64))
    q, k, v, g = _inputs(3, b=b, s=s, h=h, d=d)
    seg = np.zeros((b, s), np.int32) if "segment" in case else None
    _port(q, k, v, g, True, seg)
    calls = _plain_calls()
    assert calls[want] == 1
    assert calls["flash_fwd_hpack" if want == "flash_fwd" else
                 "flash_fwd"] == 0
    assert (calls["flash_bwd_fused"], calls["flash_bwd_dq"]) == (1, 0)


@pytest.mark.parametrize("raw", ["0", "false", "off", "no", ""])
def test_knobs_parse_strictly_and_leave_the_default_path(monkeypatch, raw):
    """The port's bools are off for "0" (the JAX package's ``get_raw``
    reads would turn them on); HEADPACK and FUSED_BWD do nothing without
    NO_PACKED."""
    _set_knobs(monkeypatch, hp=2, fused=True)
    monkeypatch.setenv("PADDLE_TORCH_FLASH_NO_PACKED", raw)
    _port(*_inputs(4, s=16), causal=True)
    assert _plain_calls() == {"flash_fwd": 1, "flash_bwd_dq": 1,
                              "flash_bwd_dkv": 1, "flash_fwd_hpack": 0,
                              "flash_bwd_fused": 0}


def test_bh_path_equals_the_default_path_on_the_cpu(monkeypatch):
    q, k, v, g = _inputs(5, s=40, h=3)
    _set_knobs(monkeypatch, no_packed=False)
    ref, rgrads = _port(q, k, v, g, True)
    _set_knobs(monkeypatch, hp=1, fused=True)
    out, grads = _port(q, k, v, g, True)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    for a, b in zip(grads, rgrads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_gpt_tiny_loss_and_every_gradient_match_jax_under_the_knobs(
        interpret, monkeypatch):
    _set_knobs(monkeypatch, hp=2, fused=True)
    jpaddle.seed(0)
    jnet = JGPTForCausalLM(jgpt_tiny(max_position_embeddings=256))
    cfg = gpt_tiny(max_position_embeddings=256)
    net = GPTForCausalLM(cfg, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net.load_state_dict(state_dict_from_jax(state, cfg))
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (2, 128)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    y[0, :5] = -100
    jloss = JGPTPretrainingCriterion()(jnet(jpaddle.to_tensor(x)),
                                       jpaddle.to_tensor(y))
    jloss.backward()
    fk.reset_counts()
    loss = GPTPretrainingCriterion()(net(torch.from_numpy(x)),
                                     torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(np.asarray(jloss.numpy())),
                               rtol=MODEL_TOL)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in
              jnet.named_parameters()}
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], rtol=MODEL_TOL,
                                   atol=MODEL_TOL, err_msg=n)
    # two layers, each through the head-packed forward and fused backward
    assert [f.plain_calls for f in fk.ALL_WRAPPERS] == [0, 0, 0, 2, 2]


def test_fused_plain_version_equals_the_split_pair_in_fp32():
    q, k, v, g = [torch.from_numpy(a) for a in _inputs(7, s=96, h=2)]
    out, lse = fk.flash_fwd(q, k, v, True)
    dq, dk, dv = fk.flash_bwd_fused(q, k, v, out, lse, g, True)
    sdq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, True)
    sdk, sdv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, True)
    for a, b in ((dq, sdq), (dk, sdk), (dv, sdv)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_fused_plain_version_rounds_where_the_jax_kernel_rounds():
    """In bf16, p is rounded before P^T dO and dS before dS^T Q and dS K
    (pallas_ops.py:454-466), as the split pair's plain versions round
    them (``_dsoftmax``): dv is exactly the product of the rounded p."""
    q, k, v, g = [torch.from_numpy(a).bfloat16() for a in _inputs(8, s=64)]
    out, lse = fk.flash_fwd(q, k, v, False)
    dq, dk, dv = fk.flash_bwd_fused(q, k, v, out, lse, g, False)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    p = fk._probs(q, k, lse, False, None, None, 0.125)
    want = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), g.float())
    torch.testing.assert_close(dv.float(), want.bfloat16().float(), rtol=0,
                               atol=0)


def test_hpack_wrapper_checks_its_arguments(monkeypatch):
    q = torch.zeros(1, 8, 3, 64)
    with pytest.raises(ValueError, match="divide"):
        fk.flash_fwd_hpack(q, q, q, 2, True)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: torch.device("cuda", 0)))
    q = torch.empty((1, 8, 2, 128))
    with pytest.raises(NotImplementedError, match="hp in"):
        fk.flash_fwd_hpack(q, q, q, 2, True)
    q = torch.empty((1, 8, 3, 64))
    with pytest.raises(NotImplementedError, match="hp in"):
        fk.flash_fwd_hpack(q, q, q, 3, True)


def test_kernel_work_of_the_bh_kernels():
    assert fk.kernel_work("flash_fwd_hpack", 96, 1, 1024, 1024, 64, True,
                          2) == fk.kernel_work("flash_fwd", 96, 1, 1024,
                                               1024, 64, True, 2)
    flops, nbytes = fk.kernel_work("flash_bwd_fused", 96, 1, 1024, 1024, 64,
                                   True, 2)
    pairs = 96 * 1024 * 1025 // 2
    assert flops == 10 * 64 * pairs
    assert nbytes == 8 * 96 * 1024 * 64 * 2 + 96 * 1024 * 4


def test_registry_refuses_unknown_names_and_parses_strictly():
    with pytest.raises(KeyError):
        env_knobs.get_raw("PADDLE_TORCH_FLASH_BQ")
    with pytest.raises(KeyError):
        env_knobs.get_bool("PADDLE_TPU_FLASH_NO_PACKED")
    name = "PADDLE_TORCH_FLASH_FUSED_BWD"
    for raw, want in (("1", True), ("TRUE", True), (" yes ", True),
                      ("on", True), ("0", False), ("off", False),
                      ("2", False), ("", False)):
        assert env_knobs.get_bool(name, env={name: raw}) is want, raw
    assert env_knobs.get_bool(name, env={}) is False
    hp = "PADDLE_TORCH_FLASH_HEADPACK"
    assert env_knobs.get_int(hp, 1, env={hp: "4"}) == 4
    assert env_knobs.get_int(hp, 1, env={hp: "x"}) == 1
    assert env_knobs.get_int(hp, 1, env={}) == 1
    assert set(env_knobs.KNOBS) == {"PADDLE_TORCH_FLASH_NO_PACKED",
                                    "PADDLE_TORCH_FLASH_HEADPACK",
                                    "PADDLE_TORCH_FLASH_FUSED_BWD",
                                    "PADDLE_TORCH_FOLD_MAX",
                                    "PADDLE_TORCH_FOLD_OVERHEAD_TARGET",
                                    "PADDLE_TORCH_FOLD_CALIB_GROUPS",
                                    "PADDLE_TORCH_PREFILL_CHUNK",
                                    "PADDLE_TORCH_PREFIX_CACHE",
                                    "PADDLE_TORCH_SERVING_POLL_TARGET",
                                    "PADDLE_TORCH_SERVING_POLL_MAX",
                                    "PADDLE_TORCH_SERVING_POLL_CALIB",
                                    "PADDLE_TORCH_SPEC_K",
                                    "PADDLE_TORCH_TRACE",
                                    "PADDLE_TORCH_TRACE_CAPACITY",
                                    "PADDLE_TORCH_EVENTS_CAPACITY",
                                    "PADDLE_TORCH_FAULT_PLAN",
                                    "PADDLE_TORCH_SYNTH_N"}
    target = "PADDLE_TORCH_FOLD_OVERHEAD_TARGET"
    assert env_knobs.get_float(target, 0.05, env={target: "0.2"}) == 0.2
    assert env_knobs.get_float(target, 0.05, env={target: "x"}) == 0.05
    table = env_knobs.render_table().splitlines()
    assert table[0] == "| Variable | Default | Description |"
    assert len(table) == 2 + len(env_knobs.KNOBS)
    assert all(f"`{n}`" in "\n".join(table) for n in env_knobs.KNOBS)


# ---------------------------------------------------------------------------
# on the card: the two kernels against their plain versions and against
# flash_fwd and the split pair
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,hp,causal", [
    ((2, 200, 3, 200), 2, True),          # odd H: heads straddle batches
    ((1, 96, 4, 160), 4, False),
])
def test_cuda_bh_kernels_match_plain(cuda_device, dtype, tol, shape, hp,
                                     causal):
    B, Sq, H, Sk = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=gen, device=cuda_device).to(dtype)

    q, g = rnd(B, Sq, H, 64), rnd(B, Sq, H, 64)
    k, v = rnd(B, Sk, H, 64), rnd(B, Sk, H, 64)
    if causal:
        k, v = k[:, :Sq], v[:, :Sq]
    fk.reset_counts()
    out, lse = fk.flash_fwd_hpack(q, k, v, hp, causal)
    dq, dk, dv = fk.flash_bwd_fused(q, k, v, out, lse, g, causal)
    assert [f.launches for f in fk.BH_WRAPPERS] == [1, 1]
    ref_out, ref_lse = fk.flash_fwd(q, k, v, causal)
    sdq, delta = fk.flash_bwd_dq(q, k, v, out, lse, g, causal)
    sdk, sdv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    rout, rlse = fk.flash_attention_reference(
        *[t.float() for t in (q, k, v)], causal)
    rgrads = fk.flash_bwd_fused_reference(q, k, v, out, lse, g, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for got, ref in ((out, rout), (lse, rlse), (dq, rgrads[0]),
                     (dk, rgrads[1]), (dv, rgrads[2])):
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol * max(1.0, ref.float().abs().max().item()), err
    if dtype == torch.float32:
        for got, ref in ((dq, sdq), (dk, sdk), (dv, sdv)):
            err = (got - ref).abs().max().item()
            assert err <= 1e-5 * max(1.0, ref.abs().max().item()), err
