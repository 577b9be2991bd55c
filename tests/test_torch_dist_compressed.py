"""The compressed dp path of the port (``distributed/compressed.py`` and
``DistributedRunner``'s explicit dp update) against the JAX package's
(``tests/test_compressed_collectives.py``, ``tests/test_dp_compressed.py``).

- The codec in one process: ``_split16`` / ``_merge16`` lossless (NaN
  and -0 too), ``_block_quant`` / ``_block_dequant`` bit-equal to the JAX
  functions given the JAX uniform draws, the byte model equal to the JAX
  one over a grid.
- A world of four gloo ranks (``torch_dist_workers.compressed_world``):
  ``quantized_all_reduce`` at bits 16 bit-equal to the JAX ring on the
  4-device CPU mesh (the same hop order), at bits 8 small, zero-mean and
  replica-consistent; ``ring_reduce_scatter`` bit-equal to the JAX ring
  at bits 16 (and exact at W = 2, on two-rank groups), within the JAX
  bound at 8; ``bf16_all_reduce`` and ``compressed_psum_tree``'s modes;
  the toy at dp4, its int8 replicas bit-equal and its measured send
  bytes beside the byte model.
- A world of two (``compressed_world2``), the JAX toy's runs at dp2:
  bits 16 and the sharded update bit-identical to the plain path and
  within 5e-4 / 1e-5 of the JAX runner; the sharded clip and
  accumulation within rtol 2e-5 / atol 1e-6; bits 8 within the JAX
  tolerance; optimizer bytes about 1/dp; the registry's
  ``dp_allreduce_bytes_total`` / ``dp_compress_ratio`` equal to the JAX
  values.
- The knobs, the env overrides and the refusals, with the JAX messages,
  in one process.

The JAX package's folded-entry tests (``:140``, ``:267``) wait for the
fold engine's mesh branch (ROADMAP A10).
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.distributed import compressed as C
from torch_dist_workers import TOY_RUNS, shared_world, toy_data
from torch_parity_helpers import torch_one_thread  # noqa: F401

RTOL, ATOL = 5e-4, 1e-5


def _jax_toy_state():
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    jpaddle.seed(0)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    return {k: np.asarray(v.numpy()).copy()
            for k, v in net.state_dict().items()}


def _ring_inputs():
    rng = np.random.RandomState(0)
    return dict(
        ar=rng.randn(4, 8192).astype(np.float32),
        trial=np.random.RandomState(1).randn(4, 4096).astype(np.float32),
        rs=np.random.RandomState(2).randn(4, 24, 5).astype(np.float32),
        rs1=np.random.RandomState(6).randn(4, 3, 8, 5).astype(np.float32),
        rs2=np.random.RandomState(7).randn(4, 12, 5).astype(np.float32),
        bf=np.random.RandomState(2).randn(4, 1024).astype(np.float32),
        g1=np.random.RandomState(3).randn(4, 512).astype(np.float32),
        g2=np.random.RandomState(3).randn(4, 16, 33).astype(np.float32))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return shared_world(tmp_path_factory, "compressed4", "compressed_world",
                        4, lambda: dict(_ring_inputs(),
                                        toy_state=_jax_toy_state()),
                        timeout=240)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return shared_world(tmp_path_factory, "compressed2", "compressed_world2",
                        2, lambda: dict(toy_state=_jax_toy_state()),
                        timeout=240)


# -- the codec ----------------------------------------------------------------
def test_split16_codec_is_lossless():
    x = np.random.RandomState(0).randn(1000).astype(np.float32) * 1e3
    x[:6] = [0.0, -0.0, 1e-38, -1e30, np.nan, -np.inf]
    hi, lo = C._split16(torch.tensor(x))
    assert hi.dtype == lo.dtype == torch.int16
    back = C._merge16(hi, lo).numpy()
    assert back.view(np.uint32).tolist() == x.view(np.uint32).tolist()


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e4])
def test_block_quant_matches_jax_given_its_draws(scale):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import compressed as J
    x = (np.random.RandomState(4).randn(2048) * scale).astype(np.float32)
    x[:256] = 0.0                                  # an all-zero block
    key = jax.random.PRNGKey(7)
    jq, js = J._block_quant(jnp.asarray(x), 256, 8, key)
    noise = np.asarray(jax.random.uniform(key, (8, 256), jnp.float32,
                                          -0.5, 0.5))
    tq, ts = C._block_quant(torch.tensor(x), 256, 8,
                            noise=torch.tensor(noise))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js).astype(np.float32))
    np.testing.assert_array_equal(
        C._block_dequant(tq, ts).numpy(),
        np.asarray(J._block_dequant(jq, js)))


def test_byte_model_matches_jax():
    from paddle_tpu.distributed import compressed as J
    for bits in (0, 8, 16):
        assert C.wire_bits_per_element(bits) == J.wire_bits_per_element(bits)
        assert C.wire_bits_per_element(bits, 128) == \
            J.wire_bits_per_element(bits, 128)
        for n in (1, 255, 4096, 38633472, 124475904):
            for world in (1, 2, 4, 8):
                for shard in (False, True):
                    assert C.dp_comm_bytes_per_step(n, world, bits, shard) \
                        == J.dp_comm_bytes_per_step(n, world, bits, shard)


def test_one_rank_returns_the_input():
    x = torch.randn(10)
    assert C.quantized_all_reduce(x) is x
    assert C.ring_reduce_scatter(x) is x


# -- the rings at W = 4 -------------------------------------------------------
def _jax_rows(fn, per_rank):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.distributed.shard_map_compat import shard_map
    n = per_rank.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    f = shard_map(lambda v: fn(v[0])[None], mesh=mesh, in_specs=P("x"),
                  out_specs=P("x"))
    return np.asarray(f(per_rank))


def test_bits16_ring_is_the_jax_ring(world4):
    from paddle_tpu.distributed import compressed as J
    inputs = _ring_inputs()
    want = _jax_rows(lambda v: J.quantized_all_reduce(v, "x", bits=16),
                     inputs["ar"])
    for r, res in enumerate(world4):
        np.testing.assert_array_equal(res["rings"]["ar16"], want[r])
    # the JAX ring's order is not a plain sum's: the test sees the order
    assert not np.array_equal(want[0], inputs["ar"].sum(0))


def test_int8_ring_error_is_small_zero_mean_and_replica_consistent(world4):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.distributed import compressed as J
    inputs = _ring_inputs()
    want = inputs["ar"].sum(0)
    q, s = J._block_quant(jnp.asarray(want), 256, 8, jax.random.PRNGKey(0))
    floor = np.abs(np.asarray(J._block_dequant(q, s)) - want).mean()
    got = [res["rings"]["ar8"] for res in world4]
    for r, g in enumerate(got):
        assert np.abs(g - want).mean() < 3 * floor, (r, floor)
        np.testing.assert_array_equal(g, got[0])
    per = inputs["trial"]
    errs = np.stack([t - per.sum(0) for t in world4[0]["rings"]["trials"]])
    step = np.abs(per).max() * 4 / 127
    assert np.abs(errs).max() < 4 * step
    assert abs(errs.mean()) < 0.05 * step
    assert world4[0]["rings"]["payload_dtypes"] == ("torch.int8",
                                                    "torch.bfloat16")


def test_ring_reduce_scatter_owns_rank_shard(world4):
    from paddle_tpu.distributed import compressed as J
    inputs = _ring_inputs()
    want16 = _jax_rows(lambda v: J.ring_reduce_scatter(v, "x", 0, bits=16),
                       inputs["rs"])
    total = inputs["rs"].sum(0)
    for r, res in enumerate(world4):
        got = res["rings"]
        np.testing.assert_array_equal(got["rs16"], want16[r])
        np.testing.assert_allclose(got["rs8"], total[6 * r:6 * (r + 1)],
                                   rtol=0.05, atol=0.05 * np.abs(total).max())
        whole = inputs["rs1"].sum(0)
        np.testing.assert_allclose(got["rs16_axis1"],
                                   whole[:, 2 * r:2 * (r + 1)], rtol=1e-6,
                                   atol=1e-6)
        pair = inputs["rs2"][2 * (r // 2):2 * (r // 2) + 2]
        half = r % 2
        np.testing.assert_array_equal(got["rs16_w2"],
                                      pair.sum(0)[6 * half:6 * (half + 1)])


def test_bf16_allreduce_and_tree_modes(world4):
    inputs = _ring_inputs()
    np.testing.assert_allclose(world4[0]["rings"]["bf16"],
                               inputs["bf"].sum(0), rtol=2e-2, atol=2e-2)
    g1, g2 = inputs["g1"].sum(0), inputs["g2"].sum(0)
    for mode in ("none", "bf16", "int8", "exact16"):
        tree = world4[0]["rings"]["tree"][mode]
        tol = 0.0 if mode in ("none", "exact16") else 0.05
        for got, want in ((tree["a"], g1), (tree["b"], g2)):
            np.testing.assert_allclose(
                got, want, rtol=tol + 1e-6,
                atol=tol * np.abs(want).max() + 1e-5, err_msg=mode)


def test_dp4_int8_replicas_are_bit_equal_and_bytes_follow_the_model(world4):
    """Every rank ends the int8 run with the same weights (the owner
    decodes its own payload), and the bytes each rank sends a step are
    the ring's: 2 (W - 1) hops a leaf of its padded chunk in int8 and a
    bf16 scale a block (the byte model's, but for the padding to whole
    blocks, which dominates at the toy's sizes)."""
    for name in ("b8", "sh16", "sh8"):
        for res in world4[1:]:
            for k, v in world4[0][name]["params"].items():
                np.testing.assert_array_equal(res[name]["params"][k], v,
                                              err_msg=f"{name} {k}")
    ref, b8 = world4[0]["ref"], world4[0]["b8"]
    deltas = [np.abs(ref["params"][k] - b8["params"][k]).max()
              for k in ref["params"]]
    assert 0 < max(deltas) < 0.05, deltas
    sent = b8["stats"]["send"]["bytes"] / 3
    ring = 0
    for v in ref["params"].values():
        chunk = -(-v.size // (256 * 4)) * 256
        ring += 2 * 3 * (chunk + 2 * chunk // 256)
    assert sent == ring, (sent, ring)
    assert b8["info"]["bytes_per_step"] <= ring
    assert world4[0]["sh16"]["state_bytes"] * 3 < ref["state_bytes"]


# -- the runner at dp2 --------------------------------------------------------
def _jax_runner(bits, shard, clip=None, acc=1, steps=3):
    import jax
    from paddle_tpu import nn as jnn
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.runner import DistributedRunner as JRunner
    mesh = collective.build_mesh({"dp": 2}, devices=jax.devices()[:2])
    collective.set_mesh(mesh)
    try:
        net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(),
                             jnn.Linear(16, 4))
        net.set_state_dict(_jax_toy_state())
        opt = jopt.Adam(learning_rate=1e-2, parameters=net.parameters(),
                        grad_clip=jnn.ClipGradByGlobalNorm(clip)
                        if clip else None)
        r = JRunner(net, opt, jnn.MSELoss(), mesh=mesh,
                    accumulate_steps=acc, dp_compress_bits=bits,
                    dp_shard_update=shard)
        losses = [float(r.train_step([x], [y]))
                  for x, y in (toy_data(s) for s in range(steps))]
        params = {n: np.asarray(p.numpy())
                  for n, p in net.named_parameters()}
        return losses, params, r
    finally:
        collective.set_mesh(None)


def _equal(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def test_bits16_and_sharded_update_are_the_plain_path_at_dp2(world2):
    ref = world2[0]["ref"]["params"]
    for name in ("b16", "sh", "sh16"):
        for res in world2:
            _equal(res[name]["params"], ref, name)
        assert world2[0][name]["losses"] == world2[0]["ref"]["losses"]


@pytest.mark.parametrize("name", sorted(TOY_RUNS))
def test_runner_matches_the_jax_runner(world2, name):
    bits, shard = TOY_RUNS[name]
    losses, params, _ = _jax_runner(bits, shard)
    got = world2[0][name]
    if bits == 8:
        # the stochastic rounding draws differ: the JAX bound of bits 8
        # against the exact run, on both sides
        _, ref, _ = _jax_runner(0, False)
        for k in ref:
            assert np.abs(got["params"][k] - ref[k]).max() < 0.05, k
            assert np.abs(params[k] - ref[k]).max() < 0.05, k
        return
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL, atol=ATOL)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} {k}")


def test_sharded_update_holds_half_the_optimizer_state(world2):
    full = world2[0]["ref"]["state_bytes"]
    for name in ("sh", "sh16"):
        for res in world2:
            # the moments are halved; each leaf's two beta powers are not
            assert res[name]["state_bytes"] * 2 <= full + 64, \
                (name, res[name]["state_bytes"], full)
    shapes = world2[0]["state_dict"]
    assert shapes and all(sharded for _, sharded in shapes.values())
    assert shapes["0.weight.moment1"][0] == (8, 16)


def test_sharded_clip_and_accumulate_within_tolerance(world2):
    for ref, got in (("refc", "sh16c"), ("refa", "sh16a")):
        a, b = world2[0][ref]["params"], world2[0][got]["params"]
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-5, atol=1e-6,
                                       err_msg=f"{got} {k}")


def test_bits8_within_the_jax_tolerance(world2):
    ref, p8 = world2[0]["ref"]["params"], world2[0]["b8"]["params"]
    deltas = [np.abs(ref[k] - p8[k]).max() for k in ref]
    assert 0 < max(deltas) < 0.05, deltas
    for res in world2[1:]:
        _equal(res["b8"]["params"], p8, "b8 replicas")


def test_dp_comm_metrics_match_jax(world2):
    _, _, jr = _jax_runner(8, True, steps=2)
    got = world2[0]["registry"]
    assert got["info"] == jr._dp_comm_info
    assert got["bytes"] == 2 * jr._dp_comm_info["bytes_per_step"]
    assert got["ratio"] == jr._dp_comm_info["ratio"]
    assert 1.4 < got["ratio"] < 4.1


# -- knobs and refusals (one process) ----------------------------------------
@pytest.fixture
def clean_registry():
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import fleet as tfleet
    yield
    collective.set_mesh(None)
    tfleet._fleet._hcg = None


def _hcg(dims):
    from paddle_tpu_torch.distributed.fleet.base import topology as ttopo
    return ttopo.HybridCommunicateGroup(ttopo.CommunicateTopology(
        ["data", "pipe", "sharding", "sep", "model"], dims), 0)


def _toy(clip=None):
    nn = tpaddle.nn
    net = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                        nn.Linear(16, 4, device="cpu"))
    return net, tpaddle.optimizer.Adam(learning_rate=1e-2,
                                       parameters=net.parameters(),
                                       grad_clip=clip)


def test_knob_env_override_and_validation(monkeypatch, clean_registry):
    from paddle_tpu_torch.distributed import DistributedRunner
    nn = tpaddle.nn
    net, opt = _toy()
    dp2 = _hcg([2, 1, 1, 1, 1])
    monkeypatch.setenv("PADDLE_TPU_DP_COMPRESS", "8")
    monkeypatch.setenv("PADDLE_TPU_DP_SHARD_UPDATE", "1")
    r = DistributedRunner(net, opt, nn.MSELoss(), mesh=dp2,
                          dp_compress_bits=0, dp_shard_update=False)
    assert r._dp_compress_bits == 8 and r._dp_shard_update
    monkeypatch.setenv("PADDLE_TPU_DP_COMPRESS", "7")
    with pytest.raises(ValueError, match="expected 0, 8 or 16"):
        DistributedRunner(*_toy(), nn.MSELoss(), mesh=dp2)
    monkeypatch.setenv("PADDLE_TPU_DP_COMPRESS", "16")
    monkeypatch.setenv("PADDLE_TPU_DP_SHARD_UPDATE", "2")
    with pytest.raises(ValueError, match="expected 0 or 1"):
        DistributedRunner(*_toy(), nn.MSELoss(), mesh=dp2)
    monkeypatch.delenv("PADDLE_TPU_DP_COMPRESS")
    monkeypatch.delenv("PADDLE_TPU_DP_SHARD_UPDATE")
    with pytest.raises(ValueError, match="0 .off., 8"):
        DistributedRunner(*_toy(), nn.MSELoss(), mesh=dp2,
                          dp_compress_bits=12)
    with pytest.raises(ValueError, match="other mesh axis"):
        DistributedRunner(*_toy(), nn.MSELoss(), mesh=_hcg([2, 1, 1, 1, 2]),
                          dp_compress_bits=8)
    net2, opt2 = _toy(clip=nn.ClipGradByNorm(1.0))
    with pytest.raises(ValueError, match="ClipGradByGlobalNorm"):
        DistributedRunner(net2, opt2, nn.MSELoss(), mesh=dp2,
                          dp_shard_update=True)


def test_the_strategy_reaches_the_runner(clean_registry):
    from paddle_tpu_torch.distributed import fleet as tfleet
    s = tfleet.DistributedStrategy()
    s.quantized_allreduce = 16
    s.sharded_weight_update = True
    tfleet.init(is_collective=True, strategy=s)
    runner = tfleet.distributed_runner(*_toy(), tpaddle.nn.MSELoss())
    assert (runner._dp_compress_bits, runner._dp_shard_update) == (16, True)
    assert not runner._dp_explicit        # dp 1: nothing to reduce
