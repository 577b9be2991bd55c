"""The port's distributed checkpoint (``distributed/checkpoint/``), its
retry policy (``distributed/resilience/retry.py``) and the fused LMCE
over a split vocabulary, against the JAX package's tests
(``tests/test_checkpoint_reshard.py``, ``tests/test_checkpoint_manager.py``,
the manager and retry tests of ``tests/test_resilience.py``,
``tests/test_dp_compressed.py:208``).

A world of four gloo ranks (``torch_dist_workers.checkpoint_world``):

- ``gpt_tiny`` from the JAX weights at dp2 x mp2 (AdamW 1e-3, the JAX
  reshard test's recipe), its runner state saved after step 2 and the
  manager saving every second step: four losses against the JAX runner
  on the same layout; resumed in a fresh runner in the same layout (steps
  3-4 and every weight bit-equal), at dp4, in one process (here) and
  under sharding stage 2, each with steps 3-4 within 1e-4 of the
  source's and the weights after step 4 within 5e-4 / 1e-5 (step 4's
  update reads the resharded moments; the moments of fc1, the fused qkv
  and the word embedding loaded at dp4 and in one process are the
  source's joined over mp, bit for bit; the stage-2 chunks hold the
  whole moment's flat range), and from the stage-2 state back into
  dp2 x mp2;
- the manager on the world: one manifest over every rank's files,
  retention, and a torn file on one rank failing the step, which
  ``restore()`` walks past;
- a plain tree saved row-split, loaded column-split;
- the dp4 sharded update (exact ring) resumed bit-identically through
  the manager from an async save, and loaded into an unsharded runner;
- ``enable_fused_lmce`` at mp2 and mp4 (labels at -100 among them):
  three SGD steps' losses and weights against the JAX runner with the
  fused criterion (the JAX reference on the CPU), 5e-4 / 1e-5; the
  composition and its plain version against ``lmce_reference`` on the
  whole vocabulary.

In one process: the manager's interval, retention, round trip, resume,
empty directory, concurrent force saves, manifest and verification,
the scan past a torn step, the async rolling flush, the digest policies,
``rollback_to``, and ``save_on_preemption`` in a subprocess (SIGTERM
saves, a fresh process restores and continues bit-identically); retry.
"""

import glob
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpaddle
from paddle_tpu_torch.distributed.checkpoint import (
    CheckpointManager, Layout, ShardedTensor, load_runner_state,
    load_state_dict, save_runner_state, save_state_dict)
from paddle_tpu_torch.distributed.resilience.retry import (
    RetryExhausted, retry_call, retry_stats)
from torch_dist_workers import shared_world
from torch_parity_helpers import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 5e-4, 1e-5
RESUME_TOL = 1e-4
LEAF = "gpt.layers.1.mlp.fc1.weight"
# the moments held across layouts: fc1 (column split), the fused qkv
# (split on its (3, heads, head_dim) view) and the word embedding
# (vocab rows, tied to the head)
MOMENT_LEAVES = (LEAF, "gpt.layers.1.attn.qkv_proj.weight",
                 "gpt.embeddings.word_embeddings.weight")
LMCE_LR = 0.5


def _jax_gpt_state(seed):
    import paddle_tpu as jpaddle
    from paddle_tpu.models import GPTForCausalLM as JGPT, gpt_tiny
    jpaddle.seed(seed)
    net = JGPT(gpt_tiny())
    return {k: np.asarray(v.numpy()).copy()
            for k, v in net.state_dict().items()}


def _batch():
    x = np.random.RandomState(0).randint(0, 256, (8, 32)).astype(np.int64)
    return x, np.roll(x, -1, axis=1)


def _lmce_batch():
    x, y = _batch()
    y = y.copy()
    y[:, ::7] = -100
    return x, y


def _jax_toy_state(seed):
    import paddle_tpu as jpaddle
    from paddle_tpu import nn as jnn
    jpaddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    return {k: np.asarray(v.numpy()).copy()
            for k, v in net.state_dict().items()}


def checkpoint_ranks(tmp_path_factory):
    """The world's results (computed once a test run) and its checkpoint
    root."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = os.path.join(str(base), "ckpt-world")

    def inputs():
        os.makedirs(root, exist_ok=True)
        return dict(cfg={}, state=_jax_gpt_state(0),
                    other_state=_jax_gpt_state(1), batch=_batch(),
                    lmce_batch=_lmce_batch(), lmce_lr=LMCE_LR, leaf=LEAF,
                    leaves=MOMENT_LEAVES,
                    toy_state=_jax_toy_state(0), toy_other=_jax_toy_state(3),
                    dir=root)

    res = shared_world(tmp_path_factory, "checkpoint", "checkpoint_world", 4,
                       inputs, timeout=300)
    return res, root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return checkpoint_ranks(tmp_path_factory)


def _jax_runner(mesh_axes, steps, fused=False, state=None):
    """The JAX ``DistributedRunner`` on gpt_tiny: losses and the whole
    weights after each step (AdamW 1e-3, or SGD for the fused runs)."""
    import jax
    import paddle_tpu as jpaddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.runner import DistributedRunner as JRunner
    from paddle_tpu.models import (GPTForCausalLM as JGPT,
                                   GPTPretrainingCriterion as JCrit,
                                   enable_fused_lmce, gpt_tiny)
    n = int(np.prod(list(mesh_axes.values())))
    mesh = collective.build_mesh(mesh_axes, devices=jax.devices()[:n])
    collective.set_mesh(mesh)
    try:
        with jpaddle.LazyGuard():
            net = JGPT(gpt_tiny())
        net.set_state_dict(state if state is not None else _jax_gpt_state(0))
        crit = JCrit()
        if fused:
            enable_fused_lmce(net, crit)
            opt = jopt.SGD(learning_rate=LMCE_LR,
                           parameters=net.parameters())
            x, y = _lmce_batch()
        else:
            opt = jopt.AdamW(learning_rate=1e-3, parameters=net.parameters())
            x, y = _batch()
        r = JRunner(net, opt, crit, mesh=mesh)
        losses, states = [], []
        for _ in range(steps):
            losses.append(float(r.train_step([x], [y])))
            r.sync_to_layers()
            states.append({k: np.asarray(v.numpy()).copy()
                           for k, v in net.state_dict().items()})
        return losses, states
    finally:
        collective.set_mesh(None)


# -- reshard on the world ---------------------------------------------------------
def test_dp2mp2_training_matches_jax_and_resumes_in_every_layout(ranks):
    res, root = ranks
    lay = res[0]["layouts"]
    jlosses, _ = _jax_runner({"dp": 2, "mp": 2}, 4)
    for r in res:
        assert r["layouts"]["losses"] == lay["losses"]
    np.testing.assert_allclose(lay["losses"], jlosses, rtol=RTOL, atol=ATOL)
    # (a) the same layout: bit-identical steps 3-4 and weights
    assert lay["same"] == lay["losses"][2:]
    for k, v in lay["state4"].items():
        np.testing.assert_array_equal(lay["same_state"][k], v, err_msg=k)
    # (b) dp4, stage 2: steps 3 and 4 within 1e-4 of the source's, and the
    # weights after step 4 (whose update read the resharded moments)
    # within the JAX bounds of the source's
    for got, state in ((lay["dp4"], lay["dp4_state"]),
                       (lay["stage2"], lay["stage2_state"])):
        for loss, want in zip(got, lay["losses"][2:]):
            assert abs(loss - want) <= RESUME_TOL * abs(want), (
                got, lay["losses"])
        np.testing.assert_allclose(got[0], jlosses[2], rtol=RTOL, atol=ATOL)
        for k, v in lay["state4"].items():
            np.testing.assert_allclose(state[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    assert lay["dp4_step"] == 4
    # the moments dp4 loaded: the source's joined over mp, bit for bit
    for k, v in lay["moment_src"].items():
        np.testing.assert_array_equal(lay["dp4_moments"][k], v, err_msg=k)
    # from the stage-2 state after its step 3, back at dp2 x mp2
    for want in (lay["stage2"][1], lay["losses"][3]):
        assert abs(lay["from_stage2"] - want) <= RESUME_TOL * abs(want)


def test_dp1_resumes_in_one_process(ranks, clean_registry):
    """(c): one process loads the dp2 x mp2 runner state."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         state_dict_from_jax)
    res, root = ranks
    cfg = gpt_tiny()
    net = GPTForCausalLM(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(_jax_gpt_state(1), cfg))
    opt = tpaddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=net.parameters())
    runner = DistributedRunner(net, opt, GPTPretrainingCriterion())
    load_runner_state(runner, os.path.join(root, "src"))
    assert opt._global_step == 2
    lay = res[0]["layouts"]
    for k, v in lay["moment_src"].items():
        leaf, slot = k.rsplit(".", 1)
        got = opt._state[opt._param_names.index(leaf)][slot]
        np.testing.assert_array_equal(got.numpy(), v, err_msg=k)
    for want in lay["losses"][2:]:
        got = runner.train_step(*[[a] for a in _batch()])
        assert abs(got - want) <= RESUME_TOL * abs(want), (got, want)
    for k, v in lay["state4"].items():
        np.testing.assert_allclose(net.state_dict()[k].detach().numpy(), v,
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_stage2_chunks_are_the_new_layouts(ranks):
    """The moments a sharding-4 runner loads are its own flat chunks of
    the whole (mp-joined) moment the dp2 x mp2 source held."""
    res, _ = ranks
    whole = res[0]["layouts"]["moment_src"][f"{LEAF}.moment1"].reshape(-1)
    for r, rk in enumerate(res):
        lay = rk["layouts"]
        chunk = lay["stage2_chunk_len"]
        want = whole[r * chunk:(r + 1) * chunk]
        np.testing.assert_array_equal(lay["stage2_chunk"][:want.size], want)


def test_manager_on_the_world_commits_every_ranks_files(ranks):
    lay = ranks[0][0]["layouts"]
    assert lay["mgr_steps"] == [2, 4]               # interval 2, keep 2
    assert all(lay["mgr_verified"])
    files = lay["mgr_files"]
    for r in range(4):
        assert f"rank{r}.json" in files
    assert "index.json" in files and "objects.pt" in files
    assert sum(f.endswith(".pt") and f.startswith("rank")
               for f in files) >= 2
    # step 4 torn on rank 2's file: unverified, restore walks back to 2
    assert not lay["torn_verified"]
    assert lay["restored"] == 2
    assert lay["after_restore"] == lay["losses"][2:]


def test_plain_tree_reshards(ranks):
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    for r, rk in enumerate(ranks[0]):
        np.testing.assert_array_equal(rk["tree"]["w"][:, 0], w[:, r])
        np.testing.assert_array_equal(rk["tree"]["b"], np.ones(4))
        assert rk["tree"]["step"] == 7


def test_sharded_update_checkpoint_resumes_bit_identically(ranks):
    for rk in ranks[0]:
        sh = rk["shup"]
        assert sh["step"] == 3
        for k, v in sh["ref"].items():
            np.testing.assert_array_equal(sh["resumed"][k], v, err_msg=k)
    # the unsharded runner holds the whole moments: the slices joined
    for k, whole in ranks[0][0]["shup"]["whole"].items():
        got = np.zeros_like(whole)
        for rk in ranks[0]:
            local, segs = rk["shup"]["slices"][k]
            for off, lens, start in segs:
                n = int(np.prod(lens))
                box = tuple(slice(o, o + l) for o, l in zip(off, lens))
                got[box] = local.reshape(-1)[start:start + n].reshape(lens)
        np.testing.assert_array_equal(got, whole, err_msg=k)


@pytest.mark.parametrize("name,mesh", [("mp2", {"dp": 2, "mp": 2}),
                                       ("mp4", {"mp": 4})])
def test_fused_lmce_over_a_split_vocabulary_matches_jax(ranks, name, mesh):
    res, _ = ranks
    got = res[0]["lmce"][name]
    jlosses, jstates = _jax_runner(mesh, 3, fused=True)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=RTOL, atol=ATOL)
    for step, (g, j) in enumerate(zip(got["states"], jstates)):
        for k, v in j.items():
            np.testing.assert_allclose(g[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} {k}")
    for rk in res[1:]:
        assert rk["lmce"][name]["losses"] == got["losses"]
    # the wrappers ran (their plain versions, on the CPU)
    assert all(v == 3 for v in got["plain_calls"].values()), got
    comp = got["composition"]
    for kind in ("kernel", "plain"):
        for k in ("loss", "dh", "dw"):
            np.testing.assert_allclose(comp[kind][k], comp["whole"][k],
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {kind} {k}")


def test_both_packages_resume_from_the_jax_runners_state(
        tmp_path, clean_registry):
    """The JAX runner's weights and optimizer slots after two steps
    (``optimizer_state_from_jax``), carried into the port's runner, which
    saves and reloads them through its checkpoint: step 3 on both sides
    within 5e-4 / 1e-5."""
    import jax
    import paddle_tpu as jpaddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.distributed import collective
    from paddle_tpu.distributed.runner import DistributedRunner as JRunner
    from paddle_tpu.models import (GPTForCausalLM as JGPT,
                                   GPTPretrainingCriterion as JCrit,
                                   gpt_tiny as jgpt_tiny)
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed.checkpoint import \
        optimizer_state_from_jax
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         state_dict_from_jax)
    x, y = _batch()
    mesh = collective.build_mesh({"dp": 1}, devices=jax.devices()[:1])
    collective.set_mesh(mesh)
    try:
        with jpaddle.LazyGuard():
            jnet = JGPT(jgpt_tiny())
        jnet.set_state_dict(_jax_gpt_state(0))
        jr = JRunner(jnet, jopt.AdamW(learning_rate=1e-3,
                                      parameters=jnet.parameters()),
                     JCrit(), mesh=mesh)
        for _ in range(2):
            jr.train_step([x], [y])
        jr.sync_to_layers()
        weights = {k: np.asarray(v.numpy()).copy()
                   for k, v in jnet.state_dict().items()}
        slots = {n: {k: np.asarray(v) for k, v in st.items()}
                 for n, st in jr._opt_state.items()}
        step = int(jr.optimizer._global_step)
        want = float(jr.train_step([x], [y]))
    finally:
        collective.set_mesh(None)
    cfg = gpt_tiny()
    net = GPTForCausalLM(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(weights, cfg))
    opt = tpaddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=net.parameters())
    runner = DistributedRunner(net, opt, GPTPretrainingCriterion())
    opt.set_state_dict(optimizer_state_from_jax(slots, step))
    assert opt._global_step == 2 and len(opt._state) == len(slots)
    save_runner_state(runner, str(tmp_path / "s"))
    net2 = GPTForCausalLM(cfg, device="cpu")
    opt2 = tpaddle.optimizer.AdamW(learning_rate=1e-3,
                                   parameters=net2.parameters())
    runner2 = DistributedRunner(net2, opt2, GPTPretrainingCriterion())
    load_runner_state(runner2, str(tmp_path / "s"))
    got = runner2.train_step([x], [y])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- one process ----------------------------------------------------------------
@pytest.fixture
def clean_registry():
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed import fleet as tfleet
    yield
    collective.set_mesh(None)
    tfleet._fleet._hcg = None


class _Net(tpaddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tpaddle.nn.Linear(4, 2, device="cpu")

    def forward(self, x):
        return self.fc(x)


def _net(seed=0):
    tpaddle.seed(seed)
    net = _Net()
    return net, tpaddle.optimizer.Adam(1e-2, parameters=net.parameters())


def _train(net, opt, n, seed=0):
    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(n):
        x = torch.tensor(rng.rand(8, 4).astype(np.float32))
        y = torch.tensor(rng.rand(8, 2).astype(np.float32))
        loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    return losses


def _weight(net):
    return net.fc.weight.detach().numpy().copy()


def test_interval_and_retention(tmp_path):
    net, opt = _net()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_interval_steps=2,
                            max_to_keep=2, async_save=False)
    for step in range(1, 7):
        _train(net, opt, 1, seed=step)
        mgr.save(step, net, opt)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [4, 6]
    mgr.close()


def test_restore_roundtrip(tmp_path):
    net, opt = _net()
    _train(net, opt, 3)
    w_before = _weight(net)
    m_before = opt._state[0]["moment1"].numpy().copy()
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(3, net, opt, force=True)
    _train(net, opt, 5, seed=99)
    assert not np.allclose(_weight(net), w_before)
    assert mgr.restore(net, opt) == 3
    np.testing.assert_array_equal(_weight(net), w_before)
    np.testing.assert_array_equal(opt._state[0]["moment1"].numpy(),
                                  m_before)
    assert "fc.weight.moment1" in opt.state_dict()    # named by the model
    assert opt._global_step == 3
    mgr.close()


def test_resume_continues_training(tmp_path):
    def run(mgr=None, interrupt_at=None, total=6):
        net, opt = _net(42)
        start = mgr.restore(net, opt) if mgr else 0
        losses = []
        for step in range(start + 1, total + 1):
            losses += _train(net, opt, 1, seed=step)
            if mgr:
                mgr.save(step, net, opt, force=True)
            if interrupt_at and step == interrupt_at:
                return losses
        return losses

    baseline = run()
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    first = run(mgr, interrupt_at=3)
    mgr.close()
    mgr2 = CheckpointManager(str(tmp_path / "c"), async_save=False)
    assert first + run(mgr2) == baseline
    mgr2.close()


def test_restore_empty_dir(tmp_path):
    net, _ = _net()
    mgr = CheckpointManager(str(tmp_path / "none"), async_save=False)
    assert mgr.restore(net) == 0
    mgr.close()


@pytest.mark.parametrize("async_save", [False, True])
def test_concurrent_force_save_never_drops_a_manifest(tmp_path, async_save):
    import threading
    net, opt = _net()
    mgr = CheckpointManager(str(tmp_path / "c"), max_to_keep=100,
                            async_save=async_save)
    errs = []

    def saver(offset, n=8):
        try:
            for i in range(n):
                mgr.save(offset + i, net, opt, force=True)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    def flusher():
        try:
            for _ in range(40):
                mgr._flush_manifests()
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    if async_save:
        threads = [threading.Thread(target=saver, args=(1, 16)),
                   threading.Thread(target=flusher),
                   threading.Thread(target=flusher)]
    else:
        threads = [threading.Thread(target=saver, args=(1,)),
                   threading.Thread(target=saver, args=(101,)),
                   threading.Thread(target=flusher)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    mgr.wait_until_finished()
    kept = mgr.all_steps()
    assert kept and all(mgr.verify_step(s) for s in kept), kept
    mgr.close()


def _corrupt_newest(ckpt_dir, step):
    files = [p for p in glob.glob(os.path.join(ckpt_dir, str(step), "**"),
                                  recursive=True)
             if os.path.isfile(p) and "MANIFEST" not in p]
    victim = max(files, key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    return victim


def test_manifest_written_on_commit_and_verified(tmp_path):
    net, opt = _net()
    with CheckpointManager(str(tmp_path / "c"), async_save=False) as mgr:
        for step in (1, 2):
            _train(net, opt, 1, step)
            mgr.save(step, net, opt, force=True)
        assert mgr.verified_steps() == [1, 2]
        assert mgr.latest_verified_step() == 2
        meta = json.load(open(os.path.join(str(tmp_path / "c"), "2",
                                           "RESILIENCE_MANIFEST.json")))
        assert meta["step"] == 2 and meta["files"]


def test_restore_scans_past_torn_newest(tmp_path):
    d = str(tmp_path / "c")
    net, opt = _net()
    weights = {}
    with CheckpointManager(d, async_save=False) as mgr:
        for step in (1, 2, 3):
            _train(net, opt, 1, step)
            mgr.save(step, net, opt, force=True)
            weights[step] = _weight(net)
    _corrupt_newest(d, 3)
    net2, opt2 = _net(5)
    with CheckpointManager(d, async_save=False) as mgr2:
        assert mgr2.verified_steps() == [1, 2]
        with pytest.warns(UserWarning, match="verification"):
            step = mgr2.restore(net2, opt2)
        assert mgr2.all_steps() == [1, 2]
    assert step == 2
    assert os.path.isdir(os.path.join(d, "_quarantined", "3"))
    assert not os.path.exists(os.path.join(d, "3"))
    np.testing.assert_array_equal(_weight(net2), weights[2])


def test_async_rolling_manifest_flush(tmp_path):
    d = str(tmp_path / "c")
    net, opt = _net()
    mgr = CheckpointManager(d, async_save=True)
    for step in (1, 2, 3):
        _train(net, opt, 1, step)
        mgr.save(step, net, opt, force=True)
    for s in (1, 2):
        assert os.path.exists(os.path.join(d, str(s),
                                           "RESILIENCE_MANIFEST.json")), s
    mgr.close()
    assert mgr.verify_step(3)


def test_async_save_keeps_the_values_of_its_call(tmp_path):
    """The host copy is taken in ``save``: a weight update straight after
    it does not reach the checkpoint."""
    net, opt = _net()
    _train(net, opt, 1)
    saved = _weight(net)
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=True)
    mgr.save(1, net, opt, force=True)
    with torch.no_grad():
        net.fc.weight.add_(1.0)
    mgr.close()
    mgr.restore(net, opt, step=1)
    np.testing.assert_array_equal(_weight(net), saved)


def test_chunked_digest_manifest_verifies_and_detects_corruption(
        tmp_path, monkeypatch):
    from paddle_tpu_torch.distributed.checkpoint import manager as mgr_mod
    monkeypatch.setenv("PADDLE_TPU_CKPT_DIGEST_CHUNK_MB", "0.0005")
    assert mgr_mod._digest_policy() == (524, 0)
    d = str(tmp_path / "c")
    net, opt = _net()
    with CheckpointManager(d, async_save=False) as mgr:
        _train(net, opt, 1)
        mgr.save(1, net, opt, force=True)
        man = json.load(open(os.path.join(d, "1",
                                          "RESILIENCE_MANIFEST.json")))
        chunked = [m for m in man["files"].values() if "chunks" in m]
        assert chunked and all("sha256" not in m for m in chunked)
        assert mgr.verify_step(1)
        rel = max(man["files"], key=lambda r: man["files"][r]["size"])
        victim = os.path.join(d, "1", rel)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) - 3)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        assert not mgr.verify_step(1)


def test_sampled_digest_size_check_always_stays(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CKPT_DIGEST_CHUNK_MB", "0.0001")
    monkeypatch.setenv("PADDLE_TPU_CKPT_DIGEST_SAMPLE_CHUNKS", "3")
    d = str(tmp_path / "c")
    net, opt = _net()
    with CheckpointManager(d, async_save=False) as mgr:
        _train(net, opt, 1)
        mgr.save(1, net, opt, force=True)
        man = json.load(open(os.path.join(d, "1",
                                          "RESILIENCE_MANIFEST.json")))
        big = {rel: m for rel, m in man["files"].items() if "chunks" in m}
        rel, meta = max(big.items(), key=lambda kv: kv[1]["size"])
        n_chunks = -(-meta["size"] // meta["chunk_bytes"])
        assert n_chunks > 3 and len(meta["chunks"]) == 3
        assert "0" in meta["chunks"] and str(n_chunks - 1) in meta["chunks"]
        assert mgr.verify_step(1)
        victim = os.path.join(d, "1", rel)
        size = os.path.getsize(victim)
        with open(victim, "r+b") as f:
            f.truncate(size - 1)
        assert not mgr.verify_step(1)
        with open(victim, "r+b") as f:
            f.truncate(size)
            f.seek(1)
            f.write(b"\xff")
        assert not mgr.verify_step(1)


def test_legacy_wholefile_sha256_manifest_still_verifies(tmp_path):
    d = str(tmp_path / "c")
    net, opt = _net()
    with CheckpointManager(d, async_save=False) as mgr:
        _train(net, opt, 1)
        mgr.save(1, net, opt, force=True)
        man_path = os.path.join(d, "1", "RESILIENCE_MANIFEST.json")
        man = json.load(open(man_path))
        legacy = {rel: {"size": os.path.getsize(os.path.join(d, "1", rel)),
                        "sha256": CheckpointManager._digest(
                            os.path.join(d, "1", rel))}
                  for rel in man["files"]}
        json.dump({"step": 1, "files": legacy}, open(man_path, "w"))
        assert mgr.verify_step(1)
        _corrupt_newest(d, 1)
        assert not mgr.verify_step(1)


def test_rollback_to_quarantines_newer_steps(tmp_path):
    d = str(tmp_path / "c")
    net, opt = _net()
    with CheckpointManager(d, async_save=False) as mgr:
        for step in (1, 2, 3):
            _train(net, opt, 1, step)
            mgr.save(step, net, opt, force=True)
        with pytest.warns(UserWarning, match="quarantin"):
            mgr.rollback_to(2)
        assert mgr.all_steps() == [1, 2]
        assert mgr.restore(net, opt, step=2) == 2
        _train(net, opt, 1, 3)
        assert mgr.save(3, net, opt, force=True)
        assert mgr.verify_step(3)
    assert os.path.isdir(os.path.join(d, "_quarantined", "3"))


_PREEMPT = textwrap.dedent("""
    import os, signal, sys, time
    import numpy as np
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    torch.set_num_threads(1)
    d, mode = sys.argv[1], sys.argv[2]

    def make(seed):
        paddle.seed(seed)
        net = paddle.nn.Linear(4, 2, device="cpu")
        return net, paddle.optimizer.Adam(1e-2, parameters=net.parameters())

    def train(net, opt, seed):
        rng = np.random.RandomState(seed)
        x = torch.tensor(rng.rand(8, 4).astype(np.float32))
        y = torch.tensor(rng.rand(8, 2).astype(np.float32))
        ((net(x) - y) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()

    if mode == "killed":
        net, opt = make(0)
        mgr = CheckpointManager(d, async_save=True)
        for step in (1, 2, 3):
            train(net, opt, step)
        mgr.save_on_preemption(lambda: 3, net, opt)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(60)
    net, opt = make(0)
    for step in range(1, 7):
        train(net, opt, step)
    ref = net.weight.detach().clone()
    net, opt = make(7)
    start = CheckpointManager(d, async_save=False).restore(net, opt)
    for step in range(start + 1, 7):
        train(net, opt, step)
    print(start, bool(torch.equal(net.weight.detach(), ref)))
""")


def test_save_on_preemption_in_a_subprocess(tmp_path):
    d = str(tmp_path / "c")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    args = [sys.executable, "-c", _PREEMPT, d]
    killed = subprocess.run(args + ["killed"], env=env, capture_output=True,
                            text=True, timeout=120)
    assert killed.returncode == 143, killed.stderr
    assert os.path.exists(os.path.join(d, "3", "RESILIENCE_MANIFEST.json"))
    resumed = subprocess.run(args + ["resume"], env=env, capture_output=True,
                             text=True, timeout=120)
    assert resumed.returncode == 0, resumed.stderr
    assert resumed.stdout.split()[-2:] == ["3", "True"], resumed.stdout


def test_state_dict_round_trip_and_refusals(tmp_path, clean_registry):
    """One process: a tree with a slice, an object and a numpy array; a
    template of another global shape raises with the leaf's name; a
    layout the checkpoint does not cover raises."""
    w = torch.arange(12.0).reshape(3, 4)
    save_state_dict({"w": w, "n": np.ones(3, np.float32), "meta": {"k": 1}},
                    str(tmp_path / "t"))
    tgt = {"w": torch.zeros(3, 4), "n": np.zeros(3, np.float32),
           "meta": {"k": 0}}
    load_state_dict(tgt, str(tmp_path / "t"))
    assert torch.equal(tgt["w"], w) and tgt["n"].tolist() == [1, 1, 1]
    assert tgt["meta"]["k"] == 1
    with pytest.raises(ValueError, match="w: this layout's global shape"):
        load_state_dict({"w": torch.zeros(4, 4)}, str(tmp_path / "t"))
    with pytest.raises(KeyError, match="missing"):
        load_state_dict({"missing": torch.zeros(1)}, str(tmp_path / "t"))
    part = Layout((6, 4), [((0, 0), (3, 4), 0)], (3, 4))
    save_state_dict({"w": ShardedTensor(w, part)}, str(tmp_path / "p"))
    with pytest.raises(ValueError, match="covers 12 of the 24"):
        load_state_dict({"w": torch.zeros(6, 4)}, str(tmp_path / "p"))


# -- retry ------------------------------------------------------------------------
def test_retry_succeeds_after_transient_failures():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 3:
            raise ConnectionError("transient")
        return "ok"

    assert retry_call(flaky, max_attempts=5, base_delay=0.001,
                      label="t-flaky3") == "ok"
    st = retry_stats("t-flaky3")
    assert st["retries"] == 3 and st["exhausted"] == 0


def test_retry_exhausts_and_chains_cause():
    def dead():
        raise TimeoutError("never up")

    with pytest.raises(RetryExhausted) as ei:
        retry_call(dead, max_attempts=3, base_delay=0.001, label="t-dead")
    assert isinstance(ei.value.__cause__, TimeoutError)
    assert retry_stats("t-dead")["exhausted"] == 1


def test_retry_deadline_bounds_total_time():
    def dead():
        raise ConnectionError("down")

    t0 = time.monotonic()
    with pytest.raises(RetryExhausted):
        retry_call(dead, max_attempts=100, base_delay=0.05, max_delay=0.2,
                   deadline=0.4, label="t-deadline")
    assert time.monotonic() - t0 < 2.0


def test_retry_giveup_fails_fast():
    calls = {"n": 0}

    def fatal():
        calls["n"] += 1
        raise ConnectionError("401-ish")

    with pytest.raises(ConnectionError):
        retry_call(fatal, max_attempts=5, base_delay=0.001,
                   giveup=lambda e: True, label="t-fatal")
    assert calls["n"] == 1


def test_retry_stats_mirrored_to_observability_registry():
    from paddle_tpu_torch.observability import export, metrics
    reg = metrics.registry()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise ConnectionError("transient")
        return "ok"

    before = reg.counter("resilience_retry_retries_total",
                         labels={"site": "t-obs-mirror"}).collect()
    assert retry_call(flaky, max_attempts=5, base_delay=0.001,
                      label="t-obs-mirror") == "ok"
    after = reg.counter("resilience_retry_retries_total",
                        labels={"site": "t-obs-mirror"}).collect()
    assert after == before + 2
    snap = export.snapshot()
    key = 'resilience_retry_attempts_total{site="t-obs-mirror"}'
    assert key in snap and snap[key]["value"] >= 3
