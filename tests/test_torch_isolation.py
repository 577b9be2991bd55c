"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked."""

import os
import re
import subprocess
import sys

import pytest
import torch
from torch_parity_helpers import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.models, paddle_tpu_torch.io\n"
        "import paddle_tpu_torch.hapi, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.amp, paddle_tpu_torch.nn\n"
        "import paddle_tpu_torch.ops, paddle_tpu_torch.framework\n"
        "import paddle_tpu_torch.nn.functional\n"
        "import paddle_tpu_torch.ops.lmce_kernel\n"
        "import paddle_tpu_torch.framework.env_knobs\n"
        "import paddle_tpu_torch.models.bert, paddle_tpu_torch.ops.nn_ops\n"
        "import paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.inference.serving.router\n"
        "import paddle_tpu_torch.inference.serving.disagg\n"
        "import paddle_tpu_torch.vision.models\n"
        "import paddle_tpu_torch.vision.models.vision_transformer\n"
        "import paddle_tpu_torch.vision.models.ppyoloe\n"
        "import paddle_tpu_torch.vision.ops\n"
        "import paddle_tpu_torch.amp.auto_cast, paddle_tpu_torch.ops.activation\n"
        "import paddle_tpu_torch.metric, paddle_tpu_torch.framework.io\n"
        "import paddle_tpu_torch.hapi.summary, paddle_tpu_torch.hapi.callbacks\n"
        "import paddle_tpu_torch.io.sampler, paddle_tpu_torch.io.staging\n"
        "import paddle_tpu_torch.vision.datasets\n"
        "import paddle_tpu_torch.optimizer.lr, paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.nn.clip_grad, paddle_tpu_torch.nn.param_attr\n"
        "import paddle_tpu_torch.nn.utils, paddle_tpu_torch.amp.grad_scaler\n"
        "import paddle_tpu_torch.amp.debugging, paddle_tpu_torch.optimizer.lbfgs\n"
        "import paddle_tpu_torch.nn.layer, paddle_tpu_torch.nn.rnn\n"
        "import paddle_tpu_torch.nn.transformer, paddle_tpu_torch.nn.loss\n"
        "import paddle_tpu_torch.nn.functional_call, paddle_tpu_torch.ops.rnn_ops\n"
        "import paddle_tpu_torch.framework.selected_rows, paddle_tpu_torch.callbacks\n"
        "import paddle_tpu_torch.tensor, paddle_tpu_torch.places\n"
        "import paddle_tpu_torch.device, paddle_tpu_torch.framework.dtype\n"
        "import paddle_tpu_torch.autograd, paddle_tpu_torch.linalg\n"
        "import paddle_tpu_torch.autograd.tape, paddle_tpu_torch.autograd.py_layer\n"
        "import paddle_tpu_torch.autograd.functional\n"
        "import paddle_tpu_torch.ops._primitive, paddle_tpu_torch.ops.creation\n"
        "import paddle_tpu_torch.ops.math, paddle_tpu_torch.ops.manipulation\n"
        "import paddle_tpu_torch.ops.logic, paddle_tpu_torch.ops.linalg\n"
        "import paddle_tpu_torch.ops.array_ops\n"
        "import paddle_tpu_torch.distributed.fleet\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel.mp_ops\n"
        "import paddle_tpu_torch.distributed.fleet.meta_optimizers\n"
        "import paddle_tpu_torch.distributed.fleet.recompute\n"
        "import paddle_tpu_torch.distributed.fleet.utils\n"
        "import paddle_tpu_torch.distributed.sharding\n"
        "import paddle_tpu_torch.distributed.runner\n"
        "import paddle_tpu_torch.distributed.spawn\n"
        "import paddle_tpu_torch.distributed.stream\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel.pp_layers\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel."
        "pipeline_parallel\n"
        "import paddle_tpu_torch.distributed.fleet.meta_parallel."
        "context_parallel\n"
        "import paddle_tpu_torch.distributed.fleet.utils."
        "sequence_parallel_utils\n"
        "paddle_tpu_torch.set_device('cpu')\n"
        "x = paddle_tpu_torch.to_tensor([1.0, 2.0], stop_gradient=False)\n"
        "(x * x).sum().backward()\n"
        "assert x.grad.numpy().tolist() == [2.0, 4.0]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_spawned_ranks_import_no_jax(tmp_path_factory):
    """The ranks ``distributed.spawn`` starts (the collectives world of
    ``tests/test_torch_dist_collectives.py``) load neither JAX nor the
    JAX package."""
    from torch_dist_workers import shared_world
    ranks = shared_world(tmp_path_factory, "collectives",
                         "collectives_world", 4, dict, timeout=240)
    assert [r["foreign_modules"] for r in ranks] == [[]] * 4


def test_pipeline_ranks_import_no_jax(tmp_path_factory):
    """The pipeline ranks (``tests/test_torch_dist_pipeline.py``'s world:
    every stage, the engine, the tied weights, the functional forms)
    load neither JAX nor the JAX package."""
    from test_torch_dist_pipeline import _inputs
    from torch_dist_workers import shared_world
    ranks = shared_world(tmp_path_factory, "pipeline", "pipeline_world", 4,
                         _inputs, timeout=300)
    assert [r["foreign_modules"] for r in ranks] == [[]] * 4


def test_checkpoint_ranks_import_no_jax(tmp_path_factory):
    """The ranks of ``tests/test_torch_dist_checkpoint.py``'s world (the
    checkpoint's save, reshard and manager, the compressed ring, the
    fused LMCE over a split vocabulary) load neither JAX nor the JAX
    package."""
    from test_torch_dist_checkpoint import checkpoint_ranks
    res, _ = checkpoint_ranks(tmp_path_factory)
    assert [r["foreign_modules"] for r in res] == [[]] * 4


def _port_sources():
    for root, _, files in os.walk(PORT):
        if "_build" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)
    for script in ("chip_smoke.py", "chip_ab.py", "chip_lmce_ablation.py",
                   "chip_fused_variants.py", "chip_profiler_lag.py",
                   "chip_nms_ties.py", "chip_conv_routes.py",
                   "tests/torch_dist_workers.py"):
        yield os.path.join(REPO, script)


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)\b",
                         re.MULTILINE)
    sources = list(_port_sources())
    assert len(sources) > 10
    for mod in ("framework/env_knobs.py", "models/bert.py", "ops/nn_ops.py",
                "metric/__init__.py", "framework/io.py", "hapi/summary.py",
                "io/sampler.py", "io/staging.py", "vision/datasets/mnist.py",
                "optimizer/lr.py", "regularizer/__init__.py",
                "nn/clip_grad.py", "nn/param_attr.py", "nn/utils/utils.py",
                "amp/grad_scaler.py", "amp/debugging.py",
                "optimizer/lbfgs.py", "framework/selected_rows.py",
                "callbacks/__init__.py", "tensor.py", "places.py",
                "device/__init__.py", "framework/dtype.py", "linalg.py",
                "autograd/__init__.py", "autograd/tape.py",
                "autograd/py_layer.py", "autograd/functional.py",
                "ops/_primitive.py", "ops/creation.py", "ops/math.py",
                "ops/manipulation.py", "ops/logic.py", "ops/linalg.py",
                "ops/array_ops.py", "ops/activation.py", "ops/__init__.py",
                "distributed/parallel.py", "distributed/communication.py",
                "distributed/stream.py", "distributed/collective.py",
                "distributed/spawn.py", "distributed/runner.py",
                "distributed/sharding/__init__.py",
                "distributed/fleet/fleet.py",
                "distributed/fleet/base/topology.py",
                "distributed/fleet/base/distributed_strategy.py",
                "distributed/fleet/meta_parallel/mp_layers.py",
                "distributed/fleet/meta_parallel/mp_ops.py",
                "distributed/fleet/meta_parallel/parallel_wrappers.py",
                "distributed/fleet/meta_parallel/pp_layers.py",
                "distributed/fleet/meta_parallel/pipeline_parallel.py",
                "distributed/fleet/meta_parallel/context_parallel.py",
                "distributed/fleet/utils/sequence_parallel_utils.py",
                "distributed/fleet/meta_parallel/sharding_parallel.py",
                "distributed/fleet/meta_optimizers/dygraph_optimizer.py",
                "distributed/fleet/recompute/__init__.py",
                "distributed/fleet/utils/hybrid_parallel_util.py",
                "distributed/compressed.py",
                "distributed/resilience/retry.py",
                "distributed/checkpoint/__init__.py",
                "distributed/checkpoint/layout.py",
                "distributed/checkpoint/reshard.py",
                "distributed/checkpoint/manager.py"):
        assert os.path.join(PORT, mod) in sources, mod
    for path in sources:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert not pattern.search(text), path
        assert "import_module(\"jax" not in text, path


def test_to_tensor_refuses_without_a_card_unless_asked_for_the_cpu():
    """A Paddle Tensor goes to the card by default: without one,
    ``to_tensor``, the creation ops and a layer refuse, until
    ``place=CPUPlace()`` or ``set_device("cpu")`` asks for the CPU (in
    a fresh process, so no other test's place is in the way)."""
    code = (
        "import torch, pytest\n"
        "torch.cuda.is_available = lambda: False\n"
        "import paddle_tpu_torch as paddle\n"
        "assert paddle.get_device() == 'gpu:0'\n"
        "for make in (lambda: paddle.to_tensor([1.0]),\n"
        "             lambda: paddle.zeros([2]), lambda: paddle.arange(3),\n"
        "             lambda: paddle.nn.Linear(2, 2)):\n"
        "    with pytest.raises(RuntimeError, match='is_available'):\n"
        "        make()\n"
        "t = paddle.to_tensor([1.0], place=paddle.CPUPlace())\n"
        "assert t.place == paddle.CPUPlace()\n"
        "paddle.set_device('cpu')\n"
        "assert paddle.zeros([2]).place.is_cpu_place()\n"
        "assert paddle.nn.Linear(2, 2).weight.device.type == 'cpu'\n"
        "assert paddle.get_device() == 'cpu'\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_engine_without_device_refuses_cpu_fallback(monkeypatch):
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference.serving import (DecodeEngine,
                                                    params_from_numpy)
    from paddle_tpu_torch.models import gpt_tiny, init_decode_weights_numpy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt_tiny()
    params = params_from_numpy(init_decode_weights_numpy(cfg, 0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(params=params, gpt_config=cfg)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    eng = DecodeEngine(params=params, gpt_config=cfg, device="cpu")
    assert eng.device == torch.device("cpu")


def test_fused_model_without_device_refuses_cpu_fallback(monkeypatch):
    """The fused lm-head path changes no device rule: the model refuses
    to build without a card unless ``device="cpu"`` is given, and then
    runs the kernels' plain versions."""
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion,
                                         enable_fused_lmce, gpt_tiny)
    from paddle_tpu_torch.ops import lmce_kernel as lk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GPTForCausalLM(gpt_tiny())
    net, crit = enable_fused_lmce(GPTForCausalLM(gpt_tiny(), device="cpu"),
                                  GPTPretrainingCriterion())
    assert net.skip_lm_head and next(net.parameters()).device.type == "cpu"
    x = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                      .manual_seed(0))
    lk.reset_counts()
    loss = crit(net(x), x.roll(-1, 1))
    assert torch.isfinite(loss)
    assert lk.lmce_fwd.plain_calls == 1 and lk.lmce_fwd.launches == 0


def test_env_knobs_registry_is_the_ports_own():
    """The port's registry holds only ``PADDLE_TORCH_*`` names, each read
    by the port, and reads no ``PADDLE_TPU_*`` variable."""
    from paddle_tpu_torch.framework import env_knobs
    assert env_knobs.KNOBS and all(n.startswith("PADDLE_TORCH_")
                                   for n in env_knobs.KNOBS)
    users = []
    for path in _port_sources():
        if path.endswith(".py") and "env_knobs.py" not in path:
            with open(path, encoding="utf-8") as fh:
                users.append(fh.read())
    text = "\n".join(users)
    for name in env_knobs.KNOBS:
        assert f'"{name}"' in text, f"{name} is registered but never read"
    assert not re.search(r"get_(raw|bool|int|float)\(\s*\"PADDLE_TPU_",
                         text)
