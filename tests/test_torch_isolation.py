"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points refuse to run on the CPU unless asked."""

import os
import re
import subprocess
import sys

import pytest
import torch

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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "'jax.') or m == 'paddle_tpu' or m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    for root, _, files in os.walk(PORT):
        if "_build" in root.split(os.sep):
            continue
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)
    for script in ("chip_smoke.py", "chip_ab.py", "chip_lmce_ablation.py",
                   "chip_fused_variants.py", "chip_profiler_lag.py"):
        yield os.path.join(REPO, script)


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)\b",
                         re.MULTILINE)
    sources = list(_port_sources())
    assert len(sources) > 10
    for mod in ("framework/env_knobs.py", "models/bert.py", "ops/nn_ops.py",
                "metric/__init__.py", "framework/io.py", "hapi/summary.py",
                "io/sampler.py", "io/staging.py", "vision/datasets/mnist.py"):
        assert os.path.join(PORT, mod) in sources, mod
    for path in sources:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        assert not pattern.search(text), path
        assert "import_module(\"jax" not in text, path


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
