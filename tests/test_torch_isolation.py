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
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)\b",
                         re.MULTILINE)
    sources = list(_port_sources())
    assert len(sources) > 10
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
