"""``paddle_tpu_torch.amp.debugging`` against ``paddle_tpu.amp.debugging``
(and the checks of ``tests/test_amp_debugging.py``): operator stats
bucketed by the lowest-precision floating input, ``check_numerics``'s
counts and refusal, the tensor checker, ``compare_accuracy`` and the
refusal of a nested collection.

The JAX package counts calls of its own primitives (``linear``); the
port counts ATen operators (``mm`` and the bias ``add``), so the op
names differ by design and the tests compare the dtype buckets.  Counts
and reports are compared exactly.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.amp import debugging as JD
from paddle_tpu.tensor import Tensor as JTensor

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.amp import debugging as TD
from torch_parity_helpers import torch_one_thread  # noqa: F401


def _x():
    return np.random.RandomState(0).rand(2, 4).astype(np.float32)


def test_operator_stats_bucket_calls_as_jax_does(capsys):
    """Under ``auto_cast`` O1 bf16 the Linear's matmul (and, in the
    port, its bias add) is a BF16 call in both packages; ``x + x``
    outside it is an FP32 call.  Both print the table."""
    jpaddle.seed(0)
    jnet, jx = jnn.Linear(4, 4), JTensor(_x())
    with JD.collect_operator_stats():
        with jamp.auto_cast(level="O1", dtype="bfloat16"):
            _ = jnet(jx)
        _ = jx + jx
    jout = capsys.readouterr().out
    JD.enable_operator_stats_collection()
    with jamp.auto_cast(level="O1", dtype="bfloat16"):
        _ = jnet(jx)
    _ = jx + jx
    jstats = JD.disable_operator_stats_collection()

    tnet, tx = tnn.Linear(4, 4, device="cpu"), torch.from_numpy(_x())
    with TD.collect_operator_stats():
        with tamp.auto_cast(level="O1", dtype="bfloat16"):
            _ = tnet(tx)
        _ = tx + tx
    tout = capsys.readouterr().out
    TD.enable_operator_stats_collection()
    with tamp.auto_cast(level="O1", dtype="bfloat16"):
        y = tnet(tx)
    _ = tx + tx
    tstats = TD.disable_operator_stats_collection()
    capsys.readouterr()

    assert "op list" in jout and "linear" in jout
    assert "op list" in tout and "mm" in tout
    assert y.dtype == torch.bfloat16
    assert jstats["linear"] == {"FP16": 0, "BF16": 1, "FP32": 0, "OTHER": 0}
    assert tstats["mm"] == {"FP16": 0, "BF16": 1, "FP32": 0, "OTHER": 0}
    assert jstats["add"]["FP32"] == 1
    assert tstats["add"] == {"FP16": 0, "BF16": 1, "FP32": 1, "OTHER": 0}
    assert TD.disable_operator_stats_collection() == {}


@pytest.mark.parametrize("values,dtype", [
    ([1.0, np.nan, np.inf], "float32"),
    ([np.inf, -np.inf, 2.0, np.nan, np.nan], "float16"),
    ([1.0, 1.0, 1.0], "float32"),
    ([1, 2, 3], "int32"),
])
def test_check_numerics_counts_and_raises_as_jax_does(values, dtype):
    """``(num_nan, num_inf)`` int64 scalars equal to the JAX package's;
    a non-finite value raises ``FloatingPointError`` naming the op and
    the variable in both, with the same counts."""
    arr = np.asarray(values, dtype)
    jerr = terr = None
    try:
        jn, ji = JD.check_numerics(JTensor(arr), op_type="my_op",
                                   var_name="act")
        jres = (int(jn.numpy()), int(ji.numpy()))
    except FloatingPointError as e:
        jerr = str(e)
    try:
        tn, ti = TD.check_numerics(torch.from_numpy(arr), op_type="my_op",
                                   var_name="act")
        assert tn.dtype == ti.dtype == torch.int64
        tres = (int(tn), int(ti))
    except FloatingPointError as e:
        terr = str(e)
    assert (jerr is None) == (terr is None)
    if jerr is None:
        assert tres == jres == (0, 0)
    else:
        assert "my_op" in terr and "act" in terr
        assert terr.split("(shape")[0] == jerr.split("(shape")[0]


def test_tensor_checker_scans_every_operator_until_disabled():
    """Enabled, the first operator with an inf output raises; disabled
    (or enabled with ``enable=False``), the same operator runs."""
    bad = torch.tensor([np.inf], dtype=torch.float32)
    TD.enable_tensor_checker(TD.TensorCheckerConfig(enable=True))
    try:
        with pytest.raises(FloatingPointError, match="add"):
            _ = bad + 1.0
        _ = torch.ones(2) + 1.0
    finally:
        TD.disable_tensor_checker()
    assert torch.isinf(bad + 1.0).all()
    TD.enable_tensor_checker(TD.TensorCheckerConfig(enable=False))
    try:
        assert torch.isinf(bad + 1.0).all()
    finally:
        TD.disable_tensor_checker()


@pytest.mark.parametrize("atol", [0, 2])
def test_compare_accuracy_reports_as_jax_does(tmp_path, atol):
    """The same two collections give the same report and the same JSON
    file in both packages; a file path is read as a collection."""
    a = {"matmul": {"FP16": 0, "BF16": 5, "FP32": 0, "OTHER": 0},
         "add": {"FP16": 0, "BF16": 0, "FP32": 3, "OTHER": 0},
         "relu": {"FP16": 0, "BF16": 1, "FP32": 0, "OTHER": 0}}
    b = {"matmul": {"FP16": 0, "BF16": 0, "FP32": 5, "OTHER": 0},
         "add": {"FP16": 0, "BF16": 0, "FP32": 3, "OTHER": 0},
         "softmax": {"FP16": 0, "BF16": 0, "FP32": 2, "OTHER": 0}}
    src = tmp_path / "b.json"
    src.write_text(json.dumps(b))
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jdiff = JD.compare_accuracy(a, str(src), output_filename=str(jpath),
                                atol=atol)
    tdiff = TD.compare_accuracy(a, str(src), output_filename=str(tpath),
                                atol=atol)
    assert tdiff == jdiff and "matmul" in tdiff and "add" not in tdiff
    assert ("relu" in tdiff) == (atol == 0)
    assert tpath.read_text() == jpath.read_text()


def test_nested_collection_refuses_as_jax_does():
    for d in (JD, TD):
        d.enable_operator_stats_collection()
        try:
            with pytest.raises(RuntimeError, match="already enabled"):
                d.enable_operator_stats_collection()
        finally:
            d.disable_operator_stats_collection()
