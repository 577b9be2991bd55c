"""Every collective of the port at world 4 (gloo, four CPU processes)
against numpy, the subgroups of ``new_group`` and the hybrid groups of
``fleet.init``, the object collectives, the ``stream`` namespace, the
env contract that ``distributed.spawn`` sets, ``DistributedBatchSampler``
reading the world, and a crashed rank ending the rest.

One world runs all of the file's rank-side work
(``torch_dist_workers.collectives_world``); each rank's input is
``base_value(rank)``, so every expected value is a numpy expression of
the four inputs.  The collectives move values without arithmetic or
with exact small-integer sums, so the comparisons are exact.
"""

import os
import time

import numpy as np
import pytest

from torch_dist_workers import (base_value, expected_collectives,
                                expected_groups, mismatches, shared_world,
                                start_world)
from torch_parity_helpers import torch_one_thread  # noqa: F401

WORLD = 4
X = [base_value(r) for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_world(tmp_path_factory, "collectives",
                        "collectives_world", WORLD, dict, timeout=240)


def test_the_world_and_the_env_contract(ranks):
    eps = ranks[0]["env"]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == WORLD
    for r, res in enumerate(ranks):
        env = res["env"]
        assert (res["rank"], res["world"], res["backend"]) == (r, WORLD,
                                                               "gloo")
        assert env["PADDLE_TRAINER_ID"] == str(r)
        assert env["PADDLE_TRAINERS_NUM"] == str(WORLD)
        assert env["PADDLE_TRAINER_ENDPOINTS"].split(",") == eps
        assert env["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert env["PADDLE_MASTER"] == ranks[0]["env"]["PADDLE_MASTER"]
        assert res["foreign_modules"] == []


ALL_REDUCE = {"sum": np.sum(X, 0), "max": np.max(X, 0),
              "min": np.min(X, 0), "prod": np.prod(X, 0),
              "avg": np.sum(X, 0) / WORLD}


@pytest.mark.parametrize("op", sorted(ALL_REDUCE))
def test_all_reduce(ranks, op):
    for res in ranks:
        np.testing.assert_array_equal(res[f"all_reduce_{op}"],
                                      ALL_REDUCE[op].astype(np.float32))


@pytest.mark.parametrize("form", ["all_reduce_tensor", "all_reduce_async",
                                  "stream_all_reduce", "all_reduce_bf16"])
def test_all_reduce_forms(ranks, form):
    """On a Paddle Tensor, with ``sync_op=False`` and ``task.wait()``,
    through ``distributed.stream``, and in bf16."""
    for res in ranks:
        np.testing.assert_array_equal(res[form], np.sum(X, 0))


def test_all_gather_broadcast_reduce(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["all_gather"], np.stack(X))
        np.testing.assert_array_equal(res["broadcast"], X[3])
    np.testing.assert_array_equal(ranks[0]["reduce"], np.sum(X, 0))


def test_reduce_scatter(ranks):
    for r, res in enumerate(ranks):
        want = sum(X[s] + r for s in range(WORLD))
        np.testing.assert_array_equal(res["reduce_scatter"], want)
        np.testing.assert_array_equal(res["reduce_scatter_tensor"], want)


def test_alltoall(ranks):
    for r, res in enumerate(ranks):
        want = np.stack([np.full((2, 3), 100 * s + r, np.float32)
                         for s in range(WORLD)])
        np.testing.assert_array_equal(res["alltoall"], want)
        single = np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * s
                                 for s in range(WORLD)])
        np.testing.assert_array_equal(res["alltoall_single"], single)
        start = sum(j + 1 for j in range(r))
        uneven = np.concatenate([np.arange(start, start + r + 1) + 100 * s
                                 for s in range(WORLD)])
        np.testing.assert_array_equal(res["alltoall_single_uneven"], uneven)


def test_scatter_gather_send_recv(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["scatter"],
                                      np.full((2, 3), 7 * r, np.float32))
        np.testing.assert_array_equal(res["send_recv"], X[(r - 1) % WORLD])
    np.testing.assert_array_equal(ranks[3]["gather"], np.stack(X))
    assert all(ranks[r]["gather"] is None for r in range(3))


def test_object_collectives(ranks):
    for r, res in enumerate(ranks):
        assert res["all_gather_object"] == [{"rank": s, "sq": s * s}
                                            for s in range(WORLD)]
        assert res["broadcast_object_list"] == ["from 3", 3]
        assert res["scatter_object_list"] == [{"to": r}]


def test_new_group_subgroups(ranks):
    for r, res in enumerate(ranks):
        members, group_rank, value = res["subgroup"]
        assert members == ([0, 2] if r in (0, 2) else [1, 3])
        assert group_rank == members.index(r)
        np.testing.assert_array_equal(value, sum(X[m] for m in members))


def test_hybrid_groups_of_fleet_init(ranks):
    """dp2 x mp2: the mp groups are consecutive ranks (the model axis is
    innermost), the dp groups stride by 2; each group's sum is its own."""
    for r, res in enumerate(ranks):
        mp = [r - r % 2, r - r % 2 + 1]
        dp = [r % 2, r % 2 + 2]
        assert res["hybrid_ranks"] == {"dp": dp, "mp": mp, "pp": [r],
                                       "sharding": [r], "check": mp}
        assert res["hybrid_sum_dp"] == [sum(dp)] * 2
        assert res["hybrid_sum_mp"] == [sum(mp)] * 2
        assert res["hybrid_coords"] == (r // 2, r % 2)


@pytest.mark.parametrize("part", ["collectives", "groups"])
def test_the_shared_expectations_agree(ranks, part):
    """``expected_collectives`` / ``expected_groups``, which
    ``chip_smoke.py`` holds the same exercise against on CUDA tensors,
    agree with every rank's results here; a planted wrong value is
    caught."""
    for r, res in enumerate(ranks):
        want = (expected_collectives(r, WORLD) if part == "collectives"
                else expected_groups(r))
        assert mismatches(res, want) == []
        name = sorted(want)[0]
        assert mismatches({**res, name: "planted"}, want) == [name]


def test_distributed_batch_sampler_reads_the_world(ranks):
    from paddle_tpu_torch.io import DistributedBatchSampler
    for r, res in enumerate(ranks):
        want = DistributedBatchSampler(list(range(10)), batch_size=2,
                                       num_replicas=WORLD, rank=r)
        assert res["sampler"] == (WORLD, r, list(want))


def test_cpu_gloo_composes_nothing(ranks):
    """The compositions are for CUDA tensors on gloo only: the public
    collectives on CPU tensors take none."""
    assert all(res["composed"] == {} for res in ranks)


def test_the_compositions_for_gloo_on_cuda(ranks):
    """``_composed_alltoall`` and the host-copy send / recv, called
    directly on CPU tensors, give the native collectives' results and
    count one use each."""
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["composed_alltoall"],
                                      res["alltoall"])
        np.testing.assert_array_equal(res["host_send_recv"],
                                      X[(r - 1) % WORLD])
        assert res["composed_counts"] == {"alltoall": 1, "send": 1,
                                          "recv": 1}


def test_one_crashed_rank_ends_the_rest(tmp_path):
    """Rank 1 raises at once while ranks 0 and 2 would sleep for 300 s:
    ``spawn``'s join ends them and raises within seconds."""
    t0 = time.monotonic()
    ctx = start_world("crash_world", 3, {}, str(tmp_path))
    with pytest.raises(RuntimeError, match="spawn-rank1"):
        ctx.join(timeout=120)
    assert time.monotonic() - t0 < 100
    assert all(p.exitcode is not None for p in ctx.processes)
    assert not os.path.exists(tmp_path / "rank0.pkl")
