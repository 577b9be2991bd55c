"""The rank side of the port's multi-rank tests (not a test module).

Spawned ranks import this module, torch and ``paddle_tpu_torch`` only,
never JAX or the JAX package: the tests that hold them against the JAX
package run that side in the test process.  Each rank runs torch on one
thread.

``shared_world`` runs one gloo world of CPU processes for a test file
and hands its results (numpy, by rank) to every test of the file: the
first xdist worker that needs it spawns the world under a file lock in
the session's shared temporary directory, the others read what it
wrote, so a file's world runs once whichever workers its tests land on.
Every world has its own timeout: a hung world fails its tests and ends
its processes.
"""

import json
import os
import pickle
import sys
import time
import warnings

import numpy as np

THREADS_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
CONTRACT = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
            "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT",
            "PADDLE_MASTER")


def _one_thread():
    import torch
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)


def _foreign_modules():
    return sorted(m for m in sys.modules if m in ("jax", "paddle_tpu")
                  or m.startswith(("jax.", "paddle_tpu.")))


def _entry(fn_name, indir, outdir):
    """A rank: one thread, the CPU place, ``fn_name(paddle, inputs)``;
    its result (with the env it saw and the JAX modules loaded, which
    must be none) pickled to ``outdir/rank<r>.pkl``."""
    _one_thread()
    env = {k: os.environ.get(k) for k in CONTRACT}
    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")
    with open(os.path.join(indir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = globals()[fn_name](paddle, inputs)
    res["env"] = env
    res["foreign_modules"] = _foreign_modules()
    rank = int(env["PADDLE_TRAINER_ID"])
    tmp = os.path.join(outdir, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, os.path.join(outdir, f"rank{rank}.pkl"))
    paddle.distributed.destroy_process_group()


def start_world(fn_name, nprocs, inputs, workdir):
    """Spawn ``nprocs`` ranks of ``fn_name``; returns the
    ``ProcessContext``."""
    from paddle_tpu_torch.distributed.spawn import spawn
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return spawn(_entry, args=(fn_name, workdir, workdir), nprocs=nprocs,
                 join=False, env=THREADS_ENV)


def run_world(fn_name, nprocs, inputs, workdir, timeout):
    """Spawn ``nprocs`` ranks of ``fn_name`` and return their results in
    rank order; raises when a rank fails or the world outlives
    ``timeout`` seconds."""
    ctx = start_world(fn_name, nprocs, inputs, workdir)
    if not ctx.join(timeout):
        ctx.terminate()
        raise TimeoutError(f"world {fn_name} ran past {timeout} s")
    out = []
    for r in range(nprocs):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def shared_world(tmp_path_factory, key, fn_name, nprocs, make_inputs,
                 timeout):
    """:func:`run_world` once per test session for ``key`` (module
    docstring); ``make_inputs()`` builds the world's inputs."""
    from torch_parity_helpers import session_shared
    workdir = os.path.join(str(tmp_path_factory.mktemp(f"world-{key}")))
    return session_shared(
        tmp_path_factory, f"world-{key}",
        lambda: run_world(fn_name, nprocs, make_inputs(), workdir, timeout))


# -- every collective: the exercise, here and on the card ---------------------
def base_value(rank):
    return (np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * rank + 1)


def exercise_collectives(paddle, device):
    """Every collective of ``distributed.communication`` on this rank's
    tensors on ``device``, the object collectives and the ``stream``
    namespace; returns ``{name: result}`` (numpy, or the objects).  Each
    rank's input is ``base_value(rank)``: the results are moves and
    small-integer sums, exact in fp32 and bf16.  ``chip_smoke.py`` runs
    it on CUDA tensors and holds it against
    :func:`expected_collectives`."""
    import torch
    dist = paddle.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    res = {}

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    def host(v):
        v = getattr(v, "_value", v)
        return v.float().cpu().numpy()

    x = base_value(rank)
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "prod": dist.ReduceOp.PROD,
           "avg": dist.ReduceOp.AVG}
    for name, op in ops.items():
        v = t(x)
        dist.all_reduce(v, op=op)
        res[f"all_reduce_{name}"] = host(v)
    v = t(x, torch.bfloat16)
    dist.all_reduce(v)
    res["all_reduce_bf16"] = host(v)
    v = paddle.to_tensor(x)
    dist.all_reduce(v)
    res["all_reduce_tensor"] = host(v)
    v = t(x)
    task = dist.all_reduce(v, sync_op=False)
    task.wait()
    res["all_reduce_async"] = host(v)
    v = t(x)
    dist.stream.all_reduce(v, use_calc_stream=True)
    res["stream_all_reduce"] = host(v)

    got = []
    dist.all_gather(got, t(x))
    res["all_gather"] = np.stack([host(g) for g in got])
    v = t(x)
    dist.broadcast(v, src=world - 1)
    res["broadcast"] = host(v)
    v = t(x)
    dist.reduce(v, dst=0)
    res["reduce"] = host(v)
    out = t(np.zeros((2, 3)))
    dist.reduce_scatter(out, [t(x + i) for i in range(world)])
    res["reduce_scatter"] = host(out)
    v = paddle.to_tensor(np.concatenate([x + i for i in range(world)]))
    dist.reduce_scatter(v)
    res["reduce_scatter_tensor"] = host(v)
    outs = []
    dist.alltoall(outs, [t(np.full((2, 3), 100 * rank + j))
                         for j in range(world)])
    res["alltoall"] = np.stack([host(o) for o in outs])
    src = t(np.arange(2 * world) + 100 * rank)
    out = t(np.zeros(2 * world))
    dist.alltoall_single(out, src)
    res["alltoall_single"] = host(out)
    sizes = [j + 1 for j in range(world)]
    src = t(np.arange(sum(sizes)) + 100 * rank)
    out = t(np.zeros(world * (rank + 1)))
    dist.alltoall_single(out, src, sizes, [rank + 1] * world)
    res["alltoall_single_uneven"] = host(out)
    v = t(np.zeros((2, 3)))
    dist.scatter(v, [t(np.full((2, 3), 7 * j)) for j in range(world)]
                 if rank == 0 else None, src=0)
    res["scatter"] = host(v)
    got = []
    dist.gather(t(x), got if rank == world - 1 else None, dst=world - 1)
    res["gather"] = np.stack([host(g) for g in got]) if got else None
    if world > 1:
        send = dist.isend(t(x), dst=(rank + 1) % world)
        v = t(np.zeros((2, 3)))
        recv = dist.irecv(v, src=(rank - 1) % world)
        send.wait()
        recv.wait()
        res["send_recv"] = host(v)
    dist.barrier()

    objs = []
    dist.all_gather_object(objs, {"rank": rank, "sq": rank * rank})
    res["all_gather_object"] = objs
    lst = [f"from {rank}", rank] if rank == world - 1 else [None, None]
    dist.broadcast_object_list(lst, src=world - 1)
    res["broadcast_object_list"] = lst
    got = []
    dist.scatter_object_list(got, [{"to": j} for j in range(world)]
                             if rank == 0 else None, src=0)
    res["scatter_object_list"] = got
    return res


def expected_collectives(rank, world):
    """What :func:`exercise_collectives` gives ``rank`` of ``world``
    (the names a rank gets a result for)."""
    xs = [base_value(r) for r in range(world)]
    total = np.sum(xs, 0)
    want = {"all_reduce_sum": total, "all_reduce_max": np.max(xs, 0),
            "all_reduce_min": np.min(xs, 0),
            "all_reduce_prod": np.prod(xs, 0),
            "all_reduce_avg": total / world, "all_reduce_bf16": total,
            "all_reduce_tensor": total, "all_reduce_async": total,
            "stream_all_reduce": total, "all_gather": np.stack(xs),
            "broadcast": xs[world - 1],
            "reduce_scatter": sum(x + rank for x in xs),
            "reduce_scatter_tensor": sum(x + rank for x in xs),
            "alltoall": np.stack([np.full((2, 3), 100 * s + rank)
                                  for s in range(world)]),
            "alltoall_single": np.concatenate(
                [np.arange(2 * rank, 2 * rank + 2) + 100 * s
                 for s in range(world)]),
            "scatter": np.full((2, 3), 7 * rank),
            "gather": np.stack(xs) if rank == world - 1 else None,
            "all_gather_object": [{"rank": s, "sq": s * s}
                                  for s in range(world)],
            "broadcast_object_list": [f"from {world - 1}", world - 1],
            "scatter_object_list": [{"to": rank}]}
    start = sum(j + 1 for j in range(rank))
    want["alltoall_single_uneven"] = np.concatenate(
        [np.arange(start, start + rank + 1) + 100 * s for s in range(world)])
    if rank == 0:
        want["reduce"] = total
    if world > 1:
        want["send_recv"] = xs[(rank - 1) % world]
    return want


def exercise_groups(paddle, device):
    """At world 4: the subgroups ``new_group([0, 2])`` / ``([1, 3])`` and
    the dp2 x mp2 hybrid groups of ``fleet.init``, each summing this
    rank's value (bf16 on the hybrid groups, the gradients' wire type
    under O2); returns what :func:`expected_groups` names."""
    import torch
    dist = paddle.distributed
    rank = dist.get_rank()
    res = {}
    g02, g13 = dist.new_group([0, 2]), dist.new_group([1, 3])
    mine = g02 if rank in (0, 2) else g13
    v = torch.tensor(base_value(rank), device=device)
    dist.all_reduce(v, group=mine)
    res["subgroup"] = (mine.ranks, mine.rank, v.cpu().numpy())

    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    dist.fleet.init(is_collective=True, strategy=strategy)
    hcg = dist.fleet.get_hybrid_communicate_group()
    groups = {"dp": hcg.get_data_parallel_group(),
              "mp": hcg.get_model_parallel_group(),
              "pp": hcg.get_pipe_parallel_group(),
              "sharding": hcg.get_sharding_parallel_group(),
              "check": hcg.get_check_parallel_group()}
    res["hybrid_ranks"] = {k: g.ranks for k, g in groups.items()}
    for k in ("dp", "mp"):
        v = torch.full((2,), float(rank), device=device, dtype=torch.bfloat16)
        dist.all_reduce(v, group=groups[k])
        res[f"hybrid_sum_{k}"] = v.float().cpu().tolist()
    res["hybrid_coords"] = (hcg.get_data_parallel_rank(),
                            hcg.get_model_parallel_rank())
    return res


def expected_groups(rank):
    """What :func:`exercise_groups` gives ``rank``: the mp groups are
    consecutive ranks (the model axis is innermost), the dp groups
    stride by 2."""
    members = [0, 2] if rank in (0, 2) else [1, 3]
    mp = [rank - rank % 2, rank - rank % 2 + 1]
    dp = [rank % 2, rank % 2 + 2]
    return {"subgroup": (members, members.index(rank),
                         sum(base_value(m) for m in members)),
            "hybrid_ranks": {"dp": dp, "mp": mp, "pp": [rank],
                             "sharding": [rank], "check": mp},
            "hybrid_sum_dp": [float(sum(dp))] * 2,
            "hybrid_sum_mp": [float(sum(mp))] * 2,
            "hybrid_coords": (rank // 2, rank % 2)}


def replica_diffs(tensors, group):
    """``[elements compared, elements whose bits differ from the group's
    first rank]`` for ``tensors`` gathered over ``group`` (one
    all-gather per dtype)."""
    import torch
    from paddle_tpu_torch.distributed import all_gather
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}
    by = {}
    for t in tensors:
        by.setdefault(t.dtype, []).append(t.detach().reshape(-1))
    n = bad = 0
    for dtype, ts in by.items():
        rows = []
        all_gather(rows, torch.cat(ts), group=group)
        ref = rows[0].view(bits[dtype])
        n += ref.numel()
        bad += sum(int((row.view(bits[dtype]) != ref).sum())
                   for row in rows[1:])
    return [n, bad]


def optimizer_leaves(optimizer):
    """``[(tensor, split over mp)]``: every parameter of ``optimizer``
    (the one ``fleet.distributed_optimizer`` wraps) and its fp32 master
    where it keeps one."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import is_mp_split
    inner = getattr(optimizer, "_inner_opt", optimizer)
    leaves = []
    for i, p in enumerate(inner._parameter_list):
        split = is_mp_split(p)
        leaves.append((p, split))
        st = inner._state.get(i, {})
        if "master_weight" in st:
            leaves.append((st["master_weight"], split))
    return leaves


def hybrid_replicas(hcg, optimizer):
    """After updates: every leaf bit-equal over the dp group, and the
    leaves not split over mp over the mp group (:func:`replica_diffs`
    of each)."""
    leaves = optimizer_leaves(optimizer)
    return {"dp": replica_diffs([t for t, _ in leaves],
                                hcg.get_data_parallel_group()),
            "mp": replica_diffs([t for t, sp in leaves if not sp],
                                hcg.get_model_parallel_group())}


def _equal(got, want):
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        return (isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
                and got.shape == want.shape
                and np.array_equal(got.astype(np.float32),
                                   want.astype(np.float32)))
    if isinstance(want, (tuple, list)) and isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(
            _equal(g, w) for g, w in zip(got, want))
    return got == want


def mismatches(got, want):
    """The names of ``want`` whose value in ``got`` differs (arrays
    compared exactly as fp32)."""
    return [k for k, w in want.items() if k not in got
            or not _equal(got[k], w)]


# -- world: every collective ---------------------------------------------------
def collectives_world(paddle, inputs):
    import torch
    dist = paddle.distributed
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()
    cpu = torch.device("cpu")
    res = {"rank": rank, "world": world, "backend": dist.get_backend()}
    res.update(exercise_collectives(paddle, cpu))
    comm = dist.communication
    public = comm.composed_counts()

    def t(a):
        return torch.tensor(np.asarray(a))

    x = base_value(rank)
    # the compositions gloo needs on CUDA tensors, run here on CPU ones
    comm.reset_counts()
    g = comm.get_group()
    res["composed_alltoall"] = np.stack([o.numpy() for o in
                                         comm._composed_alltoall(
                                             [t(x * 0 + 100 * rank + j)
                                              for j in range(world)], g)])
    work, _ = comm._host_send(t(x), (rank + 1) % world, g)
    v = t(np.zeros((2, 3), np.float32))
    rwork, host = comm._host_recv(v, (rank - 1) % world, g)
    work.wait()
    rwork.wait()
    res["host_send_recv"] = host.numpy()
    res["composed_counts"] = comm.composed_counts()
    comm.reset_counts()

    res.update(exercise_groups(paddle, cpu))
    sampler = paddle.io.DistributedBatchSampler(list(range(10)),
                                                batch_size=2)
    res["sampler"] = (sampler.nranks, sampler.local_rank, list(sampler))
    later = comm.composed_counts()
    res["composed"] = {k: public.get(k, 0) + later.get(k, 0)
                       for k in {**public, **later}}
    return res


def crash_world(paddle, inputs):
    """Rank 1 fails at once; the others would wait for it forever."""
    if int(os.environ["PADDLE_TRAINER_ID"]) == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(300)
    return {}


# -- world: the mp layers, DistributedRunner and the dygraph hybrid loop -------
def _fleet(paddle, hybrid):
    dist = paddle.distributed
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = hybrid
    dist.fleet.init(is_collective=True, strategy=strategy)
    return dist.fleet.get_hybrid_communicate_group()


def _gathered(group, value):
    """``value`` (a dict of numpy arrays) of every rank of ``group``."""
    from paddle_tpu_torch.distributed import all_gather_object
    out = []
    all_gather_object(out, value, group=group)
    return out


def mp_layer_cases(case, hcg):
    """One mp layer from the full numpy weights in ``case`` (its rank's
    shard), run on the case's input and cotangent; returns the output,
    the input's gradient and each weight's gradient, each joined over
    the mp group on the layer's split dims (so every rank returns the
    whole arrays)."""
    import torch
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl
    g = hcg.get_model_parallel_group()
    r, n = g.rank, g.nranks
    kind = case["kind"]

    def cols(a):
        k = a.shape[-1] // n
        return a[..., r * k:(r + 1) * k]

    def rows(a):
        k = a.shape[0] // n
        return a[r * k:(r + 1) * k]

    if kind == "pce":
        logits = torch.tensor(cols(case["logits"]), requires_grad=True)
        layer = mpl.ParallelCrossEntropy(ignore_index=case["ignore"])
        out = layer(logits, torch.tensor(case["label"]))
        out.backward(torch.tensor(case["g"]))
        parts = _gathered(g, logits.grad.numpy())
        return {"out": out.detach().numpy(),
                "dx": np.concatenate(parts, axis=-1)}
    if kind == "vocab":
        layer = mpl.VocabParallelEmbedding(*case["w"].shape, device="cpu")
        with torch.no_grad():
            layer.weight.copy_(torch.tensor(rows(case["w"])))
        out = layer(torch.tensor(case["x"]))
        out.backward(torch.tensor(case["g"]))
        parts = _gathered(g, layer.weight.grad.numpy())
        return {"out": out.detach().numpy(),
                "weight": np.concatenate(parts, axis=0)}
    col = kind.startswith("col")
    w = case["w"]
    if col:
        layer = mpl.ColumnParallelLinear(
            *w.shape, gather_output=kind == "col_gather", device="cpu")
        wl, bl = cols(w), cols(case["b"])
    else:
        layer = mpl.RowParallelLinear(
            *w.shape, input_is_parallel=kind == "row_parallel",
            device="cpu")
        wl, bl = rows(w), case["b"]
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(wl))
        layer.bias.copy_(torch.tensor(bl))
    x_full = case["x"]
    x = torch.tensor(cols(x_full) if kind == "row_parallel" else x_full,
                     requires_grad=True)
    out = layer(x)
    gy = case["g"] if kind != "col_local" else cols(case["g"])
    out.backward(torch.tensor(gy))
    res = {}
    join_out = kind == "col_local"
    res["out"] = np.concatenate(_gathered(g, out.detach().numpy()), -1) \
        if join_out else out.detach().numpy()
    res["dx"] = np.concatenate(_gathered(g, x.grad.numpy()), -1) \
        if kind == "row_parallel" else x.grad.numpy()
    gw = _gathered(g, layer.weight.grad.numpy())
    res["weight"] = np.concatenate(gw, axis=-1 if col else 0)
    gb = _gathered(g, layer.bias.grad.numpy())
    res["bias"] = np.concatenate(gb, -1) if col else gb[0]
    return res


def _gpt(inputs, hcg):
    from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                         state_dict_from_jax)
    cfg = gpt_tiny(**inputs["cfg"])
    net = GPTForCausalLM(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(
        inputs["state"], cfg, hcg.get_model_parallel_rank(),
        hcg.get_model_parallel_world_size()))
    return cfg, net


def _optimizer(paddle, inputs, net, kind):
    clip = paddle.nn.ClipGradByGlobalNorm(inputs["clip"])
    if kind == "adamw":
        return paddle.optimizer.AdamW(learning_rate=inputs["adam_lr"],
                                      parameters=net.parameters(),
                                      weight_decay=0.01, grad_clip=clip)
    return paddle.optimizer.SGD(learning_rate=inputs["lr"],
                                parameters=net.parameters(), grad_clip=clip)


def _full_state(cfg, net, hcg):
    from paddle_tpu_torch.models.gpt import merge_mp_states
    mine = {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}
    return merge_mp_states(_gathered(hcg.get_model_parallel_group(), mine),
                           cfg)


def hybrid_world(paddle, inputs):
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    dist = paddle.distributed
    dist.init_parallel_env()
    res = {"layers": {}, "runs": {}}
    hcg = _fleet(paddle, {"dp_degree": 2, "mp_degree": 2})
    for name, case in inputs["layers"].items():
        res["layers"][name] = mp_layer_cases(case, hcg)
    for name, run in inputs["runs"].items():
        hcg = _fleet(paddle, run["hybrid"])
        cfg, net = _gpt(inputs, hcg)
        opt = _optimizer(paddle, inputs, net, run.get("opt", "sgd"))
        crit = GPTPretrainingCriterion()
        if run.get("dygraph"):
            losses = _dygraph_loop(paddle, inputs, hcg, net, opt, crit,
                                   run["dygraph"])
        else:
            runner = DistributedRunner(net, opt, crit, **run["kw"])
            losses = [runner.train_step([x], [y])
                      for x, y in inputs["batches"]]
            runner.sync_to_layers()
        res["runs"][name] = {"losses": losses,
                             "state": _full_state(cfg, net, hcg)}
    res["random_init"] = _random_init_run(paddle, inputs)
    return res


def _random_init_run(paddle, inputs):
    """dp2 x mp2 from each mp rank's own random weights (a generator
    seeded by the mp rank, as a user's ``fleet.init`` program builds
    them): ``fleet.distributed_model`` starts the replicated weights
    from the mp group's first rank.  Two AdamW steps with the hybrid
    clip; at the second, the clip's square-sum against the whole
    gradient joined from every rank's shards; then the replicas."""
    import torch
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny)
    from paddle_tpu_torch.models.gpt import merge_mp_states
    fleet = paddle.distributed.fleet
    hcg = _fleet(paddle, {"dp_degree": 2, "mp_degree": 2})
    cfg = gpt_tiny(**inputs["cfg"])
    gen = torch.Generator().manual_seed(
        900 + hcg.get_model_parallel_rank())
    net = GPTForCausalLM(cfg, device="cpu", generator=gen)
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(
        _optimizer(paddle, inputs, net, "adamw"))
    crit = GPTPretrainingCriterion()
    r, n = hcg._data_rank(), hcg._get_data_group().nranks
    out = {}
    for step, (x, y) in enumerate(inputs["batches"][:2]):
        k = x.shape[0] // n
        loss = crit(model(paddle.to_tensor(x[r * k:(r + 1) * k])),
                    paddle.to_tensor(y[r * k:(r + 1) * k]))
        loss.backward()
        if step == 1:
            update = opt._hybrid_update()
            update.reduce()
            out["clip_sq_sum"] = float(update.sq_sum(update._targets()))
            grads = {name: p.grad.detach().numpy().copy()
                     for name, p in net.named_parameters()}
            full = merge_mp_states(
                _gathered(hcg.get_model_parallel_group(), grads), cfg)
            out["joined_sq_sum"] = float(sum(
                np.square(g.astype(np.float64)).sum()
                for g in full.values()))
            update.step(reduce=False)
        else:
            opt.step()
        opt.clear_grad()
    out["replicas"] = hybrid_replicas(hcg, opt)
    out["replicated_numel"] = sum(
        p.numel() for p, split in optimizer_leaves(opt) if not split)
    return out


def _dygraph_loop(paddle, inputs, hcg, net, opt, crit, how):
    """The user's loop: each rank feeds its data rows of the global batch
    as Paddle Tensors; the loss reported is the global batch's mean.
    ``how``: ``"fleet"`` (``fleet.distributed_model`` /
    ``distributed_optimizer``), ``"scaler"`` (the same with
    ``fleet.distributed_scaler`` around a ``GradScaler`` at 2**10) or
    ``"os_g"`` (``sharding.group_sharded_parallel``)."""
    import torch
    fleet = paddle.distributed.fleet
    scaler = None
    if how == "os_g":
        model, opt, _ = paddle.distributed.sharding.group_sharded_parallel(
            net, opt, level="os_g")
    else:
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(opt)
        if how == "scaler":
            scaler = fleet.distributed_scaler(
                paddle.amp.GradScaler(init_loss_scaling=1024.0))
    r, n = hcg._data_rank(), hcg._get_data_group().nranks
    losses = []
    for x, y in inputs["batches"]:
        k = x.shape[0] // n
        xs = paddle.to_tensor(x[r * k:(r + 1) * k])
        ys = paddle.to_tensor(y[r * k:(r + 1) * k])
        loss = crit(model(xs), ys)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        v = torch.tensor(float(loss))
        paddle.distributed.all_reduce(v, group=hcg._get_data_group())
        losses.append(float(v) / n)
    return losses


# -- world: pipeline parallel --------------------------------------------------
def _pipe_strategy(paddle, hybrid, acc):
    dist = paddle.distributed
    strategy = dist.fleet.DistributedStrategy()
    strategy.hybrid_configs = hybrid
    strategy.pipeline_configs = {"accumulate_steps": acc,
                                 "micro_batch_size": 2}
    dist.fleet.init(is_collective=True, strategy=strategy)
    return dist.fleet.get_hybrid_communicate_group()


def _pipe_gpt(inputs, hcg):
    """``GPTForCausalLMPipe`` of this rank's stage, from the JAX pipe
    model's numpy state cut into this rank's stage and mp shard."""
    from paddle_tpu_torch.models import GPTForCausalLMPipe, gpt_tiny
    from paddle_tpu_torch.models.gpt import state_dict_from_jax
    cfg = gpt_tiny(**inputs["cfg"])
    pp = hcg.get_pipe_parallel_world_size()
    net = GPTForCausalLMPipe(cfg, num_stages=pp, device="cpu")
    net.load_state_dict(state_dict_from_jax(
        inputs["state"], cfg, hcg.get_model_parallel_rank(),
        hcg.get_model_parallel_world_size(), hcg.get_stage_id(), pp))
    return cfg, net


def _stage_state(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def _pipe_run(paddle, inputs, run):
    """One layout: 3 steps of ``inputs["batches"]`` through
    ``fleet.distributed_model(...).train_batch`` (or ``PipelinedRunner``),
    SGD with the global-norm clip; this rank's losses and stage state."""
    import warnings
    from paddle_tpu_torch.distributed import PipelinedRunner
    hcg = _pipe_strategy(paddle, run["hybrid"], inputs["acc"])
    cfg, net = _pipe_gpt(inputs, hcg)
    opt = paddle.optimizer.SGD(
        learning_rate=inputs["lr"], parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(inputs["clip"]))
    out = {"coord": (hcg.get_data_parallel_rank(), hcg.get_stage_id(),
                     hcg.get_model_parallel_rank())}
    if run["route"] == "runner":
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            runner = PipelinedRunner(net, opt, accumulate_steps=inputs["acc"],
                                     amp_level="O2")
        out["warnings"] = [str(w.message) for w in caught]
        out["losses"] = [runner.train_step([x], [y])[0]
                         for x, y in inputs["batches"]]
        x, y = inputs["batches"][0]
        out["eval"] = runner.eval_step([x], [y])[0]
        out["stats"] = runner.compile_stats()
        try:
            runner.train_steps_folded([([x], [y])])
        except NotImplementedError as e:
            out["folded"] = str(e)
    else:
        model = paddle.distributed.fleet.distributed_model(net)
        out["wrapper"] = type(model).__name__
        if run["route"] == "untied":
            model._engine._hybrid_update(opt).tied = []
        losses = []
        for x, y in inputs["batches"]:
            loss = model.train_batch((x, y), opt)
            losses.append((type(loss).__name__, float(loss)))
        out["loss_types"] = sorted({t for t, _ in losses})
        out["losses"] = [v for _, v in losses]
    out["state"] = _stage_state(net)
    return out


def _spmd_cases(paddle, inputs):
    """``pipeline_spmd`` over the pp4 group and
    ``pipeline_spmd_interleaved`` (4 x 2 chunks): each rank's outputs and
    its stage's gradient of ``sum(out ** 2)``."""
    import torch
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        pipeline_spmd, pipeline_spmd_interleaved)
    hcg = _pipe_strategy(paddle, {"pp_degree": 4}, 1)
    d = hcg.get_stage_id()
    res = {}
    for name, case in inputs["spmd"].items():
        xs = torch.tensor(case["xs"])
        if name == "interleaved":
            ws = [torch.tensor(case["ws"][v * 4 + d], requires_grad=True)
                  for v in range(2)]
            out = pipeline_spmd_interleaved(
                lambda w, x: torch.tanh(x @ w), ws, xs, 4, 2)
        else:
            ws = [torch.tensor(case["ws"][d], requires_grad=True)]
            out = pipeline_spmd(lambda w, x: torch.tanh(x @ w), ws[0], xs, 4,
                                remat_stage=case["remat"])
        (out ** 2).sum().backward()
        res[name] = {"out": out.detach().numpy(),
                     "grads": [w.grad.numpy() for w in ws]}
    return res


def pipeline_world(paddle, inputs):
    dist = paddle.distributed
    dist.init_parallel_env()
    res = {"runs": {}}
    for name, run in inputs["runs"].items():
        res["runs"][name] = _pipe_run(paddle, inputs, run)
    res["spmd"] = _spmd_cases(paddle, inputs)
    return res


# -- world: context parallel, sequence parallel and ERNIE at stage 2 ----------
def _attention_cases(paddle, inputs):
    """Ring (contiguous and zigzag) and Ulysses attention at sep 4 on the
    global q, k, v of each case, cut into this rank's slices; the joined
    output and the gradients of the (replicated) global q, k, v."""
    import torch
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        context_parallel as cp
    hcg = _fleet(paddle, {"sep_degree": 4})
    group = hcg.get_sep_parallel_group()
    res = {}
    for name, case in inputs["attention"].items():
        q, k, v = (torch.tensor(case[n], requires_grad=True)
                   for n in ("q", "k", "v"))
        balanced = case["kind"] == "zigzag"
        split = cp.zigzag_split_sequence if balanced else cp.split_sequence
        ql, kl, vl = (split(t) for t in (q, k, v))
        if case["kind"] == "ulysses":
            ol = cp.ulysses_attention(ql, kl, vl, causal=case["causal"])
        else:
            ol = cp.ring_flash_attention(ql, kl, vl, causal=case["causal"],
                                         balanced=balanced)
        out = cp.zigzag_merge_sequence(ol) if balanced else \
            cp._gather_sequence(ol, group)
        (out * torch.tensor(case["w"])).sum().backward()
        res[name] = {"out": out.detach().numpy(), "dq": q.grad.numpy(),
                     "dk": k.grad.numpy(), "dv": v.grad.numpy()}
    return res


def _sep_runs(paddle, inputs):
    """``DistributedRunner`` on ``gpt_tiny`` at each sep layout: losses
    and the whole state joined over mp."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    out = {}
    for name, run in inputs["sep_runs"].items():
        hcg = _fleet(paddle, run["hybrid"])
        cfg, net = _gpt(dict(inputs, cfg=dict(inputs["cfg"],
                                              context_parallel=run["cp"])),
                        hcg)
        opt = _optimizer(paddle, inputs, net, "sgd")
        runner = DistributedRunner(net, opt, GPTPretrainingCriterion())
        losses = [runner.train_step([x], [y]) for x, y in inputs["batches"]]
        out[name] = {"losses": losses, "state": _full_state(cfg, net, hcg)}
    return out


def _sp_cases(paddle, inputs):
    """The sequence-parallel operators and linears at dp2 x mp2: each
    case's output and gradients, joined over the mp group."""
    import torch
    from paddle_tpu_torch.distributed.fleet.utils import \
        sequence_parallel_utils as sp
    hcg = _fleet(paddle, {"dp_degree": 2, "mp_degree": 2})
    g = hcg.get_model_parallel_group()
    r, n = g.rank, g.nranks

    def seq(a):
        k = a.shape[1] // n
        return a[:, r * k:(r + 1) * k]

    def join(a, axis=1):
        return np.concatenate(_gathered(g, a), axis=axis)

    res = {}
    for name, case in inputs["sp"].items():
        x, gy = case["x"], case["g"]
        if name in ("scatter", "gather", "allgather", "reducescatter"):
            share = (r + 1) / sum(range(1, n + 1))
            src = {"scatter": x, "gather": seq(x), "allgather": seq(x),
                   "reducescatter": x * share}[name]
            cot = {"scatter": seq(gy), "gather": gy,
                   "allgather": gy * share, "reducescatter": seq(gy)}[name]
            op = {"scatter": sp.ScatterOp, "gather": sp.GatherOp,
                  "allgather": sp.AllGatherOp,
                  "reducescatter": sp.ReduceScatterOp}[name]
            t = torch.tensor(np.ascontiguousarray(src), requires_grad=True)
            out = op.apply(t)
            out.backward(torch.tensor(np.ascontiguousarray(cot)))
            o, dx = out.detach().numpy(), t.grad.numpy()
            res[name] = {
                "out": join(o) if name in ("scatter", "reducescatter")
                else o,
                "dx": join(dx) if name in ("gather", "allgather") else dx}
            continue
        w, b = case["w"], case["b"]
        if name == "column":
            layer = sp.ColumnSequenceParallelLinear(*w.shape, device="cpu")
            k = w.shape[1] // n
            wl, bl = w[:, r * k:(r + 1) * k], b[r * k:(r + 1) * k]
            xin, cot = seq(x), gy
        else:
            layer = sp.RowSequenceParallelLinear(*w.shape, device="cpu")
            k = w.shape[0] // n
            wl, bl = w[r * k:(r + 1) * k], b
            xin, cot = x, seq(gy)
        with torch.no_grad():
            layer.weight.copy_(torch.tensor(np.ascontiguousarray(wl)))
            layer.bias.copy_(torch.tensor(np.ascontiguousarray(bl)))
        t = torch.tensor(np.ascontiguousarray(xin), requires_grad=True)
        out = layer(t)
        out.backward(torch.tensor(np.ascontiguousarray(cot)))
        gw = _gathered(g, layer.weight.grad.numpy())
        gb = _gathered(g, layer.bias.grad.numpy())
        if name == "column":
            res[name] = {"out": out.detach().numpy(), "dx": join(t.grad.numpy()),
                         "weight": np.concatenate(gw, -1),
                         "bias": np.concatenate(gb, -1)}
        else:
            res[name] = {"out": join(out.detach().numpy()),
                         "dx": t.grad.numpy(),
                         "weight": np.concatenate(gw, 0),
                         "bias": np.sum(gb, 0),
                         "bias_marked": bool(getattr(
                             layer.bias, "sequence_parallel", False))}
    return res


def _ernie_stage2(paddle, inputs):
    """ERNIE (``bert_tiny``) MLM under ``group_sharded_parallel(level=
    "os_g")`` at sharding 4: each rank's rows of the global batch, SGD
    with the global-norm clip; the losses (the ranks' mean) and the whole
    state."""
    import torch
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion, bert_tiny,
                                         bert_state_dict_from_jax)
    hcg = _fleet(paddle, {"sharding_degree": 4})
    net = BertForPretraining(bert_tiny(), device="cpu")
    net.load_state_dict(bert_state_dict_from_jax(inputs["ernie_state"], net))
    opt = _optimizer(paddle, inputs, net, "sgd")
    model, opt, _ = paddle.distributed.sharding.group_sharded_parallel(
        net, opt, level="os_g")
    crit = BertPretrainingCriterion(bert_tiny().vocab_size)
    r, n = hcg._data_rank(), hcg._get_data_group().nranks
    losses = []
    for x, y in inputs["ernie_batches"]:
        k = x.shape[0] // n
        mlm, nsp = model(paddle.to_tensor(x[r * k:(r + 1) * k]))
        loss = crit(mlm, nsp, paddle.to_tensor(y[r * k:(r + 1) * k]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        v = torch.tensor(float(loss))
        paddle.distributed.all_reduce(v, group=hcg._get_data_group())
        losses.append(float(v) / n)
    return {"losses": losses, "state": _stage_state(net)}


def context_world(paddle, inputs):
    dist = paddle.distributed
    dist.init_parallel_env()
    res = {"attention": _attention_cases(paddle, inputs)}
    res["sep_runs"] = _sep_runs(paddle, inputs)
    res["sp"] = _sp_cases(paddle, inputs)
    res["ernie"] = _ernie_stage2(paddle, inputs)
    return res


# -- world: the compressed dp path (tests/test_torch_dist_compressed.py) -----
def toy_data(step):
    """The JAX ``_toy`` test's batch of a step (``tests/
    test_dp_compressed.py::_data``)."""
    rng = np.random.RandomState(100 + step)
    return (rng.rand(8, 8).astype(np.float32),
            rng.rand(8, 4).astype(np.float32))


def toy_run(paddle, state, bits, shard, clip=None, acc=1, steps=3,
            runner_kw=None):
    """The JAX ``_toy`` model (``Linear(8, 16)``, ReLU, ``Linear(16, 4)``,
    Adam 1e-2, MSE) from ``state`` through ``DistributedRunner`` on the
    registered topology: losses, weights, optimizer bytes, byte model."""
    from paddle_tpu_torch.distributed import DistributedRunner
    nn = paddle.nn
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    net.set_state_dict(state)
    opt = paddle.optimizer.Adam(
        learning_rate=1e-2, parameters=net.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(clip) if clip else None)
    runner = DistributedRunner(net, opt, nn.MSELoss(), accumulate_steps=acc,
                               dp_compress_bits=bits, dp_shard_update=shard,
                               **(runner_kw or {}))
    losses = [runner.train_step([x], [y])
              for x, y in (toy_data(s) for s in range(steps))]
    return {"losses": losses,
            "params": {n: p.detach().numpy().copy()
                       for n, p in net.named_parameters()},
            "state_bytes": runner.optimizer_state_bytes(),
            "info": runner._dp_comm_info, "runner": runner, "net": net,
            "opt": opt}


TOY_RUNS = {"ref": (0, False), "b16": (16, False), "sh": (0, True),
            "sh16": (16, True), "b8": (8, False)}


def compressed_world2(paddle, inputs):
    """dp2: the JAX ``tests/test_dp_compressed.py`` runs of the toy."""
    from paddle_tpu_torch.observability import metrics
    paddle.distributed.init_parallel_env()
    _fleet(paddle, {"dp_degree": 2})
    state = inputs["toy_state"]
    res = {}

    def keep(run):
        return {k: run[k] for k in ("losses", "params", "state_bytes",
                                    "info")}

    for name, (bits, shard) in TOY_RUNS.items():
        res[name] = keep(toy_run(paddle, state, bits, shard))
    res["refc"] = keep(toy_run(paddle, state, 0, False, clip=0.5))
    res["sh16c"] = keep(toy_run(paddle, state, 16, True, clip=0.5))
    res["refa"] = keep(toy_run(paddle, state, 0, False, acc=2))
    res["sh16a"] = keep(toy_run(paddle, state, 16, True, acc=2))
    reg = metrics.registry()
    before = reg.counter("dp_allreduce_bytes_total").collect()
    run = toy_run(paddle, state, 8, True, steps=2)
    res["registry"] = {
        "bytes": reg.counter("dp_allreduce_bytes_total").collect() - before,
        "ratio": reg.gauge("dp_compress_ratio").collect(),
        "info": run["info"]}
    # the optimizer's state_dict presents the slices whole-shape
    sd = run["opt"].state_dict()
    res["state_dict"] = {k: (tuple(v.shape), getattr(v, "is_sharded_tensor",
                                                     False))
                         for k, v in sd.items() if k.endswith(".moment1")}
    return res


def _ring_results(paddle, inputs):
    import torch
    from paddle_tpu_torch.distributed import compressed as C
    dist = paddle.distributed
    r = dist.get_rank()
    halves = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = halves[r // 2]
    out = {}
    x = torch.tensor(inputs["ar"][r])
    out["ar16"] = C.quantized_all_reduce(x, bits=16).numpy()
    out["ar8"] = C.quantized_all_reduce(x, bits=8).numpy()
    out["trials"] = []
    for t in range(5):
        gen = torch.Generator().manual_seed(100 + t + 1000 * r)
        out["trials"].append(C.quantized_all_reduce(
            torch.tensor(inputs["trial"][r]), bits=8,
            generator=gen).numpy())
    rs = torch.tensor(inputs["rs"][r])
    out["rs16"] = C.ring_reduce_scatter(rs, shard_axis=0, bits=16).numpy()
    out["rs8"] = C.ring_reduce_scatter(rs, shard_axis=0, bits=8).numpy()
    out["rs16_axis1"] = C.ring_reduce_scatter(
        torch.tensor(inputs["rs1"][r]), shard_axis=1, bits=16).numpy()
    out["rs16_w2"] = C.ring_reduce_scatter(
        torch.tensor(inputs["rs2"][r]), group=pair, shard_axis=0,
        bits=16).numpy()
    out["bf16"] = C.bf16_all_reduce(torch.tensor(inputs["bf"][r])).numpy()
    out["tree"] = {}
    for mode in ("none", "bf16", "int8", "exact16"):
        tree = C.compressed_psum_tree(
            {"a": torch.tensor(inputs["g1"][r]),
             "b": torch.tensor(inputs["g2"][r])}, mode=mode)
        out["tree"][mode] = {k: v.numpy() for k, v in tree.items()}
    x = torch.tensor(inputs["ar"][r][:256 * 4 * 3])
    q, s = C._block_quant(x, 256, 8, noise=torch.zeros(12, 256))
    out["payload_dtypes"] = (str(q.dtype), str(s.dtype))
    return out


def compressed_world(paddle, inputs):
    """dp4: the rings over the world and a pair of two-rank groups, and the
    toy at dp4 (plain, int8 ring, exact ring with the sharded update)."""
    from paddle_tpu_torch.distributed import communication as comm
    paddle.distributed.init_parallel_env()
    res = {"rings": _ring_results(paddle, inputs)}
    _fleet(paddle, {"dp_degree": 4})
    state = inputs["toy_state"]
    for name, (bits, shard) in (("ref", (0, False)), ("b8", (8, False)),
                                ("sh16", (16, True)), ("sh8", (8, True))):
        comm.reset_counts()
        run = toy_run(paddle, state, bits, shard)
        res[name] = {"losses": run["losses"], "params": run["params"],
                     "state_bytes": run["state_bytes"], "info": run["info"],
                     "stats": comm.comm_stats()}
    return res


# -- world: the distributed checkpoint and the fused LMCE at mp > 1
#    (tests/test_torch_dist_checkpoint.py) ---------------------------------------
def _ckpt_gpt(paddle, inputs, hcg, kind="adamw", fused=False, state=None):
    """gpt_tiny from the JAX weights (this rank's mp shard), its optimizer
    (AdamW 1e-3 as the JAX checkpoint test, or SGD at ``inputs["lmce_lr"]``
    for the LMCE runs) and criterion."""
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         state_dict_from_jax,
                                         enable_fused_lmce)
    cfg = gpt_tiny(**inputs["cfg"])
    net = GPTForCausalLM(cfg, device="cpu")
    net.load_state_dict(state_dict_from_jax(
        inputs["state"] if state is None else state, cfg,
        hcg.get_model_parallel_rank(), hcg.get_model_parallel_world_size()))
    if kind == "adamw":
        opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=net.parameters())
    else:
        opt = paddle.optimizer.SGD(learning_rate=inputs["lmce_lr"],
                                   parameters=net.parameters())
    crit = GPTPretrainingCriterion()
    if fused:
        enable_fused_lmce(net, crit)
    return cfg, net, opt, crit


def _moments(opt, hcg, cfg, leaves):
    """``{"<leaf>.<moment>": whole moment}`` of AdamW's two moments of
    each of ``leaves``, joined over mp (numpy)."""
    from paddle_tpu_torch.models.gpt import merge_mp_states
    inner = getattr(opt, "_inner_opt", opt)
    mine = {}
    for leaf in leaves:
        st = inner._state[inner._param_names.index(leaf)]
        for slot in ("moment1", "moment2"):
            mine[f"{leaf}.{slot}"] = {leaf: st[slot].detach().numpy().copy()}
    parts = _gathered(hcg.get_model_parallel_group(), mine)
    return {k: merge_mp_states([p[k] for p in parts], cfg)[k.rsplit(
        ".", 1)[0]] for k in mine}


def _ckpt_layouts(paddle, inputs):
    """Save at dp2 x mp2 (runner state and the manager), resume in the
    same layout, at dp4, under stage 2 and back."""
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed.checkpoint import (
        CheckpointManager, load_runner_state, save_runner_state)
    import torch
    dist = paddle.distributed
    root = inputs["dir"]
    x, y = inputs["batch"]
    out = {}
    hcg = _fleet(paddle, {"dp_degree": 2, "mp_degree": 2})
    cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg)
    runner = DistributedRunner(net, opt, crit)
    mgr = CheckpointManager(os.path.join(root, "mgr"), save_interval_steps=2,
                            max_to_keep=2, async_save=False)
    losses = []
    for step in (1, 2, 3, 4):
        losses.append(runner.train_step([x], [y]))
        if step == 2:
            save_runner_state(runner, os.path.join(root, "src"))
            out["moment_src"] = _moments(opt, hcg, cfg, inputs["leaves"])
        mgr.save(step, net, opt)
    out["losses"] = losses
    out["state4"] = _full_state(cfg, net, hcg)
    out["mgr_steps"] = mgr.all_steps()
    out["mgr_files"] = sorted(json.load(open(os.path.join(
        root, "mgr", "4", "RESILIENCE_MANIFEST.json")))["files"])
    out["mgr_verified"] = [mgr.verify_step(s) for s in mgr.all_steps()]
    # (a) the same layout, fresh runner, from the step-2 runner state
    cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg,
                                    state=inputs["other_state"])
    runner = DistributedRunner(net, opt, crit)
    load_runner_state(runner, os.path.join(root, "src"))
    out["same"] = [runner.train_step([x], [y]) for _ in range(2)]
    out["same_state"] = _full_state(cfg, net, hcg)
    # the manager: step 4 torn on rank 2's file, restore() returns 2
    dist.barrier()
    if dist.get_rank() == 2:
        victim = os.path.join(root, "mgr", "4", "rank2.pt")
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
    dist.barrier()
    cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg,
                                    state=inputs["other_state"])
    mgr = CheckpointManager(os.path.join(root, "mgr"), async_save=False)
    out["torn_verified"] = mgr.verify_step(4)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["restored"] = mgr.restore(net, opt)
    out["restore_warnings"] = [str(w.message) for w in caught]
    runner = DistributedRunner(net, opt, crit)
    out["after_restore"] = [runner.train_step([x], [y]) for _ in range(2)]
    # (b) dp4
    hcg = _fleet(paddle, {"dp_degree": 4})
    cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg,
                                    state=inputs["other_state"])
    runner = DistributedRunner(net, opt, crit)
    load_runner_state(runner, os.path.join(root, "src"))
    out["dp4_moments"] = _moments(opt, hcg, cfg, inputs["leaves"])
    # steps 3 and 4: step 4's loss and the weights after it read the
    # resharded moments
    out["dp4"] = [runner.train_step([x], [y]) for _ in range(2)]
    out["dp4_step"] = opt._global_step
    out["dp4_state"] = _full_state(cfg, net, hcg)
    # stage 2 over four ranks: each chunk the new layout's
    hcg = _fleet(paddle, {"sharding_degree": 4})
    cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg,
                                    state=inputs["other_state"])
    runner = DistributedRunner(net, opt, crit, sharding_stage=2)
    load_runner_state(runner, os.path.join(root, "src"))
    sharded = runner._update.sharded
    i = [e[0] for e in sharded.entries].index(inputs["leaf"])
    out["stage2_chunk"] = sharded.optimizer._state[i]["moment1"].numpy(
        ).copy()
    out["stage2_chunk_len"] = sharded.entries[i][3]
    out["stage2"] = [runner.train_step([x], [y])]
    save_runner_state(runner, os.path.join(root, "st2"))
    out["stage2"].append(runner.train_step([x], [y]))
    out["stage2_state"] = _full_state(cfg, net, hcg)
    # ... and back into dp2 x mp2
    hcg = _fleet(paddle, {"dp_degree": 2, "mp_degree": 2})
    cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg)
    runner = DistributedRunner(net, opt, crit)
    load_runner_state(runner, os.path.join(root, "st2"))
    out["from_stage2"] = runner.train_step([x], [y])
    return out


def _ckpt_plain_tree(paddle, inputs):
    """A row-split tree saved over four ranks, loaded column-split."""
    import torch
    from paddle_tpu_torch.distributed.checkpoint import (
        Layout, ShardedTensor, load_state_dict, save_state_dict)
    r = paddle.distributed.get_rank()
    w = np.arange(32, dtype=np.float32).reshape(8, 4)
    rows = Layout((8, 4), [((2 * r, 0), (2, 4), 0)], (2, 4))
    path = os.path.join(inputs["dir"], "tree")
    save_state_dict({"w": ShardedTensor(torch.tensor(w[2 * r:2 * r + 2]),
                                        rows),
                     "b": torch.ones(4), "step": 7}, path)
    col = Layout((8, 4), [((0, r), (8, 1), 0)], (8, 1))
    tgt = {"w": ShardedTensor(torch.zeros(8, 1), col),
           "b": torch.zeros(4), "step": 0}
    load_state_dict(tgt, path)
    return {"w": tgt["w"].local.numpy(), "b": tgt["b"].numpy(),
            "step": tgt["step"]}


def _ckpt_sharded_update(paddle, inputs):
    """The dp4 sharded update (exact ring) saved by the manager and
    resumed bit-identically in a fresh runner from other weights; the
    same checkpoint into an unsharded runner holds the whole moments."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    _fleet(paddle, {"dp_degree": 4})
    state, other = inputs["toy_state"], inputs["toy_other"]
    path = os.path.join(inputs["dir"], "shup")
    ref = toy_run(paddle, state, 16, True, steps=6)
    first = toy_run(paddle, state, 16, True, steps=0)
    with CheckpointManager(path, async_save=True) as mgr:
        for s in range(3):
            first["runner"].train_step(*map(lambda a: [a], toy_data(s)))
            # async: the next step updates the weights while the files
            # are written; the save holds the host copy taken here
            mgr.save(s + 1, first["net"], first["opt"], force=True)
    moments = {k: v for k, v in first["opt"].state_dict().items()
               if k.endswith(".moment1")}
    again = toy_run(paddle, other, 16, True, steps=0)
    mgr = CheckpointManager(path, async_save=False)
    step = mgr.restore(again["net"], again["opt"])
    for s in range(3, 6):
        again["runner"].train_step(*map(lambda a: [a], toy_data(s)))
    plain = toy_run(paddle, other, 0, False, steps=0)
    mgr.restore(plain["net"], plain["opt"], step=3)
    whole = {k: v for k, v in plain["opt"].state_dict().items()
             if k.endswith(".moment1")}
    return {"step": step,
            "ref": ref["params"],
            "resumed": {n: p.detach().numpy().copy()
                        for n, p in again["net"].named_parameters()},
            "slices": {k: (v.local.numpy(), v.layout.segments)
                       for k, v in moments.items()},
            "whole": {k: v.numpy() for k, v in whole.items()}}


def _lmce_runs(paddle, inputs):
    """``enable_fused_lmce`` at mp2 (dp2 x mp2) and mp4: three SGD steps
    through ``DistributedRunner`` (the whole weights after each), and
    the composition's plain version against ``lmce_reference`` on the
    whole vocabulary."""
    import torch
    from paddle_tpu_torch.distributed import DistributedRunner
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_ops import (
        vocab_parallel_lmce, vocab_parallel_lmce_reference)
    from paddle_tpu_torch.ops import lmce_kernel as lk
    out = {}
    x, y = inputs["lmce_batch"]
    for name, hybrid in (("mp2", {"dp_degree": 2, "mp_degree": 2}),
                         ("mp4", {"mp_degree": 4})):
        hcg = _fleet(paddle, hybrid)
        cfg, net, opt, crit = _ckpt_gpt(paddle, inputs, hcg, kind="sgd",
                                        fused=True)
        runner = DistributedRunner(net, opt, crit)
        lk.reset_counts()
        losses, states = [], []
        for _ in range(3):
            losses.append(runner.train_step([x], [y]))
            states.append(_full_state(cfg, net, hcg))
        out[name] = {"losses": losses, "states": states,
                     "plain_calls": {f.__name__: f.plain_calls
                                     for f in lk.WRAPPERS}}
        # the composition and its plain version on the whole vocabulary
        g = hcg.get_model_parallel_group()
        rng = np.random.default_rng(5)
        h = rng.standard_normal((24, 16)).astype(np.float32)
        w = rng.standard_normal((64, 16)).astype(np.float32)
        lab = rng.integers(0, 64, 24)
        lab[[2, 9]] = -100
        lab[5] = -1
        n, rk = g.nranks, g.rank
        per = 64 // n
        res = {}
        for kind, fn in (("kernel", vocab_parallel_lmce),
                         ("plain", vocab_parallel_lmce_reference)):
            ht = torch.tensor(h, requires_grad=True)
            wt = torch.tensor(w[rk * per:(rk + 1) * per], requires_grad=True)
            loss = fn(ht, wt, torch.tensor(lab), g)
            (loss * torch.arange(24.0)).sum().backward()
            dw = _gathered(g, {"dw": wt.grad.numpy()})
            res[kind] = {"loss": loss.detach().numpy(),
                         "dh": ht.grad.numpy(),   # this rank's share
                         "dw": np.concatenate([d["dw"] for d in dw])}
        ht = torch.tensor(h, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        loss, _ = lk.lmce_reference(ht, wt, torch.tensor(lab))
        (loss * torch.arange(24.0)).sum().backward()
        res["whole"] = {"loss": loss.detach().numpy(), "dh": ht.grad.numpy(),
                        "dw": wt.grad.numpy()}
        dh = _gathered(g, {"dh": res["kernel"]["dh"]})
        res["kernel"]["dh"] = sum(d["dh"] for d in dh)
        dh = _gathered(g, {"dh": res["plain"]["dh"]})
        res["plain"]["dh"] = sum(d["dh"] for d in dh)
        out[name]["composition"] = res
    return out


def checkpoint_world(paddle, inputs):
    import torch
    paddle.distributed.init_parallel_env()
    torch.manual_seed(0)
    res = {"layouts": _ckpt_layouts(paddle, inputs),
           "tree": _ckpt_plain_tree(paddle, inputs),
           "shup": _ckpt_sharded_update(paddle, inputs),
           "lmce": _lmce_runs(paddle, inputs)}
    return res
