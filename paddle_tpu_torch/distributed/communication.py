"""Collectives (counterpart of ``paddle_tpu/distributed/communication.py``,
upstream ``python/paddle/distributed/communication/``).

Each collective takes Paddle's signature and runs on
``torch.distributed``: a Paddle ``Tensor`` or a torch tensor, changed in
place (Paddle's semantics), ``sync_op`` (False returns a task whose
``wait()`` finishes it) and a :class:`Group` (the default group when
None).  A group without a process group (no world was started, or a
one-rank subgroup) runs nothing: the tensor is the result, as the JAX
package's eager collectives are on one device.  A world of one rank
started on a backend runs every collective through it.

Backends (``parallel.init_parallel_env``): NCCL when every rank has a
card of its own, gloo otherwise.  Gloo lacks some collectives on CUDA
tensors (PyTorch 2.11 on the H100: the list ``all_to_all`` raises, and
``send`` / ``recv`` abort the process, ``writev: Bad address``); for
those the port composes the result from what gloo has, each in one
named function below, and counts each use in :func:`composed_counts`:

- ``alltoall``: an ``all_gather`` of every rank's inputs, then the
  chunks addressed to this rank (``_composed_alltoall``);
- ``send`` / ``recv``: gloo's CPU ``isend`` / ``irecv`` on a host copy
  (``_host_send``, ``_host_recv``).

The rest (``reduce_scatter``, ``alltoall_single``, ``gather``,
``scatter``, ``reduce``) gloo runs on CUDA tensors itself.

Every call also adds to :func:`comm_stats` (calls, bytes this rank
passes in, host seconds until done), which the training phases read as
the collective traffic a step; ``comm_stats(by_axis=True)`` keys them
by the group's topology axis too (``all_reduce@mp``, ``send@pp``).

Object collectives are ``torch.distributed``'s (pickles moved as byte
tensors, on the current card under NCCL).
"""

from __future__ import annotations

import pickle
import time
from typing import List, Optional

import torch
import torch.distributed as dist


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}

#: collectives that gloo runs on CPU tensors only: on CUDA tensors the
#: port composes them (module docstring)
GLOO_CUDA_COMPOSED = frozenset({"alltoall", "send", "recv"})


class Group:
    """A communicator: the ordered global ranks, the torch process group
    this rank holds for them (None when it is not a member or the group
    has one rank) and, for the hybrid groups, the topology axis."""

    _next_id = [0]

    def __init__(self, ranks: List[int], pg=None, axis_name=None,
                 backend: Optional[str] = None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.pg = pg
        self.axis_name = axis_name
        self.backend = backend
        self.id = Group._next_id[0]
        Group._next_id[0] += 1

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank) if global_rank in self.ranks \
            else -1

    @property
    def rank(self):
        from .parallel import get_rank
        return self.get_group_rank(get_rank())

    def __repr__(self):
        return (f"Group(id={self.id}, nranks={self.nranks}, "
                f"ranks={self.ranks}, axis={self.axis_name})")


_default_group: Optional[Group] = None
_composed = {}
_stats = {}


def composed_counts() -> dict:
    """``{collective: uses}`` of the compositions run since the last
    :func:`reset_counts`."""
    return dict(_composed)


def comm_stats(by_axis: bool = False) -> dict:
    """``{collective: {"calls", "bytes", "seconds"}}`` since the last
    :func:`reset_counts`: bytes are this rank's input bytes, seconds the
    host time until each call was done (its ``wait`` included).  With
    ``by_axis`` the keys are ``collective@axis``, the axis of the
    group's topology (``dp``, ``mp``, ``pp``, ``sep``, ...; ``world``
    for a group without one)."""
    out = {}
    for (name, axis), v in _stats.items():
        s = out.setdefault(f"{name}@{axis}" if by_axis else name,
                           {"calls": 0, "bytes": 0, "seconds": 0.0})
        for k in s:
            s[k] += v[k]
    return out


def reset_counts() -> None:
    _composed.clear()
    _stats.clear()


def _count(name: str, nbytes: int, seconds: float, axis=None) -> None:
    if axis is None:
        axis = "world"
    elif not isinstance(axis, str):
        axis = "+".join(axis)
    s = _stats.setdefault((name, axis),
                          {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += int(nbytes)
    s["seconds"] += seconds


def _note_composed(name: str) -> None:
    _composed[name] = _composed.get(name, 0) + 1


def _get_default_group() -> Group:
    global _default_group
    if _default_group is None:
        from .parallel import get_world_size
        world = get_world_size()
        pg = dist.group.WORLD if dist.is_initialized() else None
        _default_group = Group(list(range(world)), pg=pg,
                               backend=_backend_name(pg))
    return _default_group


def _backend_name(pg) -> Optional[str]:
    return None if pg is None else str(dist.get_backend(pg)).lower()


def get_group(group: Optional[Group] = None) -> Group:
    return group if group is not None else _get_default_group()


def new_group(ranks=None, backend=None, timeout=None, axis_name=None
              ) -> Group:
    """A group of ``ranks`` (every rank when None).  As with
    ``torch.distributed.new_group``, every rank of the world must call
    it, members or not, in the same order."""
    from .parallel import get_world_size, get_rank
    world = get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(int(r) for r in
                                                             ranks)
    pg = None
    # a one-rank group needs no process group; every rank skips it alike
    if dist.is_initialized() and world > 1 and len(ranks) > 1:
        kw = {} if timeout is None else {"timeout": timeout}
        handle = dist.new_group(ranks, backend=backend, **kw)
        if get_rank() in ranks:
            pg = handle
    return Group(ranks, pg=pg, axis_name=axis_name,
                 backend=_backend_name(pg))


def _value(t):
    return t._value if hasattr(t, "_value") else t


def _gloo_cuda(g: Group, t: torch.Tensor) -> bool:
    return g.backend == "gloo" and t.is_cuda


def _group_rank_of(g: Group, rank: int) -> int:
    """``rank`` as Paddle passes it (a global rank) within ``g``."""
    r = g.get_group_rank(rank)
    if r < 0:
        raise ValueError(f"rank {rank} is not in {g}")
    return r


class _Task:
    """The task an async collective returns: ``wait()`` finishes it
    (and adds its host time to :func:`comm_stats`)."""

    def __init__(self, name, nbytes, works=(), after=None, t0=None,
                 axis=None):
        self._name, self._nbytes, self._axis = name, nbytes, axis
        self._works = [w for w in works if w is not None]
        self._after = after
        self._t0 = time.perf_counter() if t0 is None else t0
        self._done = False

    def wait(self, timeout=None):
        if self._done:
            return True
        for w in self._works:
            w.wait()
        if self._after is not None:
            self._after()
        self._done = True
        _count(self._name, self._nbytes, time.perf_counter() - self._t0,
               self._axis)
        return True

    def is_completed(self):
        return self._done


def _finish(task: _Task, sync_op: bool):
    if sync_op:
        task.wait()
    return task


def _noop(name):
    task = _Task(name, 0)
    task._done = True
    return task


# -- the tensor collectives --------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op: bool = True):
    g = get_group(group)
    if g.pg is None:
        return _noop("all_reduce")
    v = _value(tensor)
    t0 = time.perf_counter()
    work = dist.all_reduce(v, op=_TORCH_OPS[op], group=g.pg,
                           async_op=True)
    after = (lambda: v.div_(g.nranks)) if op == ReduceOp.AVG else None
    return _finish(_Task("all_reduce", v.numel() * v.element_size(), [work],
                         after, t0, axis=g.axis_name), sync_op)


def all_gather(tensor_list, tensor, group: Optional[Group] = None,
               sync_op: bool = True):
    """Every rank's ``tensor``, in group order, appended to
    ``tensor_list`` (Paddle's list form)."""
    g = get_group(group)
    v = _value(tensor)
    if g.pg is None:
        tensor_list.append(tensor)
        return _noop("all_gather")
    t0 = time.perf_counter()
    outs = [torch.empty_like(v) for _ in range(g.nranks)]
    work = dist.all_gather(outs, v.contiguous(), group=g.pg, async_op=True)
    wrap = _wrapper_like(tensor)
    tensor_list.extend(wrap(o) for o in outs)
    return _finish(_Task("all_gather", v.numel() * v.element_size(), [work],
                         None, t0, axis=g.axis_name), sync_op)


def _wrapper_like(tensor):
    if hasattr(tensor, "_value"):
        from ..tensor import Tensor
        return lambda v: Tensor(v)
    return lambda v: v


def broadcast(tensor, src: int = 0, group: Optional[Group] = None,
              sync_op: bool = True):
    g = get_group(group)
    if g.pg is None:
        return _noop("broadcast")
    _group_rank_of(g, src)
    v = _value(tensor)
    t0 = time.perf_counter()
    work = dist.broadcast(v, src=src, group=g.pg, async_op=True)
    return _finish(_Task("broadcast", v.numel() * v.element_size(), [work],
                         None, t0, axis=g.axis_name), sync_op)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None,
           sync_op: bool = True):
    """The reduction lands on ``dst``; the other ranks' tensors are left
    as the backend leaves them (torch's rule)."""
    g = get_group(group)
    if g.pg is None:
        return _noop("reduce")
    _group_rank_of(g, dst)
    v = _value(tensor)
    t0 = time.perf_counter()
    work = dist.reduce(v, dst=dst, op=_TORCH_OPS[op], group=g.pg,
                       async_op=True)
    rank = g.rank
    after = (lambda: v.div_(g.nranks)) \
        if op == ReduceOp.AVG and g.ranks[rank] == dst else None
    return _finish(_Task("reduce", v.numel() * v.element_size(), [work],
                         after, t0, axis=g.axis_name), sync_op)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op: bool = True):
    """``tensor`` gets this rank's chunk of the reduction: chunk ``i`` of
    ``tensor_list`` (one entry a rank), or of ``tensor`` itself split on
    dim 0 when ``tensor_list`` is None (the JAX package's form), in
    which case ``tensor`` is replaced by a Tensor of its chunk."""
    g = get_group(group)
    if tensor_list is not None:
        src = torch.cat([_value(t).reshape(-1) for t in tensor_list])
        shape = _value(tensor_list[0]).shape
        out = _value(tensor)
    else:
        src = _value(tensor)
        shape = (src.shape[0] // max(g.nranks, 1),) + tuple(src.shape[1:])
        out = None
    if g.pg is None:
        if tensor_list is not None:
            out.copy_(_value(tensor_list[0]))
        return _noop("reduce_scatter")
    t0 = time.perf_counter()
    nbytes = src.numel() * src.element_size()
    res = torch.empty(src.numel() // g.nranks, dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(res, src.reshape(-1).contiguous(),
                               op=_TORCH_OPS[op], group=g.pg)
    if op == ReduceOp.AVG:
        res.div_(g.nranks)
    res = res.view(shape)
    if out is not None:
        out.copy_(res)
    else:
        _set_value(tensor, res)
    return _finish(_Task("reduce_scatter", nbytes, (), None, t0,
                         axis=g.axis_name), sync_op)


def _set_value(tensor, value):
    if hasattr(tensor, "_value"):
        tensor._value = value
    else:
        tensor.data = value


def alltoall(out_tensor_list, in_tensor_list, group=None,
             sync_op: bool = True):
    """Rank ``j`` gets ``in_tensor_list[j]`` of every rank, appended to
    ``out_tensor_list`` in group order."""
    g = get_group(group)
    if g.pg is None:
        out_tensor_list.extend(in_tensor_list)
        return _noop("alltoall")
    ins = [_value(t).contiguous() for t in in_tensor_list]
    t0 = time.perf_counter()
    nbytes = sum(t.numel() * t.element_size() for t in ins)
    if _gloo_cuda(g, ins[0]):
        outs = _composed_alltoall(ins, g)
    else:
        outs = [torch.empty_like(t) for t in ins]
        dist.all_to_all(outs, ins, group=g.pg)
    wrap = _wrapper_like(in_tensor_list[0])
    out_tensor_list.extend(wrap(o) for o in outs)
    return _finish(_Task("alltoall", nbytes, (), None, t0,
                         axis=g.axis_name), sync_op)


all_to_all = alltoall


def _composed_alltoall(ins, g: Group):
    """alltoall on gloo over CUDA tensors: ``all_gather`` of every
    rank's concatenated inputs, then the chunks addressed to this rank
    (equal chunk shapes, as ``alltoall`` takes them)."""
    _note_composed("alltoall")
    flat = torch.cat([t.reshape(-1) for t in ins])
    got = [torch.empty_like(flat) for _ in range(g.nranks)]
    dist.all_gather(got, flat, group=g.pg)
    n = ins[0].numel()
    me = g.rank
    return [got[j][me * n:(me + 1) * n].view_as(ins[0]).clone()
            for j in range(g.nranks)]


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op: bool = True):
    """Dim 0 of ``in_tensor`` split into one chunk a rank (equal chunks
    unless split sizes are given), exchanged, into ``out_tensor``."""
    g = get_group(group)
    src, out = _value(in_tensor), _value(out_tensor)
    if g.pg is None:
        out.copy_(src)
        return _noop("alltoall_single")
    t0 = time.perf_counter()
    nbytes = src.numel() * src.element_size()
    dist.all_to_all_single(out, src.contiguous(),
                           output_split_sizes=out_split_sizes,
                           input_split_sizes=in_split_sizes, group=g.pg)
    return _finish(_Task("alltoall_single", nbytes, (), None, t0,
                         axis=g.axis_name), sync_op)


def send(tensor, dst: int = 0, group=None, sync_op: bool = True):
    g = get_group(group)
    if g.pg is None:
        return _noop("send")
    v = _value(tensor)
    t0 = time.perf_counter()
    nbytes = v.numel() * v.element_size()
    if _gloo_cuda(g, v):
        work, keep = _host_send(v, dst, g)
        return _finish(_Task("send", nbytes, [work], keep.clear, t0,
                             axis=g.axis_name),
                       sync_op)
    work = dist.isend(v.contiguous(), dst=dst, group=g.pg)
    return _finish(_Task("send", nbytes, [work], None, t0,
                         axis=g.axis_name), sync_op)


def _host_send(v, dst, g):
    """send on gloo over a CUDA tensor: gloo's CPU ``isend`` of a host
    copy (kept until the task finishes)."""
    _note_composed("send")
    host = v.cpu()
    return dist.isend(host, dst=dst, group=g.pg), [host]


def recv(tensor, src: int = 0, group=None, sync_op: bool = True):
    g = get_group(group)
    if g.pg is None:
        return _noop("recv")
    v = _value(tensor)
    t0 = time.perf_counter()
    nbytes = v.numel() * v.element_size()
    if _gloo_cuda(g, v):
        work, host = _host_recv(v, src, g)
        return _finish(_Task("recv", nbytes, [work],
                             lambda: v.copy_(host), t0,
                             axis=g.axis_name), sync_op)
    work = dist.irecv(v, src=src, group=g.pg)
    return _finish(_Task("recv", nbytes, [work], None, t0,
                         axis=g.axis_name), sync_op)


def _host_recv(v, src, g):
    """recv on gloo into a CUDA tensor: gloo's CPU ``irecv`` into a host
    buffer, copied to the card when the task finishes."""
    _note_composed("recv")
    host = torch.empty(v.shape, dtype=v.dtype)
    return dist.irecv(host, src=src, group=g.pg), host


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op: bool = True):
    """``tensor`` gets ``tensor_list[i]`` of rank ``src`` on group rank
    ``i``."""
    g = get_group(group)
    v = _value(tensor)
    if g.pg is None:
        if tensor_list:
            v.copy_(_value(tensor_list[0]))
        return _noop("scatter")
    t0 = time.perf_counter()
    is_src = g.ranks[g.rank] == src
    ins = [_value(t).contiguous() for t in tensor_list] if is_src else None
    work = dist.scatter(v, ins, src=src, group=g.pg, async_op=True)
    return _finish(_Task("scatter", v.numel() * v.element_size(), [work],
                         None, t0, axis=g.axis_name), sync_op)


def gather(tensor, gather_list=None, dst: int = 0, group=None,
           sync_op: bool = True):
    """Every rank's ``tensor`` appended to ``gather_list`` on ``dst``
    (in group order); other ranks' lists stay as they are."""
    g = get_group(group)
    v = _value(tensor)
    if g.pg is None:
        if gather_list is not None:
            gather_list.append(tensor)
        return _noop("gather")
    t0 = time.perf_counter()
    is_dst = g.ranks[g.rank] == dst
    outs = [torch.empty_like(v) for _ in range(g.nranks)] if is_dst else None
    work = dist.gather(v.contiguous(), outs, dst=dst, group=g.pg,
                       async_op=True)
    if is_dst and gather_list is not None:
        wrap = _wrapper_like(tensor)
        gather_list.extend(wrap(o) for o in outs)
    return _finish(_Task("gather", v.numel() * v.element_size(), [work],
                         None, t0, axis=g.axis_name), sync_op)


def barrier(group=None):
    g = get_group(group)
    if g.pg is None:
        return
    if g.backend == "nccl":
        dist.barrier(group=g.pg, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=g.pg)


def wait(tensor, group=None, use_calc_stream=True):
    """Paddle's ``wait``: the collectives above finish before they
    return unless ``sync_op=False`` (then ``task.wait()``); on the card
    this orders the current stream behind the tensor's work."""
    v = _value(tensor)
    if isinstance(v, torch.Tensor) and v.is_cuda:
        torch.cuda.current_stream(v.device).synchronize()


# -- object collectives ------------------------------------------------------
def all_gather_object(object_list, obj, group=None):
    g = get_group(group)
    if g.pg is None:
        object_list.append(obj)
        return object_list
    t0 = time.perf_counter()
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.pg)
    object_list.extend(out)
    _count("all_gather_object", len(pickle.dumps(obj)),
           time.perf_counter() - t0)
    return object_list


def broadcast_object_list(object_list, src: int = 0, group=None):
    g = get_group(group)
    if g.pg is None:
        return object_list
    t0 = time.perf_counter()
    dist.broadcast_object_list(object_list, src=src, group=g.pg)
    _count("broadcast_object_list", 0, time.perf_counter() - t0)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    g = get_group(group)
    if g.pg is None:
        out_object_list.append(in_object_list[0] if in_object_list
                               else None)
        return out_object_list
    t0 = time.perf_counter()
    holder = [None]
    is_src = g.ranks[g.rank] == src
    dist.scatter_object_list(holder, in_object_list if is_src else None,
                             src=src, group=g.pg)
    out_object_list.append(holder[0])
    _count("scatter_object_list", 0, time.perf_counter() - t0)
    return out_object_list


def destroy_process_group(group=None):
    """Destroying the default group ends the world (and the hybrid
    groups with it); a sub-group's process group is destroyed alone."""
    global _default_group
    if group is None:
        if dist.is_initialized():
            dist.destroy_process_group()
        _default_group = None
        from . import collective as _coll
        _coll.set_mesh(None)
        from . import parallel as _par
        _par._parallel_env_initialized[0] = False
        return None
    if group.pg is not None:
        dist.destroy_process_group(group.pg)
        group.pg = None
    return None


def _reset_default_group():
    global _default_group
    _default_group = None
