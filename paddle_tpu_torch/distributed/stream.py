"""``paddle.distributed.stream`` (counterpart of
``paddle_tpu/distributed/stream.py``; upstream
``python/paddle/distributed/communication/stream/``): the collectives
with the ``use_calc_stream`` knob, which the port accepts and ignores
(torch.distributed orders its collectives on the current stream)."""

from . import communication as _c


def _strip(kwargs):
    kwargs.pop("use_calc_stream", None)
    return kwargs


def all_reduce(tensor, op=None, group=None, sync_op=True, **kw):
    return _c.all_reduce(tensor, op if op is not None else _c.ReduceOp.SUM,
                         group, sync_op=sync_op, **_strip(kw))


def all_gather(tensor_list, tensor, group=None, sync_op=True, **kw):
    return _c.all_gather(tensor_list, tensor, group, sync_op=sync_op,
                         **_strip(kw))


def broadcast(tensor, src=0, group=None, sync_op=True, **kw):
    return _c.broadcast(tensor, src, group, sync_op=sync_op, **_strip(kw))


def reduce(tensor, dst=0, op=None, group=None, sync_op=True, **kw):
    return _c.reduce(tensor, dst, op if op is not None else _c.ReduceOp.SUM,
                     group, sync_op=sync_op, **_strip(kw))


def reduce_scatter(tensor, tensor_list, op=None, group=None,
                   sync_op=True, **kw):
    return _c.reduce_scatter(tensor, tensor_list,
                             op if op is not None else _c.ReduceOp.SUM,
                             group, sync_op=sync_op, **_strip(kw))


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             **kw):
    return _c.alltoall(out_tensor_list, in_tensor_list, group,
                       sync_op=sync_op, **_strip(kw))


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    **kw):
    return _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                              out_split_sizes, group, sync_op=sync_op,
                              **_strip(kw))


def send(tensor, dst=0, group=None, sync_op=True, **kw):
    return _c.send(tensor, dst, group, sync_op=sync_op, **_strip(kw))


def recv(tensor, src=0, group=None, sync_op=True, **kw):
    return _c.recv(tensor, src, group, sync_op=sync_op, **_strip(kw))


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            **kw):
    return _c.scatter(tensor, tensor_list, src, group, sync_op=sync_op,
                      **_strip(kw))
