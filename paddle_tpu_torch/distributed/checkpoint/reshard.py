"""The distributed checkpoint's format, its save and its reshard-on-load
(counterpart of ``paddle_tpu/distributed/checkpoint/reshard.py``).

The JAX package hands sharded arrays to orbax, which records each
shard's place and restores into the template's sharding.  The port
writes a format of its own (orbax is not on the card's machine), in a
checkpoint directory:

- ``rank<r>.pt``: ``torch.save`` of the CPU copies of the pieces rank
  ``r`` owns, by leaf path (bf16 kept);
- ``rank<r>.json``: that rank's fragment of the index (each owned
  leaf's global shape, dtype and the piece's segments);
- ``objects.pt`` (the coordinator): every leaf that is not a tensor
  (step counts, the LR scheduler's state);
- ``index.json`` (the coordinator, after a barrier): every leaf's path,
  global shape and dtype, and each piece's rank, file and segments
  (``layout.Segment``: offsets and lengths in the global tensor, and
  where they start in the stored piece).

A leaf's piece and its place in the whole come from its
``layout.Layout``: a :class:`~.layout.ShardedTensor` leaf carries its
own; a tensor carries its ``_global_layout``, else its mp split
(``layout.param_layout``), else it is whole.  Ranks holding the same
piece (replicas over dp, replicated leaves over mp) write it once: the
lowest rank that holds it, found by one ``all_gather_object`` of the
pieces' keys on a layout's first save and kept for the next ones.

On load each rank reads the index, and for each template leaf copies
into it, in place and on its device, the parts of the saved pieces that
its own layout covers (``torch.load(mmap=True, weights_only=True)`` of
only the files that hold them): a checkpoint written at dp2 x mp2 loads
at dp4, at dp1, under a sharding stage or the sharded weight update.  A
template whose global shape differs from the saved one, or whose piece
the checkpoint does not cover, raises with the leaf's path.

``save_runner_state`` / ``load_runner_state`` carry a
``DistributedRunner``'s parameters, optimizer slots (each slice with the
layout of the piece it updates), step count and LR scheduler.  A
``PipelinedRunner`` is refused, as the JAX package's ``_runner_tree``
needs a ``place()`` that its ``PipelinedRunner`` lacks.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, List

import numpy as np
import torch

from .layout import Layout, Segment, ShardedTensor, param_layout

__all__ = ["save_state_dict", "load_state_dict", "save_runner_state",
           "load_runner_state"]

FORMAT = "paddle_tpu_torch.distributed.checkpoint/1"
INDEX_NAME = "index.json"
OBJECTS_NAME = "objects.pt"
PIPE_REFUSAL = (
    "save_runner_state / load_runner_state of a PipelinedRunner: the JAX "
    "package's runner tree needs place(), which its PipelinedRunner lacks; "
    "save the stages' state dicts with save_state_dict instead")

_PLANS: Dict[tuple, set] = {}
_plans_lock = threading.Lock()


# -- trees ----------------------------------------------------------------
def _is_tensor_leaf(v) -> bool:
    return (isinstance(v, (torch.Tensor, np.ndarray))
            or getattr(v, "is_sharded_tensor", False)
            or isinstance(getattr(v, "_value", None), torch.Tensor))


def _flatten(tree, prefix=""):
    """``[(path, container, key, leaf)]`` of a tree of dicts, lists and
    tuples (tuples are read-only: their leaves are not assigned back)."""
    out = []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, None, None, tree)]
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)) and not _is_tensor_leaf(v):
            out += _flatten(v, path)
        else:
            out.append((path, tree, k, v))
    return out


def _local_and_layout(v):
    """The local torch tensor of a tensor leaf and its layout."""
    if getattr(v, "is_sharded_tensor", False):
        return v.local, v.layout
    if isinstance(v, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t, Layout.whole(t.shape)
    t = v if isinstance(v, torch.Tensor) else v._value
    return t, param_layout(v if isinstance(v, torch.Tensor) else t)


def _group(process_group):
    from ..communication import get_group
    return get_group(process_group)


def _rank(g) -> int:
    return g.rank if g.pg is not None else 0


# -- save -------------------------------------------------------------------
def _owned(entries, g, collective=True):
    """The paths this rank writes: for each distinct piece, the lowest
    rank that holds it (module docstring).  Without ``collective`` (a
    signal handler) a cached plan is used, else every piece."""
    mine = tuple((path, lay.key()) for path, _, lay in entries)
    cache_key = (tuple(g.ranks), mine)
    with _plans_lock:
        hit = _PLANS.get(cache_key)
    if hit is not None:
        return hit
    if g.pg is None or g.nranks == 1:
        owned = {path for path, _, _ in entries}
    elif not collective:
        return {path for path, _, _ in entries}
    else:
        from ..communication import all_gather_object
        everyone: List[Any] = []
        all_gather_object(everyone, mine, group=g)
        first = {}
        for r, pieces in enumerate(everyone):
            for path, key in pieces:
                first.setdefault((path, key), r)
        owned = {path for path, key in mine if first[(path, key)] == g.rank}
    with _plans_lock:
        _PLANS[cache_key] = owned
    return owned


def host_copy(state_dict, process_group=None, collective=True):
    """What :func:`write_host_copy` writes, taken now: the CPU copies of
    the pieces this rank owns, their index fragment and the tree's other
    leaves (the caller's thread; an async save writes it later)."""
    g = _group(process_group)
    entries, objects = [], {}
    for path, _, _, v in _flatten(state_dict):
        if _is_tensor_leaf(v):
            t, lay = _local_and_layout(v)
            entries.append((path, t, lay))
        else:
            objects[path] = v
    owned = _owned(entries, g, collective)
    r = _rank(g)
    tensors, frag = {}, {}
    for path, t, lay in entries:
        if path not in owned:
            continue
        tensors[path] = t.detach().to("cpu", copy=True).contiguous()
        frag[path] = {"shape": list(lay.global_shape),
                      "dtype": str(t.dtype).replace("torch.", ""),
                      "segments": [[list(s.offsets), list(s.lengths),
                                    s.start] for s in lay.segments]}
    return {"rank": r, "tensors": tensors, "fragment": frag,
            "objects": objects}


def _atomic_save(obj, path):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_json(obj, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def write_host_copy(copy, path, coordinator=False):
    """Write a :func:`host_copy` into the checkpoint directory ``path``:
    the rank's tensor file and fragment, and on the coordinator the
    objects."""
    os.makedirs(path, exist_ok=True)
    r = copy["rank"]
    _atomic_save(copy["tensors"], os.path.join(path, f"rank{r}.pt"))
    _atomic_json({"format": FORMAT, "rank": r, "file": f"rank{r}.pt",
                  "leaves": copy["fragment"]},
                 os.path.join(path, f"rank{r}.json"))
    if coordinator:
        _atomic_save(copy["objects"], os.path.join(path, OBJECTS_NAME))


def merge_index(path):
    """The index of the fragments in ``path``: each leaf's pieces, a
    piece held by several ranks taken from the lowest."""
    frags = []
    for name in os.listdir(path):
        if name.startswith("rank") and name.endswith(".json"):
            with open(os.path.join(path, name)) as f:
                frags.append(json.load(f))
    frags.sort(key=lambda fr: fr["rank"])
    leaves: Dict[str, dict] = {}
    for fr in frags:
        for leaf, meta in fr["leaves"].items():
            entry = leaves.setdefault(leaf, {"shape": meta["shape"],
                                             "dtype": meta["dtype"],
                                             "pieces": []})
            if entry["shape"] != meta["shape"]:
                raise ValueError(f"{leaf}: ranks disagree on its global "
                                 f"shape ({entry['shape']} vs "
                                 f"{meta['shape']})")
            segs = meta["segments"]
            if all(p["segments"] != segs for p in entry["pieces"]):
                entry["pieces"].append({"rank": fr["rank"],
                                        "file": fr["file"],
                                        "segments": segs})
    return {"format": FORMAT, "leaves": leaves}


def commit_index(path, process_group=None, coordinator_rank=0):
    """After every rank wrote its files: a barrier, the coordinator's
    ``index.json``, a barrier."""
    from ..communication import barrier
    g = _group(process_group)
    barrier(g)
    if _rank(g) == coordinator_rank:
        _atomic_json(merge_index(path), os.path.join(path, INDEX_NAME))
    barrier(g)


class AsyncSave:
    """An async :func:`save_state_dict` in flight: ``wait()`` (on every
    rank) joins this rank's writer and commits the index."""

    def __init__(self, thread, path, group, coordinator_rank):
        self._thread, self._path = thread, path
        self._group, self._coord = group, coordinator_rank
        self._error = None

    def wait(self):
        self._thread.join()
        if self._error is not None:
            raise self._error
        commit_index(self._path, self._group, self._coord)


def save_state_dict(state_dict, path: str, process_group=None,
                    coordinator_rank: int = 0, async_save: bool = False):
    """Write ``state_dict`` (a tree of tensors, Paddle Tensors,
    :class:`ShardedTensor` s and other objects) into the directory
    ``path`` (module docstring).  Every rank of ``process_group`` (the
    world when None) calls it.  ``async_save`` takes the host copy now,
    writes on a thread and returns an :class:`AsyncSave` whose ``wait``
    every rank calls before the checkpoint is read."""
    g = _group(process_group)
    path = os.path.abspath(path)
    copy = host_copy(state_dict, g)
    coord = _rank(g) == coordinator_rank
    if not async_save:
        write_host_copy(copy, path, coord)
        commit_index(path, g, coordinator_rank)
        return None
    handle = AsyncSave(None, path, g, coordinator_rank)

    def run():
        try:
            write_host_copy(copy, path, coord)
        except BaseException as e:  # noqa: BLE001 - raised by wait()
            handle._error = e

    handle._thread = threading.Thread(target=run, daemon=True)
    handle._thread.start()
    return handle


# -- load -------------------------------------------------------------------
def read_index(path):
    p = os.path.join(path, INDEX_NAME)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return merge_index(path)


def read_objects(path):
    p = os.path.join(path, OBJECTS_NAME)
    if not os.path.exists(p):
        return {}
    return torch.load(p, weights_only=True)


class _Files:
    def __init__(self, path):
        self.path, self.open = path, {}

    def get(self, name, leaf):
        if name not in self.open:
            self.open[name] = torch.load(os.path.join(self.path, name),
                                         mmap=True, weights_only=True)
        return self.open[name][leaf].reshape(-1)


def _box(flat, seg: Segment, lo, hi):
    n = math.prod(seg.lengths)
    view = flat[seg.start:seg.start + n].view(seg.lengths)
    return view[tuple(slice(a - o, b - o)
                      for a, b, o in zip(lo, hi, seg.offsets))]


@torch.no_grad()
def _fill(path, leaf, target, layout: Layout, meta, files):
    if tuple(meta["shape"]) != layout.global_shape:
        raise ValueError(
            f"{leaf}: this layout's global shape {layout.global_shape} does "
            f"not cover the saved global shape {tuple(meta['shape'])}")
    work = target if target.is_contiguous() else target.contiguous()
    flat = work.view(-1)
    need = covered = 0
    for tseg in layout.segments:
        need += math.prod(tseg.lengths)
        t_hi = [o + n for o, n in zip(tseg.offsets, tseg.lengths)]
        for piece in meta["pieces"]:
            for off, lens, start in piece["segments"]:
                sseg = Segment(tuple(off), tuple(lens), start)
                lo = [max(a, b) for a, b in zip(tseg.offsets, sseg.offsets)]
                hi = [min(a, b + n) for a, b, n in
                      zip(t_hi, sseg.offsets, sseg.lengths)]
                if any(h <= l for l, h in zip(lo, hi)):
                    continue
                src = files.get(piece["file"], leaf)
                _box(flat, tseg, lo, hi).copy_(_box(src, sseg, lo, hi))
                covered += math.prod(h - l for l, h in zip(lo, hi))
    if covered < need:
        raise ValueError(
            f"{leaf}: the checkpoint at {path} covers {covered} of the "
            f"{need} elements this rank's layout ({layout}) needs")
    if work is not target:
        target.copy_(work)


def load_state_dict(state_dict, path: str, process_group=None,
                    coordinator_rank: int = 0, offload: bool = False):
    """Load the checkpoint at ``path`` into ``state_dict`` in place
    (Paddle's convention): each tensor leaf receives the parts of the
    saved pieces its layout covers, cast to its dtype, on its device;
    the other leaves are replaced.  Returns ``state_dict``.  A template
    leaf that the checkpoint lacks raises ``KeyError``; one whose layout
    it does not cover, ``ValueError``.  ``offload`` is accepted for the
    upstream signature: every leaf is filled where it lives."""
    path = os.path.abspath(path)
    index = read_index(path)["leaves"]
    objects = None
    files = _Files(path)
    for leaf, cont, key, v in _flatten(state_dict):
        if _is_tensor_leaf(v):
            if leaf not in index:
                raise KeyError(f"{leaf}: not in the checkpoint at {path}")
            if isinstance(v, np.ndarray):
                t = torch.from_numpy(v)
                _fill(path, leaf, t, Layout.whole(t.shape), index[leaf],
                      files)
                continue
            t, lay = _local_and_layout(v)
            _fill(path, leaf, t, lay, index[leaf], files)
        else:
            if objects is None:
                objects = read_objects(path)
            if leaf in objects and cont is not None and \
                    not isinstance(cont, tuple):
                cont[key] = objects[leaf]
    return state_dict


# -- the runner's state -----------------------------------------------------
def inner_optimizer(opt):
    while hasattr(opt, "_inner_opt"):
        opt = opt._inner_opt
    return opt


def name_slots(optimizer, model):
    """Name an unnamed optimizer's parameters by ``model``'s
    ``named_parameters()`` when they are the same list (as the runner
    and ``Model`` do), so its slots are keyed by parameter name."""
    opt = inner_optimizer(optimizer)
    if opt._param_names is not None or model is None:
        return
    named = list(model.named_parameters())
    if len(named) == len(opt._params) and all(
            p is q for (_, p), q in zip(named, opt._parameter_list)):
        opt.set_param_names([n for n, _ in named])


def model_tree(model) -> Dict[str, Any]:
    """The model's parameters and buffers, live (their mp marks kept)."""
    return dict(model.state_dict(keep_vars=True))


def optimizer_tree(optimizer, create: bool = False) -> Dict[str, Any]:
    """``<param name>.<slot>`` for every slot of every state (a slot of a
    piece's shape as a :class:`ShardedTensor` with the piece's layout
    when that is not whole), ``global_step`` and ``LR_Scheduler``.
    ``create`` makes every trainable parameter's state first, as its
    first step would."""
    from ...optimizer.lr import LRScheduler
    opt = inner_optimizer(optimizer)
    if create:
        for i, p in enumerate(opt._parameter_list):
            if p.requires_grad:
                opt._ensure_state(i, p)

    def piece(p):
        lay = param_layout(p)
        return None if lay.is_whole else lay

    tree: Dict[str, Any] = opt.slots(piece, copy=False)
    tree["global_step"] = opt._global_step
    if isinstance(opt._learning_rate, LRScheduler):
        tree["LR_Scheduler"] = opt._learning_rate.state_dict()
    return tree


def restore_bookkeeping(optimizer, tree, masters_missing=()):
    """After a load into :func:`optimizer_tree`: the step count, the
    scheduler, each state's host step count, and the fp32 masters the
    checkpoint lacked refreshed from their parameters."""
    from ...optimizer.lr import LRScheduler
    opt = inner_optimizer(optimizer)
    opt._global_step = int(tree.get("global_step", opt._global_step))
    if "LR_Scheduler" in tree and isinstance(opt._learning_rate,
                                             LRScheduler):
        opt._learning_rate.set_state_dict(tree["LR_Scheduler"])
    params = opt._parameter_list
    with torch.no_grad():
        for i, st in opt._state.items():
            if opt._param_name(i) in masters_missing:
                st["master_weight"].copy_(params[i])
            st["steps"] = opt._steps_of(st)


def optimizer_state_from_jax(slots, global_step: int = 0):
    """The port's ``Optimizer.state_dict()`` layout of a JAX
    ``DistributedRunner``'s optimizer slots given as numpy (``{param
    name: {slot: array}}``, the runner's ``_opt_state`` whole-shape, as
    ``np.asarray`` gives it): ``<param name>.<slot>`` tensors and
    ``global_step``, for ``Optimizer.set_state_dict`` (the slot names
    are the same in both packages)."""
    from ...framework.io import array_to_tensor
    out: Dict[str, Any] = {}
    for name, st in slots.items():
        for slot, v in st.items():
            out[f"{name}.{slot}"] = array_to_tensor(np.asarray(v))
    out["global_step"] = int(global_step)
    return out


def _runner_tree(runner, create=False):
    from ..runner import PipelinedRunner
    if isinstance(runner, PipelinedRunner):
        raise NotImplementedError(PIPE_REFUSAL)
    runner.sync_to_layers()
    return {"params": model_tree(runner.network),
            "opt": optimizer_tree(runner.optimizer, create)}


def save_runner_state(runner, path: str, process_group=None,
                      async_save: bool = False):
    """Checkpoint a ``DistributedRunner``'s parameters, optimizer slots,
    step count and scheduler; every rank calls it."""
    return save_state_dict(_runner_tree(runner), path, process_group,
                           async_save=async_save)


def refresh_pieces(model):
    """The optimizer's pieces (the chunks of a sharding stage or of the
    sharded weight update) over ``model``'s parameters, from the values
    a load wrote into those parameters."""
    owners = {id(o): o for o in (getattr(p, "_sharded_owner", None)
                                 for p in model.parameters())
              if o is not None}
    for owner in owners.values():
        owner.refresh_shards()


def load_template(opt_tree, index, prefix):
    """Drop from ``opt_tree`` (an :func:`optimizer_tree` saved under
    ``prefix``) the fp32 masters that the checkpoint lacks (a checkpoint
    of an fp32 run into an O2 runner); returns those masters' parameter
    names, for :func:`restore_bookkeeping` to refresh."""
    missing = [k for k in list(opt_tree) if k.endswith(".master_weight")
               and f"{prefix}/{k}" not in index]
    for k in missing:
        del opt_tree[k]
    return {k[:-len(".master_weight")] for k in missing}


def load_runner_state(runner, path: str, process_group=None):
    """Restore into a ``DistributedRunner`` of any layout (module
    docstring): parameters, optimizer slots (made first where the runner
    has not stepped yet), step count and scheduler."""
    tree = _runner_tree(runner, create=True)
    masters = load_template(tree["opt"], read_index(os.path.abspath(path))[
        "leaves"], "opt")
    load_state_dict(tree, path, process_group)
    restore_bookkeeping(runner.optimizer, tree["opt"], masters)
    refresh_pieces(runner.network)
