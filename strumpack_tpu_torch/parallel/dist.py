"""Collectives and the process grid of the distributed solver.

The counterpart of ``strumpack_tpu/parallel/dist.py`` (``to_global`` and
``from_global``, :25-60) on ``torch.distributed``: one process (rank) per
device.  The JAX package lets GSPMD and ``shard_map`` insert its
collectives; the port writes them out, and every collective of the
distributed solver goes through the helpers of this module:

* ``all_gather``: ragged tensors along dim 0, padded to the largest and
  trimmed (``torch.distributed.all_gather`` needs equal sizes);
* ``all_reduce`` and ``broadcast``;
* ``all_to_all``: one ragged tensor per destination rank (the halo
  exchange of ``dist_spmv`` and the object exchange of ``p2p``);
* ``all_gather_object``: small picklable objects (digests, metadata).

On a gloo group a CUDA tensor is staged through a host buffer for
``all_gather`` and ``all_to_all`` (``_staged``): gloo takes CUDA tensors
only for broadcast and all-reduce.  NCCL takes CUDA tensors directly, and
host tensors (metadata, pickled objects) go through a device buffer.

``resolve_rank_device`` gives a rank its device (``None``: ``cuda:(local
rank % device count)``, raising without CUDA) for the solver,
``DistCSR`` and ``DistributedMatrix``.

``Grid`` is the process grid of a ``DeviceMesh``: the flattened rank order
is axis-major, as the JAX package's ``mesh.devices.reshape(-1)``
(``strumpack_tpu/parallel/spmd.py:404``), and the intra-front modes split
the mesh into grid rows (every axis but the last) and grid columns (the
last axis), as ``ShardedPlan`` does (``spmd.py:393-398``).
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

# Seconds a collective may wait for its peers before it raises: a rank
# that fails or takes another branch makes the others raise, not hang.
TIMEOUT_S = 600


def init_process_group(backend, rank, world_size, port,
                       timeout_s=TIMEOUT_S):
    """``torch.distributed.init_process_group`` on ``tcp://localhost:port``
    with a timeout, so that a lost peer raises on every rank."""
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def resolve_rank_device(device=None) -> torch.device:
    """``device``, or this rank's CUDA device ``cuda:(local rank % device
    count)`` (the local rank from ``LOCAL_RANK``, else the global rank);
    without CUDA and without a device, raises."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _comm_device(group):
    """The device a collective on ``group`` moves data on: the host for
    gloo, the current CUDA device for NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t, group):
    """``t`` on the device the gathers and all-to-alls of ``group`` take:
    a CUDA tensor staged through a host buffer on gloo, a host tensor
    (metadata) through a device buffer on NCCL."""
    return t.to(_comm_device(group))


def _inplace(op, t, group, *args):
    """An in-place collective on ``t``: gloo takes CUDA tensors for these
    (broadcast, all-reduce), NCCL needs a host tensor on the device."""
    if t.is_contiguous() and (t.is_cuda
                              or dist.get_backend(group) != "nccl"):
        op(t, *args, group=group)
        return t
    # a strided tensor (a LAPACK result) travels as a contiguous copy
    u = _staged(t, group).contiguous()
    op(u, *args, group=group)
    t.copy_(u)
    return t


def group_size(group):
    return 1 if group is False else dist.get_world_size(group)


def all_gather(t, group=None, sizes=None):
    """The tensors ``t`` of every rank of ``group``, in group rank order.
    Their dim 0 may differ (``sizes``: the dim-0 sizes when the caller
    knows them, else one all-gather of the sizes first); the other dims
    must agree.  ``group=False`` is the group of this rank alone.
    ``all_gather.bytes`` counts the bytes delivered here,
    ``all_gather.seconds`` the time spent here."""
    if group is False or dist.get_world_size(group) == 1:
        return [t]
    t0 = time.perf_counter()
    n = dist.get_world_size(group)
    t = t.contiguous()
    if sizes is None:
        sz = _staged(torch.tensor([t.shape[0]], dtype=torch.int64), group)
        out = [torch.empty_like(sz) for _ in range(n)]
        dist.all_gather(out, sz, group=group)
        sizes = [int(s) for s in out]
    m = max(sizes)
    dev = t.device
    src = _staged(t, group)
    if src.shape[0] < m:
        src = torch.cat([src, src.new_zeros((m - src.shape[0],)
                                            + tuple(src.shape[1:]))])
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    all_gather.bytes += sum(sizes) * (src.numel() // max(m, 1)) \
        * src.element_size()
    res = [o[:s].to(dev) for o, s in zip(out, sizes)]
    all_gather.seconds += time.perf_counter() - t0
    return res


# bytes all_gather delivered to this rank (its own part included) and the
# host seconds spent in it (a staged gather waits for the kernels that
# produce its input), for the per-level report of the distributed sweep
all_gather.bytes = 0
all_gather.seconds = 0.0


def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if group is not False and dist.get_world_size(group) > 1:
        _inplace(dist.all_reduce, t, group, op)
    return t


def broadcast(t, src, group=None):
    """In-place broadcast of ``t`` from global rank ``src``; returns
    ``t``."""
    if group is not False and dist.get_world_size(group) > 1:
        _inplace(dist.broadcast, t, group, src)
    return t


def all_to_all(parts, group=None):
    """``parts[j]`` (a 1-D tensor, sizes may differ) goes to group rank j;
    returns the list of what each group rank sent here.  One exchange of
    the sizes, then one ``all_to_all_single`` of the payloads."""
    n = group_size(group)
    if n == 1:
        return [parts[0]]
    dev = parts[0].device
    sizes = [p.numel() for p in parts]
    ssz = _staged(torch.tensor(sizes, dtype=torch.int64), group)
    rsz = torch.empty_like(ssz)
    dist.all_to_all_single(rsz, ssz, group=group)
    rs = rsz.tolist()
    send = _staged(torch.cat([p.reshape(-1) for p in parts]), group)
    recv = send.new_empty((sum(rs),))
    dist.all_to_all_single(recv, send, output_split_sizes=rs,
                           input_split_sizes=sizes, group=group)
    return [r.to(dev) for r in torch.split(recv, rs)]


def all_gather_object(obj, group=None):
    """Every rank's picklable ``obj`` in group rank order (pickled bytes
    as a ragged uint8 all-gather)."""
    if group is False or dist.get_world_size(group) == 1:
        return [obj]
    buf = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    return [pickle.loads(b.numpy().tobytes())
            for b in all_gather(buf, group)]


def to_global(x, device):
    """A host array every rank holds as the same tensor on ``device`` (the
    replicated-symbolic model: every rank has the host plan and matrix)."""
    return torch.as_tensor(np.asarray(x), device=device)


def from_global(t):
    """A replicated tensor as a host array."""
    return t.detach().cpu().numpy()


class Grid:
    """The process grid of a ``DeviceMesh``.

    ``ranks``: global ranks in the mesh's axis-major order, ``me``: this
    rank's place in it (the shard index of the batch-sharded buckets).
    Grid rows are every mesh axis but the last, grid columns the last
    (a 1-D mesh is ``pr`` = its size rows by one column); ``ri``/``ci``
    are this rank's grid coordinates, ``row_group`` the ranks of its grid
    column (same ci: the ranks that share a column block), ``col_group``
    the ranks of its grid row (same ri).  A group of one rank is
    ``False``.  Creating a Grid is collective."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = tuple(mesh.mesh_dim_names)
        self.shape = {a: int(s) for a, s in zip(self.axes, mesh.mesh.shape)}
        self.ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        self.ndev = len(self.ranks)
        self.rank = dist.get_rank()
        self.me = self.ranks.index(self.rank)
        if len(self.axes) > 1:
            self.row_axes, self.col_axes = self.axes[:-1], self.axes[-1:]
        else:
            self.row_axes, self.col_axes = self.axes, ()
        self.pr = math.prod(self.shape[a] for a in self.row_axes)
        self.pc = math.prod(self.shape[a] for a in self.col_axes)
        self.ri, self.ci = divmod(self.me, self.pc)
        world = dist.get_world_size()
        self.group = (None if self.ndev == world
                      else self._new_groups([self.ranks])[0])
        if self.ndev == 1:
            self.group = False
        # every rank creates every group, in one order
        cols = [[self.ranks[r * self.pc + c] for r in range(self.pr)]
                for c in range(self.pc)]
        rows = [[self.ranks[r * self.pc + c] for c in range(self.pc)]
                for r in range(self.pr)]
        self.row_group = self._new_groups(cols)[self.ci]
        self.col_group = self._new_groups(rows)[self.ri]

    def _new_groups(self, sets):
        out = []
        for s in sets:
            if len(s) == 1:
                out.append(False)
            elif len(s) == dist.get_world_size():
                out.append(None)
            else:
                out.append(dist.new_group(s))
        return out

    def rank_at(self, ri, ci):
        """The global rank at grid coordinates (ri, ci)."""
        return self.ranks[ri * self.pc + ci]
