"""Object alltoallv between the ranks of a process group.

The counterpart of ``strumpack_tpu/parallel/p2p.py`` (``alltoallv``,
:69), the role of the reference's point-to-point redistribution of row
blocks (``EliminationTreeMPIDist.cpp:470-587``, ``Redistribute.hpp:136``).
The JAX package builds it from a TCP server and a ring, because JAX
exposes device collectives only; torch.distributed has the exchange, so
the objects travel as pickled bytes in ``uint8`` tensors through
``dist.all_to_all``: each rank receives only what was addressed to it.
"""
from __future__ import annotations

import pickle

import torch
import torch.distributed as dist

from . import dist as D


def alltoallv(dest_objs: dict, group=None) -> dict:
    """Send ``dest_objs[q]`` (any picklable object) to group rank q;
    returns {p: obj} for every rank p that addressed this one.
    Collective: every rank of ``group`` calls it the same number of
    times."""
    n = D.group_size(group)
    me = 0 if n == 1 else dist.get_rank(group)
    if n == 1:
        return {me: dest_objs[me]} if me in dest_objs else {}
    parts = [torch.frombuffer(bytearray(pickle.dumps(dest_objs[q])),
                              dtype=torch.uint8)
             if q in dest_objs else torch.empty(0, dtype=torch.uint8)
             for q in range(n)]
    got = D.all_to_all(parts, group)
    return {p: pickle.loads(b.numpy().tobytes())
            for p, b in enumerate(got) if b.numel()}
