"""Carry state across from the JAX package: its arrays (numpy arrays,
or anything `np.asarray` takes) become the port's tensors on a given
device, dtypes preserved. This is how the tests feed both sides the
same inputs; it imports neither jax nor cook_tpu.
"""
from __future__ import annotations

import numpy as np
import torch

from cook_tpu_torch.device import resolve_device
from cook_tpu_torch.ops import match as match_ops
from cook_tpu_torch.scheduler import resident


def tensor(x, device="cuda") -> torch.Tensor:
    """One array as a tensor on `device`, same dtype (a copy)."""
    return torch.from_numpy(np.array(np.asarray(x))).to(
        resolve_device(device))


def tensors(xs, device="cuda") -> tuple:
    """A sequence of arrays (None passes through) as tensors."""
    return tuple(None if x is None else tensor(x, device) for x in xs)


def jobs(j, device="cuda") -> match_ops.Jobs:
    """A `Jobs` namedtuple of the JAX package as the port's."""
    return match_ops.Jobs(*tensors(j, device))


def hosts(h, device="cuda") -> match_ops.Hosts:
    """A `Hosts` namedtuple of the JAX package as the port's."""
    return match_ops.Hosts(*tensors(h, device))


def cycle_args(args, device="cuda") -> tuple:
    """The positional arguments of `rank_and_match`, with the hosts
    namedtuple in place and the sparse (rows, slot_of) forbidden form
    kept as a tuple."""
    out = []
    for a in args:
        if a is None:
            out.append(None)
        elif hasattr(a, "_fields") and "task_slots" in a._fields:
            out.append(hosts(a, device))
        elif isinstance(a, tuple):
            out.append(tensors(a, device))
        else:
            out.append(tensor(a, device))
    return tuple(out)


# the `_device_cycle` state dict of the JAX package -> the port's device
# state (sink slots appended; see scheduler/resident.py). A packed delta
# bundle (the 13-tuple `_ship` returns) converts with `tensors`.
state = resident.state_to_device
