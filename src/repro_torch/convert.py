"""Carry weights and train states across from the JAX package.

The functions take trees whose leaves are numpy arrays (``jax.tree.map(
np.asarray, tree)`` of a JAX tree): nested dicts and lists with the JAX
layout, stacked layer groups on a leading ``[L, ...]`` axis. The port keeps
that layout, so conversion is leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve
from repro_torch.optim.panther import PantherState, SlicedTensor
from repro_torch.train.step import TrainState


def params_from_jax(tree_of_numpy, device=None):
    """JAX param tree (numpy leaves) -> the port's param tree on ``device``."""
    dev = resolve(device)
    return tree.map(lambda a: None if a is None else torch.from_numpy(np.array(a)).to(dev),
                    tree_of_numpy)


def sliced_from_jax(tree_of_numpy, device=None):
    """JAX ``SlicedTensor`` tree (planes ``[S, *stack, M, N]``, numpy) -> the
    port's, whose stacked planes are stored ``[*stack, S, M, N]`` and viewed
    ``[S, *stack, M, N]`` (see ``optim.panther``)."""
    dev = resolve(device)

    def one(s):
        if s is None:
            return None
        planes = np.asarray(s.planes)
        lead = planes.ndim - 3  # stack dims between S and the matrix
        store = torch.from_numpy(np.array(np.moveaxis(planes, 0, lead), order="C")).to(dev)
        frac = torch.from_numpy(np.array(s.frac_bits, dtype=np.int32)).to(dev)
        return SlicedTensor(planes=store.movedim(lead, 0), frac_bits=frac)

    return tree.map(one, tree_of_numpy)


def train_state_from_jax(step, digital, sliced, rng, device=None) -> TrainState:
    """A JAX ``TrainState``'s parts (numpy trees, the step and the raw
    ``uint32[2]`` rng key) -> the port's ``TrainState``, so both packages
    run the same step from the same state."""
    words = tuple(int(w) for w in np.asarray(rng, dtype=np.uint32).reshape(-1)[:2])
    return TrainState(step=int(step), digital=params_from_jax(digital, device),
                      sliced=sliced_from_jax(sliced, device), rng=words)


def panther_state_from_jax(state_numpy, device=None) -> PantherState:
    """A JAX ``PantherState`` (numpy leaves) -> the port's: the step as a
    host int, the sliced planes (``sliced_from_jax``) and the momentum
    buffers."""
    return PantherState(step=int(np.asarray(state_numpy.step)),
                        sliced=sliced_from_jax(state_numpy.sliced, device),
                        momentum=params_from_jax(state_numpy.momentum, device))
