"""A rank's block of a sharded leaf: where it sits in the leaf, how it is
cut out, and how the leaf is gathered back. A spec (``sharding.P``) names
the mesh axes of each dim; a dim over several axes splits with the first
axis major, as JAX's ``PartitionSpec`` does."""
from __future__ import annotations

import torch

from . import collectives as col
from .sharding import axes_of


def block_slices(spec, shape: tuple, mesh) -> tuple:
    """This rank's ``slice`` of each dim of a leaf of ``shape`` under
    ``spec`` (right-padded with None)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for entry, d in zip(spec, shape):
        axes = axes_of(entry)
        n = mesh.axes_size(axes)
        size = d // n
        i = mesh.index(axes)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def block_shape(spec, shape: tuple, mesh) -> tuple:
    """The shape of this rank's block of a leaf of ``shape``."""
    return tuple(s.stop - s.start for s in block_slices(spec, shape, mesh))


def sharded(spec) -> bool:
    return any(axes_of(e) for e in spec)


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t``, a contiguous copy (``t``
    itself when nothing is sharded)."""
    if not sharded(spec):
        return t
    return t[block_slices(spec, tuple(t.shape), mesh)].contiguous()


def gather(t: torch.Tensor, spec, mesh, dims=None) -> torch.Tensor:
    """The whole leaf from every rank's block ``t`` under ``spec``:
    gathered dim by dim, a dim's axes from the minor one out. ``dims``
    limits the gather to those dims of ``t``."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    for d, entry in enumerate(spec):
        if dims is not None and d not in dims:
            continue
        for a in reversed(axes_of(entry)):
            t = col.all_gather(t, mesh, a, dim=d)
    return t


def owner(spec, mesh) -> bool:
    """Whether this rank's block counts once in a sum over every rank:
    true where its coordinate is 0 on every axis the spec does not shard
    over (a replicated leaf counts on one rank only)."""
    used = {a for e in spec for a in axes_of(e)}
    return all(mesh.coordinate[a] == 0 for a in mesh.axis_names if a not in used)


def without(spec, axes) -> tuple:
    """``spec`` with the mesh ``axes`` dropped from every entry."""
    out = []
    for e in spec:
        kept = tuple(a for a in axes_of(e) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1 else kept)
    return tuple(out)


def whole_shape(spec, shape: tuple, mesh) -> tuple:
    """The whole leaf's shape from this rank's block ``shape``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d * mesh.axes_size(axes_of(e)) for e, d in zip(spec, shape))


def layer_major(planes: torch.Tensor) -> torch.Tensor:
    """Planes ``[S, *stack, M, N]`` copied into the port's layer-major
    storage (``[*stack, S, M, N]``, viewed back), each layer's block
    contiguous for the kernels."""
    n = planes.dim() - 3
    store = torch.empty(planes.movedim(0, n).shape, dtype=planes.dtype, device=planes.device)
    store.copy_(planes.movedim(0, n))
    return store.movedim(n, 0)


def read_block(s, planes_spec, shard_dim, mesh, model_axis: str = "model"):
    """A fidelity leaf's planes (``SlicedTensor`` of this rank's block under
    ``planes_spec``, ``[S, *stack, m, n]``) as its reads on a mesh take
    them: gathered over every sharded dim but ``model_axis`` on the matrix
    dim ``shard_dim`` (0 rows, 1 columns), which stays this rank's tile
    block; the leaf itself when nothing needs gathering."""
    spec = tuple(planes_spec) + (None,) * (s.planes.dim() - len(tuple(planes_spec)))
    keep = None if shard_dim is None or mesh.shape.get(model_axis, 1) <= 1 else len(spec) - 2 + shard_dim
    spec = tuple(without((e,), (model_axis,))[0] if i == keep else e for i, e in enumerate(spec))
    if not sharded(spec):
        return s
    return type(s)(planes=layer_major(gather(s.planes, spec, mesh)), frac_bits=s.frac_bits)
