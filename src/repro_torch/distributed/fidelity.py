"""The mesh context of the finite-ADC reads (port of
``repro.distributed.fidelity``).

``core.mvm.fidelity_read`` is called deep inside the model code
(``xbar_linear``'s forward and backward), so the mesh cannot be threaded
through as an argument without touching every model site. The trainer and
the server activate a :class:`ShardCtx` for the extent of their step
(``make_train_step`` on a mesh, ``serve.make_prefill`` /
``make_decode_step``, ``Engine(mesh=)``), and ``fidelity_read`` consults
:func:`active`: with a context set, the read takes its DAC exponent from the
global ``max|x|`` over the data axes and runs on this rank's crossbar tile
block through ``kernels.sliced_mvm.mvm_sliced_sharded``, per the leaf's
``FidelityConfig.shard_dim``. Without one (the default) every read is the
single-device read.

:class:`FoldCtx` is the witness of the sharded reads: one process whose
reads fold their crossbar tiles' partials in the order a mesh's ranks fold
them (``kernels.sliced_mvm.mvm_sliced_folded``).

Here, unlike the reference's trace-time context, the context is run-time
state: each process reads only its own tokens (its data shard), so
``data_axes`` names the axes its tokens are a shard over. It is the
process's, not a thread's: autograd runs a CUDA backward (the MᵀVM reads)
on a thread of its own, which must see the step's context.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """``data_axes``: the mesh axes this rank's tokens are a shard over;
    ``model_axis``: the tensor-parallel axis carrying crossbar tile blocks
    (None: no tile sharding, tokens still shard)."""

    mesh: Any
    data_axes: tuple = ()
    model_axis: str | None = "model"


@dataclasses.dataclass(frozen=True)
class FoldCtx:
    """One process (no mesh) whose reads fold their contraction as a mesh
    with ``parts`` ranks on its model axis folds them, per the leaf's
    ``FidelityConfig.shard_dim``."""

    parts: int


_active: list = [None]  # the process's context: [ShardCtx | FoldCtx | None]


def active() -> ShardCtx | FoldCtx | None:
    """The context of the innermost :func:`use_sharded_fidelity` scope."""
    return _active[0]


@contextlib.contextmanager
def use_sharded_fidelity(ctx: ShardCtx | FoldCtx | None):
    """Activate ``ctx`` for the extent of the block (None deactivates)."""
    prev = _active[0]
    _active[0] = ctx
    try:
        yield ctx
    finally:
        _active[0] = prev


def ctx_for(mesh, global_batch: int | None = None, model_axis: str = "model") -> ShardCtx:
    """The standard ShardCtx of a (pod, data, model) mesh: tokens over the
    DP axes that cumulatively divide ``global_batch`` (``sharding.
    data_axes_for``, all of them when None), tile blocks over
    ``model_axis`` when the mesh has it with more than one rank."""
    from repro_torch.distributed import sharding as shd

    axes = shd.data_axes_for(mesh, global_batch)
    maxis = model_axis if (model_axis in mesh.axis_names and mesh.shape[model_axis] > 1) else None
    return ShardCtx(mesh=mesh, data_axes=axes, model_axis=maxis)
