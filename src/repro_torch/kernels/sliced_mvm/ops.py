"""Public entry points of the sliced MVM (port of
``repro.kernels.sliced_mvm.ops``).

``mvm_sliced_fused`` / ``mvm_sliced_fused_batched`` are the quantize-fused
reads ``core.mvm.fidelity_read`` calls: the float activation and the DAC
exponent go in, and the DAC, the bit planes, the per-tile ADC and the
shift-and-add happen in the read. A read-noisy ``DeviceModel`` adds its
frozen read offsets; an ideal one runs the ideal read. ``mvm_sliced`` /
``mvm_sliced_batched`` read an input already on the DAC grid (int).

Dispatch is by where the tensors lie: CUDA tensors launch the hand-written
kernels (``kernel.py``) or raise, CPU tensors run the plain PyTorch versions
(``ref.py``). There is no fallback from one to the other. The kernels mask
ragged token counts, ragged output columns and a short last crossbar tile
themselves, so the reference's zero padding of the token axis is not needed.

``mvm_sliced_sharded`` is the read on a mesh: each rank holds its block of
the planes (split over the model axis along ``shard_dim``) and its own
tokens, reads its crossbar tile block through the entries above (K4 fused,
K5 unfused) at its global tile and column origin, and the blocks combine:
contraction partials through ``distributed.tile_psum``, output shards
through an all-gather over the model axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels.common import on_card
from . import kernel as _k
from . import ref as _ref


def _normalize_read_device(device):
    """None unless the read path is non-ideal: an ideal or write-only
    DeviceModel runs the exact ideal read."""
    if device is None or not device.reads_nonideal():
        return None
    return device


def _check_device(planes: torch.Tensor, x: torch.Tensor) -> None:
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device} but x on {x.device}")
    if not on_card(planes) and planes.device.type != "cpu":
        raise ValueError(f"no sliced-MVM implementation for device {planes.device}")


def _batched(read, planes: torch.Tensor, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """``read`` of ``x`` [..., contract] with the leading dims flattened into
    one token axis."""
    contract = planes.shape[2] if transpose else planes.shape[1]
    if x.shape[-1] != contract:
        raise ValueError(f"x {tuple(x.shape)} does not contract with planes {tuple(planes.shape)}")
    out = read(x.reshape(-1, contract))
    return out.reshape(*x.shape[:-1], out.shape[-1])


def mvm_sliced_fused(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    device=None,
    tile0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """Quantize-fused vector entry: ``x`` FLOAT [B, M] ([B, N] when
    ``transpose``) plus the int32 DAC exponent ``frac_bits`` -> f32 [B, N]
    on the product grid. ``device``: a DeviceModel or None; its read noise
    offsets the column currents. ``tile0``/``col0`` (host ints) are the
    global crossbar-tile and output-column offsets of these planes, which
    key the offsets."""
    _check_device(planes, x)
    device = _normalize_read_device(device)
    frac = torch.as_tensor(frac_bits, dtype=torch.int32, device=planes.device).reshape(1)
    xf = x.to(torch.float32).contiguous()
    if on_card(planes):
        return _k.mvm_sliced_fused(planes, xf, frac, spec=spec, io_bits=io_bits, adc_bits=adc_bits,
                                   transpose=transpose, dev=device, tile0=tile0, col0=col0)
    return _ref.mvm_sliced_fused_ref(planes, xf, frac[0], spec, io_bits, adc_bits, transpose=transpose,
                                     device=device, tile0=tile0, col0=col0)


def mvm_sliced_fused_batched(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    device=None,
    tile0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """Token-batched quantize-fused read: FLOAT ``x`` [..., M] ([..., N]
    when ``transpose``), leading dims flattened into one token axis. The
    read offsets are per output column, the same on every token."""
    return _batched(lambda x2: mvm_sliced_fused(
        planes, x2, frac_bits, spec, io_bits=io_bits, adc_bits=adc_bits, transpose=transpose,
        device=device, tile0=tile0, col0=col0), planes, x, transpose)


def mvm_sliced(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Vector entry on a pre-quantized input: ``x_q`` int [B, M] ([B, N]
    when ``transpose``) on the ``io_bits`` DAC grid -> f32 [B, N] ([B, M])
    on the product grid."""
    _check_device(planes, x_q)
    if on_card(planes):
        return _k.mvm_sliced(planes, x_q.to(torch.int32).contiguous(), spec=spec, io_bits=io_bits,
                             adc_bits=adc_bits, transpose=transpose)
    return _ref.mvm_sliced_ref(planes, x_q, spec, io_bits, adc_bits, transpose=transpose)


def mvm_sliced_batched(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec,
    *,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Token-batched read of a pre-quantized input: ``x_q`` int [..., M]
    ([..., N] when ``transpose``), leading dims flattened into one token
    axis."""
    return _batched(lambda x2: mvm_sliced(planes, x2, spec, io_bits=io_bits, adc_bits=adc_bits,
                                          transpose=transpose), planes, x_q, transpose)


def mvm_sliced_sharded(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    spec: SliceSpec,
    *,
    mesh,
    data_axes: tuple = (),
    model_axis: str | None = None,
    shard_dim: int | None = None,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    frac_bits=None,
    device=None,
) -> torch.Tensor:
    """The read on a mesh (port of the reference's ``mvm_sliced_sharded``).

    ``planes`` int8 ``[S, m, n]``: this rank's block of one layer's ``[S, M,
    N]`` planes, split into equal blocks over ``model_axis`` along matrix
    dim ``shard_dim`` (0 rows, 1 columns; None: the whole planes). ``x_q``
    ``[..., contract]`` with the whole contraction (``[..., N]`` when
    ``transpose``): this rank's tokens, a shard over ``data_axes``. With
    ``frac_bits`` (the DAC exponent, chosen by the caller over the global
    tokens) the read is the quantize-fused one (K4) on the FLOAT ``x_q``;
    without, ``x_q`` is on the DAC grid (K5). Returns ``[..., out]`` with
    the whole output width, the same on every rank of the model axis.

    Alignment guards, as the reference's: a sharded contraction must split
    into whole 128-row crossbar tiles at finite ADC or with read noise (the
    ADC and the read offsets are per tile) and divide evenly at ideal ADC
    (the ideal read is linear in row blocks); a sharded output must divide
    evenly. An unmet guard drops the model sharding for this read: the
    planes are gathered over the model axis and read whole, so the numbers
    stay the single-device read's. ``data_axes`` needs nothing here (each
    rank reads its own tokens); the global DAC range is the caller's
    (``core.mvm.fidelity_read``)."""
    from repro_torch.distributed import blocks, collectives as col

    device = _normalize_read_device(device)
    maxis = model_axis if (model_axis in mesh.axis_names and mesh.shape[model_axis] > 1) else None
    msize = mesh.shape[maxis] if maxis is not None else 1
    sd = shard_dim if maxis is not None else None
    if sd is not None:
        whole = list(planes.shape)
        whole[1 + sd] *= msize
        contract = whole[2] if transpose else whole[1]
        out_dim = whole[1] if transpose else whole[2]
        if sd == (1 if transpose else 0):  # contraction side sharded
            ok = contract % _contract_granule(msize, adc_bits, device) == 0
        else:
            ok = out_dim % msize == 0
        if not ok:  # read the whole planes: the single-device numbers
            planes = blocks.gather(planes, (None, maxis, None) if sd == 0 else (None, None, maxis), mesh)
            sd = None
    if sd is None:
        if frac_bits is not None:
            return mvm_sliced_fused_batched(planes, x_q, frac_bits, spec, io_bits=io_bits, adc_bits=adc_bits,
                                            transpose=transpose, device=device)
        return mvm_sliced_batched(planes, x_q, spec, io_bits=io_bits, adc_bits=adc_bits, transpose=transpose)

    contract_sharded = sd == (1 if transpose else 0)
    idx = mesh.index(maxis)
    local_contract = planes.shape[2] if transpose else planes.shape[1]
    local_out = planes.shape[1] if transpose else planes.shape[2]
    tile0 = col0 = 0
    if contract_sharded:
        c0 = idx * local_contract
        x_q = x_q[..., c0:c0 + local_contract]
        tile0 = c0 // _k.XBAR_ROWS
    else:
        col0 = idx * local_out
    if frac_bits is not None:
        acc = mvm_sliced_fused_batched(planes, x_q, frac_bits, spec, io_bits=io_bits, adc_bits=adc_bits,
                                       transpose=transpose, device=device, tile0=tile0, col0=col0)
    else:
        acc = mvm_sliced_batched(planes, x_q, spec, io_bits=io_bits, adc_bits=adc_bits, transpose=transpose)
    if contract_sharded:
        return col.tile_psum(acc.contiguous(), mesh, maxis)
    return col.all_gather(acc, mesh, maxis, dim=acc.dim() - 1)


def _contract_granule(parts: int, adc_bits, device) -> int:
    """What a contraction split into ``parts`` must divide into: whole
    128-row crossbar tiles a part at finite ADC or with read noise (the
    ADC and the read offsets are per tile), equal parts at ideal ADC."""
    return parts if adc_bits is None and device is None else parts * _k.XBAR_ROWS


def mvm_sliced_folded(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits,
    spec: SliceSpec,
    *,
    parts: int,
    shard_dim: int | None,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    device=None,
) -> torch.Tensor:
    """The single-device fused read of whole ``planes`` [S, M, N], its
    contraction folded as ``mvm_sliced_sharded`` folds it on a mesh with
    ``parts`` ranks on the model axis: where ``shard_dim`` shards the
    contraction and the alignment guard holds, the reads of the ``parts``
    contraction blocks (each at its ``tile0``) added in f32 in rank order;
    every other read whole. With two parts that sum is ``tile_psum``'s one
    add, so the mesh read equals this one bit for bit: the witness that
    the two differ from the whole read only by the order of the fold."""
    device = _normalize_read_device(device)
    contract = planes.shape[2] if transpose else planes.shape[1]
    if shard_dim != (1 if transpose else 0) or contract % _contract_granule(parts, adc_bits, device):
        return mvm_sliced_fused_batched(planes, x, frac_bits, spec, io_bits=io_bits, adc_bits=adc_bits,
                                        transpose=transpose, device=device)
    part = contract // parts
    acc = None
    for i in range(parts):
        cut = slice(i * part, (i + 1) * part)
        blk = planes[:, :, cut] if transpose else planes[:, cut]
        y = mvm_sliced_fused_batched(blk.contiguous(), x[..., cut].contiguous(), frac_bits, spec, io_bits=io_bits,
                                     adc_bits=adc_bits, transpose=transpose, device=device,
                                     tile0=i * part // _k.XBAR_ROWS)
        acc = y if acc is None else acc + y
    return acc
