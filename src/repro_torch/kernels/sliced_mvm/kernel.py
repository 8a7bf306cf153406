"""CUDA kernels for the sliced MVM on Hopper, bound through ``ctypes`` (port
of the Pallas kernels ``repro.kernels.sliced_mvm.kernel``).

One source (``csrc/mvm_sliced_fused.cu``) holds both reads:

* ``mvm_sliced_fused`` replaces ``mvm_sliced_fused`` of
  ``src/repro/kernels/sliced_mvm/kernel.py`` (K4) — both its double-buffered
  and its 3-D-grid lowerings, which compute the same numbers — for the
  forward and the transpose (MᵀVM) read, at ``io_bits`` 8, 12 and 16, with
  or without a device model's read noise: per 128-row crossbar tile
  (128-column tile for the transpose) it does the DAC, the sign·magnitude
  bit planes, the int32 column currents, the read offsets, the per-slice
  ADC and the shift-and-add, and accumulates the tiles in f32;
* ``mvm_sliced`` replaces ``mvm_sliced`` (K5): the same read on an int32
  input already on the DAC grid, with no DAC prologue.

Three bodies compute these reads, bit for bit the same numbers, chosen by
shape only (``body_for``; nothing falls back on an error):

* the tensor-core body (int8 ``mma.sync``, the ADC and both folds in
  registers) for every read of more than ``DECODE_MAX_B`` tokens, K4's
  (prefill, training) and K5's;
* the decode body (CUDA-core ``__dp4a`` over a ``cp.async`` ring, split over
  crossbar tiles with a one-launch fold in ascending tile order) for forward
  K4 reads of at most ``DECODE_MAX_B`` tokens, the serving path's decode;
  ``decode_plan`` picks its columns and tiles a block per shape;
* the dp4a body (CUDA-core ``__dp4a``, a block walking every tile) for K4's
  MᵀVM reads and K5's reads of at most ``DECODE_MAX_B`` tokens. K5's dp4a
  instances also run at any size when asked for by name
  (``mvm_sliced(..., body="dp4a")``): the same-work yardstick the other
  bodies are timed and checked against. Nothing on a path asks for it.

The transpose reads the same row-major planes in place. The source comment
says what bounds each body on the card and what is left for later.

The library builds at first use (``kernels.build``); nothing is compiled or
loaded at import, so CPU-only machines import this module freely. On fake
tensors (``kernels.common.is_fake``: the dry run's) a wrapper allocates what
its launch would, records the launch and its work in ``common.fake_work``
and launches nothing; its own counters count real launches only. The
wrappers launch on the current stream and count their launches:
``launches`` (forward) and ``transpose_launches`` (MᵀVM) over every
instance, and ``instances`` by instance name (``instance_name``; decode-body
reads end in ``"_decode"``, dp4a-body reads in ``"_dp4a"``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.core.fixed_point import device_pattern_words
from repro_torch.core.slicing import SliceSpec
from repro_torch.kernels import build as _build
from repro_torch.kernels.common import fake_work, is_fake, on_card, read_work
from .ref import READ_SALT, READ_SALT_T, XBAR_ROWS, read_offset_scales

SOURCE = Path(__file__).resolve().parent / "csrc" / "mvm_sliced_fused.cu"
IO_BITS_BUILT = (8, 12, 16)  # io widths the source instantiates (the fig9 io sweep reads at 8 and 12)
MAX_SLICES = 16
# reads of at most this many tokens (decode): K4 forward on the decode body,
# K4 MᵀVM and K5 on the dp4a body; larger reads on the tensor-core body
DECODE_MAX_B = 4
BODY_CODES = {"dp4a": 0, "mma": 1, "decode": 2}  # the C interface's body argument
H100_SMS = 132  # streaming multiprocessors of the card the plan is tuned for (the planner's default)
# the decode body's geometry, which the source owns (dec::BN, dec::MAX_THREADS
# / dec::NQ): the planner's copy, checked against the library when it loads
DECODE_BN = 32  # output columns a decode-body block owns
DECODE_MAX_SB = 64  # slices x tokens: one thread per (slice, token, 4 columns), 512 a block
DECODE_WAVES = 8  # the decode plan wants at least this many blocks per SM


def build_kernel() -> _build.Built:
    """Compile the kernel (or reuse an identical build)."""
    return _build.build("mvm_sliced_fused", [SOURCE])


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build_kernel().path))
    lib.panther_mvm_sliced_fused.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.panther_mvm_sliced.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.panther_mvm_sliced_fused, lib.panther_mvm_sliced):
        fn.restype = ctypes.c_int
    bn, max_sb = ctypes.c_int(), ctypes.c_int()
    lib.panther_decode_geometry(ctypes.byref(bn), ctypes.byref(max_sb))
    if (bn.value, max_sb.value) != (DECODE_BN, DECODE_MAX_SB):
        raise RuntimeError(f"the decode body's geometry (BN {bn.value}, S·B <= {max_sb.value}) is not the "
                           f"planner's (DECODE_BN {DECODE_BN}, DECODE_MAX_SB {DECODE_MAX_SB})")
    return lib


def instance_name(transpose: bool, io_bits: int, noisy: bool = False, body: str = "mma") -> str:
    """The key of a read's instance in ``instances``: e.g. ``"io16"``,
    ``"transpose_io8"``, ``"io16_read_noise"``; reads on the decode body
    end in ``"_decode"``, on the dp4a body in ``"_dp4a"`` (``body_for``)."""
    suffix = "" if body == "mma" else f"_{body}"
    return f"{'transpose_' if transpose else ''}io{io_bits}{'_read_noise' if noisy else ''}{suffix}"


def uses_decode_body(n_tokens: int) -> bool:
    """Whether a K4 read of ``n_tokens`` is a decode read (the decode body
    forward, the dp4a body for the MᵀVM): by shape only."""
    return n_tokens <= DECODE_MAX_B


def body_for(n_tokens: int, transpose: bool, fused: bool = True) -> str:
    """The body a read runs, K4's (``fused``) or K5's: ``"decode"``,
    ``"dp4a"`` or ``"mma"``. The decode body takes float inputs only."""
    if not uses_decode_body(n_tokens):
        return "mma"
    return "dp4a" if transpose or not fused else "decode"


class DecodePlan(NamedTuple):
    group: int  # consecutive 128-row crossbar tiles a block owns (the kernel's one blocking argument)
    col_blocks: int  # grid x: blocks of DECODE_BN columns
    tile_groups: int  # grid y


def decode_plan(n_tokens: int, M: int, N: int, S: int, sms: int = H100_SMS) -> DecodePlan:
    """The decode body's blocking of a forward read of ``n_tokens`` through
    planes [S, M, N]: ``DECODE_BN`` columns a block, and the largest
    power-of-two group of tiles that still launches ``DECODE_WAVES·sms``
    blocks (one tile a block when even that falls short)."""
    if S * n_tokens > DECODE_MAX_SB:
        raise ValueError(f"the decode body takes S·B <= {DECODE_MAX_SB}, got S={S} B={n_tokens}")
    tiles, cols = -(-M // XBAR_ROWS), -(-N // DECODE_BN)
    group = 1
    while group * 2 <= tiles and cols * -(-tiles // (group * 2)) >= DECODE_WAVES * sms:
        group *= 2
    return DecodePlan(group, cols, -(-tiles // group))


# the decode body's tickets, one int32 a column block, by (device, stream):
# zero between reads (the last block of a column resets its own), so a read
# needs no memset, and reads on two streams never share one
_TICKETS: dict = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a graph would own the array and zero it on every replay; make it
            # (and set the kernel's shared-memory limit) with one read on the
            # capture stream before the capture
            raise RuntimeError("the decode body's tickets for this stream and shape do not exist yet: run "
                               "one decode read of this shape on the stream before capturing a CUDA graph")
        t = _TICKETS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_read(planes: torch.Tensor, x: torch.Tensor, x_dtype, spec: SliceSpec, io_bits: int, adc_bits,
                transpose: bool):
    if not (on_card(planes) and on_card(x)):
        raise ValueError("the sliced-MVM kernels take CUDA tensors only")
    if planes.device != x.device:
        raise ValueError(f"tensors on different devices: {planes.device}, {x.device}")
    if planes.dtype != torch.int8 or planes.dim() != 3 or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous int8 [S, M, N], got {planes.dtype} {tuple(planes.shape)}")
    if x.dtype != x_dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous {x_dtype} [B, M], got {x.dtype} {tuple(x.shape)}")
    S, M, N = planes.shape
    contract = N if transpose else M
    if x.shape[1] != contract or S != spec.n_slices:
        raise ValueError(f"x {tuple(x.shape)} / spec S={spec.n_slices} do not match planes {tuple(planes.shape)}")
    if S > MAX_SLICES:
        raise ValueError(f"at most {MAX_SLICES} slices, got {S}")
    if io_bits not in IO_BITS_BUILT:
        raise ValueError(f"io_bits {io_bits} not built; the kernel takes {IO_BITS_BUILT}")
    if adc_bits is not None and not 1 <= adc_bits <= 16:
        raise ValueError(f"adc_bits must be in [1, 16] or None, got {adc_bits}")


def _run(name: str, planes: torch.Tensor, x: torch.Tensor, spec: SliceSpec, adc_bits, transpose: bool,
         call, body: str, io_bits: int, noisy: bool = False) -> tuple:
    """Allocate the output and launch ``call(out, B, M, N, S, adc_bits,
    slice_bits, vec, transpose, stream)``; -> (out, launched). On fake
    planes (``common.is_fake``) allocate what the launch would (the decode
    body's workspace and tickets), record its work, and launch nothing."""
    S, M, N = planes.shape
    B = x.shape[0]
    out = torch.empty((B, M if transpose else N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out, False
    if (N if transpose else M) == 0:
        return out.zero_(), False
    if is_fake(planes):
        if body == "decode":
            plan = decode_plan(B, M, N, S)
            torch.empty((-(-M // XBAR_ROWS), B, N), dtype=torch.float32, device=planes.device)
            torch.empty(max(plan.col_blocks, 1024), dtype=torch.int32, device=planes.device)
        fake_work.add(name, instance_name(transpose, io_bits, noisy, body),
                      read_work(B, M, N, S, io_bits, fused=name == "mvm_sliced_fused"))
        return out, False
    bits = (ctypes.c_int * S)(*spec.bits_lsb_first)
    vec = int(N % 4 == 0 and planes.data_ptr() % 4 == 0)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = call(out.data_ptr(), B, M, N, S, 0 if adc_bits is None else adc_bits,
                   ctypes.cast(bits, ctypes.c_void_p), vec, int(transpose), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
    return out, True


def _count(wrapper, transpose: bool, io_bits: int, noisy: bool = False, body: str = "mma") -> None:
    if transpose:
        wrapper.transpose_launches += 1
    else:
        wrapper.launches += 1
    wrapper.instances[instance_name(transpose, io_bits, noisy, body)] += 1


def mvm_sliced_fused(
    planes: torch.Tensor,
    x: torch.Tensor,
    frac_bits: torch.Tensor,
    *,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    dev=None,
    tile0: int = 0,
    col0: int = 0,
) -> torch.Tensor:
    """planes int8 [S, M, N]; x float32 [B, M] ([B, N] when ``transpose``);
    frac_bits int32 1-element tensor (the DAC exponent, read by the kernel
    on the device) -> f32 [B, N] ([B, M]) on the product grid. All CUDA
    tensors on one device, contiguous. ``dev``: None, or a DeviceModel with
    ``read_noise > 0`` for the noisy instance, whose offsets are keyed at
    the global crossbar tile ``tile0 + k`` and column ``col0 + n``. Raises on
    what the kernel does not take."""
    _check_read(planes, x, torch.float32, spec, io_bits, adc_bits, transpose)
    if not on_card(frac_bits) or frac_bits.device != planes.device:
        raise ValueError(f"frac_bits on {frac_bits.device}, planes on {planes.device}")
    if frac_bits.dtype != torch.int32 or frac_bits.numel() != 1:
        raise ValueError("frac_bits must be a 1-element int32 tensor")
    if dev is not None and not dev.read_noise > 0.0:
        raise ValueError("the noisy instance takes a DeviceModel with read_noise > 0 (None for the ideal one)")
    off, words = None, (0, 0)
    if dev is not None:
        off = ctypes.cast((ctypes.c_float * spec.n_slices)(*read_offset_scales(dev, spec)), ctypes.c_void_p)
        words = device_pattern_words(dev.stuck_seed, READ_SALT_T if transpose else READ_SALT)
    body = body_for(x.shape[0], transpose)
    fn = None if is_fake(planes) else _lib().panther_mvm_sliced_fused

    def call(out, B, M, N, S, adc, bits, vec, trans, stream):
        if body != "decode":
            return fn(planes.data_ptr(), x.data_ptr(), frac_bits.data_ptr(), out, B, M, N, S, io_bits, adc,
                      bits, vec, trans, off, *words, int(tile0), int(col0), BODY_CODES[body], None, None, 0, 0,
                      stream)
        plan = decode_plan(B, M, N, S, _sm_count(planes.device.index))
        tickets = _tickets(planes.device, stream, plan.col_blocks)
        # the tile terms the last block of each column folds: held until the
        # launch is queued, then freed to the caching allocator in stream order
        ws = torch.empty((-(-M // XBAR_ROWS), B, N), dtype=torch.float32, device=planes.device)
        return fn(planes.data_ptr(), x.data_ptr(), frac_bits.data_ptr(), out, B, M, N, S, io_bits, adc,
                  bits, vec, trans, off, *words, int(tile0), int(col0), BODY_CODES[body], ws.data_ptr(),
                  tickets.data_ptr(), tickets.numel(), plan.group, stream)

    out, launched = _run("mvm_sliced_fused", planes, x, spec, adc_bits, transpose, call, body, io_bits,
                         dev is not None)
    if launched:
        _count(mvm_sliced_fused, transpose, io_bits, dev is not None, body)
    return out


def mvm_sliced(
    planes: torch.Tensor,
    x_q: torch.Tensor,
    *,
    spec: SliceSpec,
    io_bits: int = 16,
    adc_bits: int | None = None,
    transpose: bool = False,
    body: str | None = None,
) -> torch.Tensor:
    """planes int8 [S, M, N]; x_q int32 [B, M] ([B, N] when ``transpose``)
    on the ``io_bits`` DAC grid (``|x_q| <= 2^(io_bits-1) - 1``: the bits
    at and above ``io_bits - 1`` are not streamed) -> f32 [B, N] ([B, M])
    on the product grid. CUDA tensors on one device, contiguous. ``body``:
    None for the body the shape takes (``body_for``), or ``"dp4a"`` /
    ``"mma"`` by name (``"dp4a"``: the same-work yardstick)."""
    _check_read(planes, x_q, torch.int32, spec, io_bits, adc_bits, transpose)
    if body is None:
        body = body_for(x_q.shape[0], transpose, fused=False)
    if body not in ("dp4a", "mma"):
        raise ValueError(f"mvm_sliced runs the 'mma' or the 'dp4a' body, not {body!r}")
    fn = None if is_fake(planes) else _lib().panther_mvm_sliced

    def call(out, B, M, N, S, adc, bits, vec, trans, stream):
        return fn(planes.data_ptr(), x_q.data_ptr(), out, B, M, N, S, io_bits, adc, bits, vec, trans,
                  BODY_CODES[body], stream)

    out, launched = _run("mvm_sliced", planes, x_q, spec, adc_bits, transpose, call, body, io_bits)
    if launched:
        _count(mvm_sliced, transpose, io_bits, body=body)
    return out


for _wrapper in (mvm_sliced_fused, mvm_sliced):
    _wrapper.launches = 0
    _wrapper.transpose_launches = 0
    _wrapper.instances = collections.Counter()
