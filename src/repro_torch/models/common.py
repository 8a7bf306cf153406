"""Shared model components (port of ``repro.models.common``): configs,
the finite-ADC fidelity wrap, norms, RoPE, initializers.

Parameters are plain nested dicts of tensors with the JAX trees' layout:
layer groups are stacked on a leading ``[L, ...]`` axis, and a leaf's path is
its keys and list indices joined by '/' (``groups/0/attn/wqkv``).
Initializers draw from an explicit ``torch.Generator`` on the target device
(``jax.random`` streams cannot be reproduced in torch; tests carry JAX
weights across with ``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.slicing import DEFAULT_SPEC, SliceSpec


class ShapeDtype(NamedTuple):
    """Shape and dtype of a tensor not yet allocated (cache specs)."""

    shape: tuple
    dtype: torch.dtype


# ------------------------ fidelity (finite-ADC) mode -------------------------


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Non-ideal ReRAM device physics. The port carries the configuration;
    the write physics belongs to the training slice and the read noise has
    no kernel yet, so a read-noisy model raises at the read."""

    write_noise: float = 0.0
    asym_up: float = 1.0
    asym_down: float = 1.0
    stuck_frac: float = 0.0
    stuck_seed: int = 0
    read_noise: float = 0.0

    def reads_nonideal(self) -> bool:
        return self.read_noise > 0.0


@dataclasses.dataclass(frozen=True)
class FidelityConfig:
    """Crossbar-in-the-loop read configuration: ``io_bits`` DAC width,
    ``adc_bits_fwd``/``adc_bits_bwd`` ADC resolution per read direction
    (``None`` = ideal ADC), ``fwd``/``bwd`` gates (a disabled path takes the
    dense matmul), ``spec`` the plane layout, ``margin_bits`` DAC headroom,
    ``device`` the non-ideal physics (None = ideal)."""

    io_bits: int = 16
    adc_bits_fwd: int | None = None
    adc_bits_bwd: int | None = None
    fwd: bool = True
    bwd: bool = True
    spec: SliceSpec = DEFAULT_SPEC
    margin_bits: int = 1
    device: DeviceModel | None = None


class XbarWeight:
    """A crossbar-mapped weight as the serving forward sees it: the int8
    digit planes (slice dim behind any layer-stack dims), the per-tensor
    ``frac_bits`` broadcast over the stack, and its ``FidelityConfig``.
    ``w`` is the dense copy, kept only when ``fid.fwd`` is off (serving
    through the planes never reads it, so the wrap drops it to save the
    device memory). Forward only: the training slice adds the operand
    gradient slots. Indexing selects one layer of a stacked group."""

    __slots__ = ("w", "planes", "frac_bits", "fid")

    def __init__(self, w, planes, frac_bits, fid):
        self.w = w
        self.planes = planes
        self.frac_bits = frac_bits
        self.fid = fid

    def __getitem__(self, i) -> "XbarWeight":
        return XbarWeight(None if self.w is None else self.w[i], self.planes[i],
                          self.frac_bits[i], self.fid)


def path_str(path) -> str:
    """'/'-join a key path (dict keys and list indices) — the canonical leaf
    path string of the plan rules, as in the JAX package."""
    return "/".join(str(k) for k in path)


# Param-dict keys consumed through ``xbar_linear`` (each used exactly once per
# layer application). ``embed`` is excluded: it is read by a gather.
OPERAND_LINEAR_KEYS = frozenset(
    {"wqkv", "wq_dkv", "wo", "wi_gate", "wi_up", "w_uk", "w_uv"}
)


def _xbar_linear_fid_fwd(x: torch.Tensor, ww: XbarWeight) -> torch.Tensor:
    from repro_torch.core.mvm import fidelity_read  # lazy: core stays model-free

    if ww.fid.fwd:
        return fidelity_read(ww.planes, ww.frac_bits, x, ww.fid).to(x.dtype)
    return x @ ww.w.to(x.dtype)


def xbar_linear(x: torch.Tensor, w, dtype=None) -> torch.Tensor:
    """``x @ w`` where ``w`` may be a plain tensor or a fidelity
    ``XbarWeight``, whose read goes through the finite-ADC engine (f32 read,
    cast back to the activation dtype)."""
    if isinstance(w, XbarWeight):
        if dtype is not None:
            x = x.to(dtype)
        return _xbar_linear_fid_fwd(x, w)
    return x @ w.to(dtype if dtype is not None else x.dtype)


# ------------------------------- configs -------------------------------------


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    proj_factor: float = 2.0
    n_heads: int = 4
    conv_width: int = 4
    slstm_ff_factor: float = 4 / 3


@dataclasses.dataclass(frozen=True)
class ZambaCfg:
    share_every: int = 6
    n_shared_invocations: int = 6


@dataclasses.dataclass(frozen=True)
class LMConfig:
    arch_id: str
    d_model: int
    n_layers: int
    vocab: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    # (block_name, count) groups applied in order; a counted group keeps its
    # params stacked on a leading axis
    pattern: tuple = ()
    act: str = "silu"  # gated-MLP activation: silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    window: int | None = None
    softcap_attn: float | None = None
    softcap_final: float | None = None
    qk_norm: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model) (gemma)
    tie_embeddings: bool = True
    input_mode: str = "tokens"
    post_norm: bool = False
    norm_eps: float = 1e-6
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    ssm: SSMCfg | None = None
    xlstm: XLSTMCfg | None = None
    zamba: ZambaCfg | None = None
    fidelity: FidelityConfig | None = None
    dense_ff_prefix: int | None = None
    dtype: Any = torch.bfloat16
    supports_long_context: bool = False

    @property
    def kv_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)


# ---------------------------------------------------------------------------


def rms_norm_init(d: int, *, stack: tuple = (), device=None) -> dict:
    return {"scale": torch.zeros((*stack, d), dtype=torch.float32, device=device)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** e)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Rotates the two
    halves of the head dim (not interleaved pairs), in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale: float | None = None,
               *, stack: tuple = (), device=None) -> torch.Tensor:
    """N(0, 1/d_in) f32 weights ``[*stack, d_in, d_out]``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((*stack, d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale)


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device=None) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02)
