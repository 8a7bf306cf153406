"""phi4-mini-3.8b [dense]: 32L d=3072 24H GQA(kv=8) d_ff=8192 vocab=200064,
RoPE + SwiGLU [arXiv:2412.08905]."""
import dataclasses

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="phi4-mini-3.8b",
    d_model=3072,
    n_layers=32,
    vocab=200064,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    act="silu",
    pattern=(("dense", 32),),
    rope_theta=10000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=2,
    vocab=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    pattern=(("dense", 2),),
)
