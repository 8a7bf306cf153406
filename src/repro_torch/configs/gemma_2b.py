"""gemma-2b [dense]: 18L d=2048 8H MQA(kv=1) head_dim=256 GeGLU d_ff=16384
vocab=256000 [arXiv:2403.08295]."""
import dataclasses

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="gemma-2b",
    d_model=2048,
    n_layers=18,
    vocab=256000,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    act="gelu",  # GeGLU
    pattern=(("dense", 18),),
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    norm_eps=1e-6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=2,
    vocab=128,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    pattern=(("dense", 2),),
)
