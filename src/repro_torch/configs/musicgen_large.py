"""musicgen-large [audio]: 48L d=2048 32H MHA(kv=32) d_ff=8192 vocab=2048 —
decoder-only over EnCodec audio tokens [arXiv:2306.05284]. The EnCodec
frontend is a stub: the inputs are precomputed frame embeddings [B, S,
d_model]; the head predicts codebook tokens (vocab=2048).
"""
import dataclasses

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="musicgen-large",
    d_model=2048,
    n_layers=48,
    vocab=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    act="gelu",
    pattern=(("dense", 48),),
    input_mode="embeddings",
    tie_embeddings=False,
    rope_theta=10000.0,
    norm_eps=1e-5,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=2,
    vocab=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    pattern=(("dense", 2),),
)
