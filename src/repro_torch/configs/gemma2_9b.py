"""gemma2-9b [dense]: 42L d=3584 16H GQA(kv=8) head_dim=256 d_ff=14336
vocab=256000, alternating local(4096)/global attention, logit softcaps,
sandwich norms [arXiv:2408.00118]."""
import dataclasses

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="gemma2-9b",
    d_model=3584,
    n_layers=42,
    vocab=256000,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    act="gelu",
    pattern=(("gemma2_pair", 21),),  # 21 x (local + global) = 42 layers
    window=4096,
    softcap_attn=50.0,
    softcap_final=30.0,
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    norm_eps=1e-6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=4,
    vocab=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    window=16,
    pattern=(("gemma2_pair", 2),),
)
