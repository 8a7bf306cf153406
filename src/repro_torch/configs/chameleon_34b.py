"""chameleon-34b [vlm]: 48L d=8192 64H GQA(kv=8) d_ff=22016 vocab=65536,
early-fusion over a unified text+VQ-image token vocabulary with qk-norm
[arXiv:2405.09818]. The VQ image tokenizer is a frontend stub: inputs are
token ids over the unified vocab.
"""
import dataclasses

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="chameleon-34b",
    d_model=8192,
    n_layers=48,
    vocab=65536,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    act="silu",
    pattern=(("dense", 48),),
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=2,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    pattern=(("dense", 2),),
)
