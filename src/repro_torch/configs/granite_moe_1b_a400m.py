"""granite-moe-1b-a400m [moe]: 24L d=1024 16H GQA(kv=8) vocab=49155,
MoE 32 experts top-8, expert d_ff=512
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import dataclasses

from repro_torch.models.common import LMConfig, MoECfg

CONFIG = LMConfig(
    arch_id="granite-moe-1b-a400m",
    d_model=1024,
    n_layers=24,
    vocab=49155,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    act="silu",
    pattern=(("moe", 24),),
    moe=MoECfg(n_experts=32, top_k=8, d_ff_expert=512),
    rope_theta=10000.0,
    tie_embeddings=True,
    norm_eps=1e-6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=2,
    vocab=131,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=32,
    pattern=(("moe", 2),),
    moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0),
)
