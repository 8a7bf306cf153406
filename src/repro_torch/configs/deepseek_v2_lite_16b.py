"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H MLA(kv_lora=512) vocab=102400;
layer 0 dense FFN, layers 1-26 MoE: 64 routed experts top-6 + 2 shared,
expert d_ff=1408 [arXiv:2405.04434]."""
import dataclasses

from repro_torch.models.common import LMConfig, MLACfg, MoECfg

CONFIG = LMConfig(
    arch_id="deepseek-v2-lite-16b",
    d_model=2048,
    n_layers=27,
    vocab=102400,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,  # per-expert width (assignment)
    act="silu",
    pattern=(("mla_dense", 1), ("mla_moe", 26)),
    dense_ff_prefix=10944,  # layer-0 dense FFN width
    mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2, d_ff_shared=1408),
    rope_theta=10000.0,
    tie_embeddings=False,
    norm_eps=1e-6,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=3,
    vocab=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=32,
    dense_ff_prefix=96,
    pattern=(("mla_dense", 1), ("mla_moe", 2)),
    mla=MLACfg(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    # capacity_factor=8: no token drops, so prefill+decode == forward exactly
    # (production keeps 1.25; dropped tokens ride the residual)
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1, d_ff_shared=32, capacity_factor=8.0),
)
