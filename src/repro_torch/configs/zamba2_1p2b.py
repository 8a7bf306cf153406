"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d=2048 with a SHARED attention+MLP
block (32H, kv=32, d_ff=8192) invoked after every 6 mamba blocks over
concat(h, x0), ssm_state=64 [arXiv:2411.15242]. Sub-quadratic backbone:
participates in long_500k (decode attends into the shared block's KV).

Layout: 6 x [6 mamba2 + shared-attn] + 2 trailing mamba2 = 38 mamba layers,
6 shared invocations.
"""
import dataclasses

from repro_torch.models.common import LMConfig, SSMCfg, ZambaCfg

CONFIG = LMConfig(
    arch_id="zamba2-1.2b",
    d_model=2048,
    n_layers=38,
    vocab=32000,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    act="gelu",
    pattern=(("zamba_unit", 6), ("mamba2", 2)),
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    zamba=ZambaCfg(share_every=6, n_shared_invocations=6),
    rope_theta=10000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
    supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=6,
    vocab=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    pattern=(("zamba_unit", 2), ("mamba2", 1)),
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=32),
    zamba=ZambaCfg(share_every=2, n_shared_invocations=2),
)
