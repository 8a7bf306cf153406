"""xlstm-125m [ssm]: 12 blocks d=768, mLSTM matrix-memory blocks with 2 sLSTM
blocks interleaved (xLSTM[7:1]-style ratio), 4 heads, no separate FFN on
mLSTM blocks (d_ff=0 in the assignment; sLSTM blocks carry a 4/3 FFN)
[arXiv:2405.04517]. Sub-quadratic: participates in long_500k."""
import dataclasses

from repro_torch.models.common import LMConfig, XLSTMCfg

CONFIG = LMConfig(
    arch_id="xlstm-125m",
    d_model=768,
    n_layers=12,
    vocab=50304,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    pattern=(("mlstm", 4), ("slstm", 1), ("mlstm", 6), ("slstm", 1)),
    xlstm=XLSTMCfg(proj_factor=2.0, n_heads=4, conv_width=4),
    tie_embeddings=True,
    norm_eps=1e-6,
    supports_long_context=True,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=4,
    vocab=128,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    pattern=(("mlstm", 2), ("slstm", 1), ("mlstm", 1)),
    xlstm=XLSTMCfg(proj_factor=2.0, n_heads=2, conv_width=4),
)
