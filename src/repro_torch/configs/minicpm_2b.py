"""minicpm-2b [dense]: 40L d=2304 36H MHA(kv=36) d_ff=5760 vocab=122753,
llama-like, trained with the WSD schedule (repro.optim.schedules.wsd)
[arXiv:2404.06395]."""
import dataclasses

from repro_torch.models.common import LMConfig

CONFIG = LMConfig(
    arch_id="minicpm-2b",
    d_model=2304,
    n_layers=40,
    vocab=122753,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    act="silu",
    pattern=(("dense", 40),),
    rope_theta=10000.0,
    tie_embeddings=True,
    norm_eps=1e-5,
)

SMOKE = dataclasses.replace(
    CONFIG,
    d_model=64,
    n_layers=2,
    vocab=127,  # odd vocab on purpose (122753 is odd too)
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=96,
    pattern=(("dense", 2),),
)
