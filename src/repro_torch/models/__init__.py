from . import attention, common, lm, mlp
from .common import LMConfig, MLACfg, MoECfg, SSMCfg, XbarWeight, XLSTMCfg, ZambaCfg

__all__ = [
    "attention",
    "common",
    "lm",
    "mlp",
    "LMConfig",
    "XbarWeight",
    "MLACfg",
    "MoECfg",
    "SSMCfg",
    "XLSTMCfg",
    "ZambaCfg",
]
