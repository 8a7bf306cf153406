from . import attention, common, lm, mlp
from .common import LMConfig, MLACfg, MoECfg, OuterProductGrad, SSMCfg, XbarWeight, XLSTMCfg, ZambaCfg

__all__ = [
    "attention",
    "common",
    "lm",
    "mlp",
    "LMConfig",
    "OuterProductGrad",
    "XbarWeight",
    "MLACfg",
    "MoECfg",
    "SSMCfg",
    "XLSTMCfg",
    "ZambaCfg",
]
