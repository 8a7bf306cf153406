from . import baselines, panther, schedules
from .baselines import AdamWState, SGDState, adamw_init, adamw_update, sgd_init, sgd_update
from .panther import PantherConfig, PantherState, SlicedTensor, tiki_taka

__all__ = ["baselines", "panther", "schedules", "PantherConfig", "PantherState", "SlicedTensor", "tiki_taka",
           "SGDState", "sgd_init", "sgd_update", "AdamWState", "adamw_init", "adamw_update"]
