"""CSV row emission shared by the port's figure benchmarks: the reference's
``benchmarks/common.emit`` format, ``name,us_per_call,derived``."""
from __future__ import annotations


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.2f},{derived}")
