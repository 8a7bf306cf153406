"""The paper's analytic figures on the port (``repro_torch.benchmarks.fig1_*``
and ``fig11``-``fig15``) and the two energy examples against the reference's
``benchmarks/`` and ``examples/`` run in-process: the printed CSV rows and
reports are equal, character for character (host arithmetic, the same
float operations, the same formatting)."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the reference's benchmarks/ and examples/

FIGURES = ("fig1_primitives", "fig11_sgd_energy", "fig12_minibatch_energy", "fig13_time", "fig14_variants",
           "fig15_gpu")


def _printed(capsys, fn, *args) -> str:
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out


@pytest.mark.parametrize("fig", FIGURES)
def test_figure_rows_equal_the_reference(capsys, fig):
    port = importlib.import_module(f"repro_torch.benchmarks.{fig}")
    ref = importlib.import_module(f"benchmarks.{fig}")
    got = _printed(capsys, port.main)
    assert got == _printed(capsys, ref.main)
    rows = got.splitlines()
    assert rows and all(r.startswith(f"{fig.split('_')[0]}/") and r.count(",") >= 2 for r in rows)


def test_isa_energy_report_equals_the_reference(capsys):
    from examples import isa_energy_report as ref
    from repro_torch.examples import isa_energy_report as port

    got = _printed(capsys, port.main)
    assert got == _printed(capsys, ref.main)
    assert "energy reductions:" in got


@pytest.mark.parametrize("argv", [[], ["--plan", "hetero", "--tokens", "256"], ["--tiki", "--tokens", "8"]],
                         ids=["default", "hetero", "tiki"])
def test_energy_report_equals_the_reference(capsys, monkeypatch, argv):
    """The plan-aware report over the shapes of Fig 10's smoke model
    (nothing allocated): the plan digest, the per-leaf table and the
    ratios, line for line."""
    from examples import energy_report as ref
    from repro_torch.examples import energy_report as port

    monkeypatch.chdir(ROOT)  # the reference's --plan hetero imports benchmarks/ from the working directory
    got = _printed(capsys, port.main, argv)
    assert got == _printed(capsys, ref.main, argv)
    assert "below serial-write ReRAM" in got
