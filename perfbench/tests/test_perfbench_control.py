"""The check can fail.  At a size a test run holds, on the CPU:

- the control, the plain reference put in the program's place and
  computed in TF32 (one precision below the configurations' strict
  float32), comes out as not correct for each cell;
- a run whose timed path is broken underneath comes out as not correct,
  for each fault the cell can have: an answer altered where it is
  produced, half of each batch left out (its answers taken from the other
  half).  (A cell on one chip has no exchange between chips, and a cell
  that serves queries has no step whose state could stay unchanged.)
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import check as chk  # noqa: E402
from perfbench.harness import run  # noqa: E402
from perfbench.tests.sizes import CELLS, SIZES  # noqa: E402
from perfbench.tools.control import control  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", (1, 2, 3))
def test_control_is_not_correct(cell, seed):
    numbers, limits = control(cell, seed, torch.device("cpu"), SIZES[cell],
                              root=ROOT)
    correct, checks = chk.verdict(numbers, limits)
    assert not correct, checks


def _altered(real):
    def query_batch(self, ws, mask=None):
        out = real(self, ws, mask)
        out[len(out) // 2].index += 1
        return out
    return query_batch


def _half_left_out(real):
    def query_batch(self, ws, mask=None):
        ws = np.atleast_2d(ws)
        h = max(1, ws.shape[0] // 2)
        out = real(self, ws[:h], mask)
        return (out * 3)[:ws.shape[0]]
    return query_batch


FAULTS = [(c, "altered") for c in CELLS] + [(c, "half") for c in CELLS]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    make = _altered if fault == "altered" else _half_left_out
    monkeypatch.setattr(HashQueryService, "query_batch",
                        make(HashQueryService.query_batch))
    out = run(ROOT, cell, 31_337, 0.5, False,
              require_cuda=False, device="cpu", size=SIZES[cell])
    assert not out["correct"], out["checks"]
