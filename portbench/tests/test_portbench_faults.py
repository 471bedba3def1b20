"""A run with the timed path broken underneath comes out not correct.

Each fault is planted in the program's entry, ``RRTMGPSolver.update_fluxes``,
and the rest of a run is driven as ``run.py`` drives it (without its look
for a card): the window at a tiny size on the CPU, the check against the
reference, the result line. The faults a radiation step can have:

- ``stale``: the step returns the state it had, the fluxes of an earlier
  step, unchanged;
- ``half``: half of the columns left out, the other half's fluxes in their
  place;
- ``altered``: one flux value, the largest LW up flux, 5% off where it
  is produced (the widest limit, 1e-2 of the LW scale, sits below it).

On a mesh (one process, several cards) the columns are split over the
cards with no exchange between them; what stands for an exchange left out
is one card's work: ``stale_entry`` leaves the last mesh entry's columns
of every step as an earlier step left them. A sound run comes out correct
under the same limits.
"""

import json
import os

import pytest
import torch

import rrtmgp_tpu_torch as rt
from portbench import harness, run
from rrtmgp_tpu_torch.parallel.sharding import ColumnSharded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
ORIGINAL = rt.RRTMGPSolver.update_fluxes


def stale(self):
    if self.flux_lw is None:
        return ORIGINAL(self)
    return self.flux_lw, self.flux_sw


def _tensors(flux) -> list:
    """A flux field's tensors: its mesh entries' slices, or itself."""
    return list(flux.shards) if isinstance(flux, ColumnSharded) else [flux]


def half(self):
    out = ORIGINAL(self)
    for flux in (*self.flux_lw, *self.flux_sw):
        for t in _tensors(flux):
            n = t.shape[-1] // 2
            t[:, n:2 * n] = t[:, :n]
    return out


def altered(self):
    out = ORIGINAL(self)
    up = max(_tensors(self.flux_lw.flux_up), key=lambda t: float(t.max()))
    up.view(-1)[int(up.argmax())] *= 1.05
    return out


def stale_entry(self):
    before = None if self.flux_lw is None else (self.flux_lw.shards[-1], self.flux_sw.shards[-1])
    out = ORIGINAL(self)
    if before is not None:
        for new, old in zip((self.flux_lw.shards[-1], self.flux_sw.shards[-1]), before):
            for a, b in zip(new, old):
                if isinstance(a, torch.Tensor):
                    a.copy_(b)
    return out


FAULTS = {"stale": stale, "half": half, "altered": altered}
#: faults only a mesh can have, and the cells they apply to
MESH_FAULTS = {"stale_entry": stale_entry}
MESH_CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


def _result(cell: str, seed: int) -> dict:
    spec = run.cell_spec(BENCH, cell)
    spec["cfg"].update(ncol=16, nlay=8)
    res = harness.run_cell(spec["cfg"], spec["traffic"], seed, 0.0, False, "cpu", 0.0)
    return run.result_line(spec, res, {}, False, {})[0]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(rt.RRTMGPSolver, "update_fluxes", FAULTS[fault])
    out = _result(cell, 2**31 + 7)
    assert out["correct"] is False and out["failed"] >= 1, out["compared"]


@pytest.mark.parametrize("cell", MESH_CELLS)
@pytest.mark.parametrize("fault", sorted(MESH_FAULTS))
def test_mesh_fault_comes_out_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(rt.RRTMGPSolver, "update_fluxes", MESH_FAULTS[fault])
    out = _result(cell, 2**31 + 7)
    assert out["correct"] is False and out["failed"] >= 1, out["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_comes_out_correct(cell):
    out = _result(cell, 2**31 + 7)
    assert out["correct"] is True and out["failed"] == 0, out["compared"]
    assert torch.get_default_dtype() == torch.float32
