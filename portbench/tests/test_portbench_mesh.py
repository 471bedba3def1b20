"""The harness on a mesh: one process driving several cards through
``RRTMGPSolver(mesh=...)``, at a tiny size over a mesh of four CPU entries
(as the port's own mesh tests split the columns).

- a tiny mesh cell runs through ``run_cell``, and its gathered fluxes, its
  checked steps and the inputs it makes again for the check equal those of
  the same cell without a mesh, bit for bit;
- every copy pair sits on one device, and a source on another is refused;
- the step marks take the slowest card's time, the window waits for every
  card, and the peak is the fullest card's (with stand-ins for the CUDA
  calls), and one card gives what it gave before;
- ``card_idle_max_pct`` reads ``device_idle_pct`` on one card and the
  idler card on two, and ``run.py``'s busy time is averaged over the cards.
"""

import json
import os
import types

import pytest
import torch

from portbench import harness, inputs, program, run, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
MESH_CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


def _spec(cell: str, ncol=16, nlay=8, mesh=True):
    spec = run.cell_spec(BENCH, cell)
    spec["cfg"].update(ncol=ncol, nlay=nlay)
    if not mesh:
        del spec["cfg"]["mesh"]
    return spec


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_the_manifest_has_a_mesh_cell():
    assert MESH_CELLS, "no cell drives a mesh"


@pytest.mark.parametrize("cell", MESH_CELLS)
def test_mesh_run_equals_the_unsplit_run(cell):
    """The same seed through the mesh and through one solver: the same
    checked steps, the same fluxes to the bit (McICA is keyed on the global
    column), the same inputs for the check, and both correct."""
    seed = 2**32 + 11
    split, whole = _spec(cell), _spec(cell, mesh=False)
    assert split["cfg"]["mesh"] == 4
    got = harness.run_cell(split["cfg"], split["traffic"], seed, 0.0, False, "cpu", 0.0, keep_inputs=True)
    want = harness.run_cell(whole["cfg"], whole["traffic"], seed, 0.0, False, "cpu", 0.0, keep_inputs=True)
    assert got["checked_steps"] == want["checked_steps"]
    for (s, k, a), (t, j, b) in zip(got["checked"], want["checked"]):
        assert (s, k) == (t, j) and a.keys() == b.keys()
        for f in a:
            assert isinstance(a[f], torch.Tensor) and torch.equal(a[f], b[f]), f
    assert _tree_equal(got["inputs"], want["inputs"])
    assert got["per_step"] == want["per_step"]
    assert run.result_line(split, got, {}, False, {})[0]["correct"] is True


@pytest.mark.parametrize("cell", MESH_CELLS)
def test_copy_pairs_stay_on_each_card(cell):
    """One set of pairs a mesh entry, each pair on one device, the sources
    copies of the entry's own columns; a source on another device raises."""
    spec = _spec(cell)
    cfg, traffic = spec["cfg"], spec["traffic"]
    inp = inputs.make_inputs(cfg, 2**31 + 3, 2, "cpu")
    s = program.solver(cfg, traffic, inp)
    pairs = program.copy_pairs(s.as_, inp["states"][1])
    per_entry = len(pairs) // cfg["mesh"]
    assert per_entry * cfg["mesh"] == len(pairs) and per_entry >= 9
    per = cfg["ncol"] // cfg["mesh"]
    for e, (lo, device) in enumerate(zip(s.as_.offsets, s.as_.devices)):
        for dst, src in pairs[e * per_entry:(e + 1) * per_entry]:
            assert dst.device == src.device == device
            assert dst.data_ptr() != src.data_ptr()
        dst, src = pairs[e * per_entry]  # p_lay
        assert torch.equal(src, inp["states"][1]["p_lay"][:, lo:lo + per])
        assert src.data_ptr() != inp["states"][1]["p_lay"].data_ptr()
    # a source the solver's state does not share a device with is refused
    whole = program.solver(_spec(cell, mesh=False)["cfg"], traffic, inp)
    elsewhere = dict(inp["states"][1], p_lay=inp["states"][1]["p_lay"].to("meta"))
    with pytest.raises(ValueError, match="on meta"):
        program.copy_pairs(whole.as_, elsewhere)


def test_devices_of_a_cell():
    spec = _spec(MESH_CELLS[0])
    assert program.devices(spec["cfg"], "cuda") == [torch.device("cuda", i) for i in range(4)]
    assert program.devices(spec["cfg"], "cpu") == [torch.device("cpu")] * 4
    single = _spec(MESH_CELLS[0], mesh=False)
    assert program.devices(single["cfg"], "cuda") == ["cuda"]


class _Clock:
    """Stand-ins for ``torch.cuda``'s events, streams, synchronisation and
    memory readings: each card's events read a scripted time."""

    def __init__(self, times: dict):
        self.times = {d: list(t) for d, t in times.items()}
        self.synced, self.reset = [], []
        self.peaks = {}

    def install(self, monkeypatch):
        clock = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.t = None

            def record(self, stream):
                self.t = clock.times[str(stream.device)].pop(0)

            def elapsed_time(self, other):
                return other.t - self.t

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda d: types.SimpleNamespace(device=d))
        monkeypatch.setattr(torch.cuda, "synchronize", lambda d: clock.synced.append(str(d)))
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda d: clock.reset.append(str(d)))
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda d: clock.peaks[str(d)])


def test_one_card_marks_give_the_step_times_as_before(monkeypatch):
    clock = _Clock({"cuda": [0.0, 10.0, 25.0, 31.0]})
    clock.install(monkeypatch)
    marks = harness.Marks(["cuda"])
    for _ in range(4):
        marks.record()
    assert marks.step_ms() == [10.0, 15.0, 6.0]
    clock.peaks = {"cuda": 123}
    harness.sync(["cuda"])
    harness.reset_peaks(["cuda"])
    assert clock.synced == clock.reset == ["cuda"] and harness.peak_bytes(["cuda"]) == 123


def test_mesh_marks_take_the_slowest_card(monkeypatch):
    cards = [torch.device("cuda", i) for i in range(3)]
    clock = _Clock({"cuda:0": [0.0, 10.0, 20.0], "cuda:1": [1.0, 13.0, 21.0], "cuda:2": [2.0, 9.0, 30.0]})
    clock.install(monkeypatch)
    marks = harness.Marks(cards)
    for _ in range(3):
        marks.record()
    assert marks.step_ms() == [12.0, 21.0]
    clock.peaks = {"cuda:0": 5, "cuda:1": 9, "cuda:2": 7}
    harness.sync(cards)
    harness.reset_peaks(cards)
    assert clock.synced == clock.reset == ["cuda:0", "cuda:1", "cuda:2"]
    assert harness.peak_bytes(cards) == 9
    assert harness.peak_bytes([torch.device("cpu")] * 4) == 0


def _trace(ops, cards=None):
    """A reduced trace over a window of 1000 ns: ``ops`` as (start, end)."""
    device = [(f"op{i}", s, e, "update_fluxes") for i, (s, e) in enumerate(ops)]
    return tracing.Trace(window=(0, 1000), device=device, host=[], cards=cards or [])


def _read(name, trace):
    return harness.load_reader(name)(types.SimpleNamespace(trace=trace, steps=1))


def test_card_idle_on_one_card_is_device_idle():
    for cards in (None, [0, 0, 0]):
        trace = _trace([(-50, 100), (80, 300), (600, 700)], cards)
        assert _read("card_idle_max_pct", trace) == _read("device_idle_pct", trace) == pytest.approx(60.0)
        assert trace.card_busy_ns() == {0: trace.busy_ns()}


def test_card_idle_reads_the_idler_card():
    """Card 1 runs 200 ns of the window, card 0 900: the union over both
    reads 90% busy, the idler card 80% idle."""
    trace = _trace([(0, 500), (400, 900), (100, 200), (700, 800)], [0, 0, 1, 1])
    assert trace.card_busy_ns() == {0: 900, 1: 200}
    assert _read("device_idle_pct", trace) == pytest.approx(10.0)
    assert _read("card_idle_max_pct", trace) == pytest.approx(80.0)
    assert _read("card_idle_max_pct", _trace([])) is None


def test_busy_seconds_are_averaged_over_the_cards(monkeypatch):
    """``run.py``'s ``busy_s``: the union on one card, the mean of the
    cards' busy time on several."""
    trace = _trace([(0, 500), (400, 900), (100, 200), (700, 800)], [0, 0, 1, 1])
    res = dict(ctx=types.SimpleNamespace(trace=trace, peak_bytes=1, steps=1), per_step=[{}], checked_steps=[],
               check_s=0.0)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: res)
    monkeypatch.setattr(harness, "read_metrics", lambda ctx, names: {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "a card")
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])  # other test files load JAX in this process
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(a[0]) if not k.get("file") else None)
    for cell, busy in ((MESH_CELLS[0], (900 + 200) / 4 / 1e9),
                       (next(w["name"] for w in BENCH["workloads"] if w["chips"] == 1), 900 / 1e9)):
        monkeypatch.setattr(run, "result_line", lambda spec, res, metrics, trace, device: (device, []))
        assert run.main(["--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "1"]) == 0
        out = json.loads(lines[-1])
        assert out["busy_s"] == pytest.approx(busy) and out["window_s"] == pytest.approx(1e-6)
