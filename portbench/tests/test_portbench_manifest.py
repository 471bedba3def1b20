"""``BENCHMARK.json`` and the files it names: every cell resolves to its
configuration, traffic and limits; every metric has a reader; names,
units and texts keep to the benchmark's character rules; and the window's
machinery (the state copied into the solver in place, the closed loop,
the check) runs at a tiny size on the CPU through the port's plain path,
while ``run.py`` itself refuses to run without a card.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import compare, harness, inputs, program, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    assert BENCH["command"][1].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _text(m["layer"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and _text(c["source"]) and _text(c["why"])
        assert c["source"].startswith("https://") and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _text(w["why"])
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    spec = run.cell_spec(BENCH, cell)
    config = next(c for c in BENCH["configs"] if c["name"] == spec["cell"]["config"])
    assert config["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    assert spec["cfg"]["dtype"] in ("float32", "float64") and spec["cfg"]["nlay"] >= 1
    assert spec["traffic"]["loop"] == "closed" and spec["traffic"]["states"] >= 2
    assert set(spec["limits"]) == set(compare.NUMBERS)
    assert len(spec["end_to_end"]) >= 2 and "setup_s" in spec["end_to_end"] and spec["per_layer"]
    # a mesh has one entry a card the cell asks for; a cell without one runs on one card
    assert spec["cell"]["chips"] == spec["cfg"].get("mesh", 1)
    assert spec["cfg"]["ncol"] % spec["cell"]["chips"] == 0
    # every metric a cell's runs report has a reader
    for name in [*spec["end_to_end"], *spec["per_layer"]]:
        assert callable(harness.load_reader(name))


def test_configuration_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert os.path.isfile(os.path.join(ROOT, f))


def _tiny(cell: str, ncol=12, nlay=7):
    spec = run.cell_spec(BENCH, cell)
    spec["cfg"].update(ncol=ncol, nlay=nlay)
    return spec


@pytest.mark.parametrize("cell", CELLS)
def test_copy_in_equals_a_fresh_solver(cell):
    """After a state is copied into the solver in place, its step equals
    that of a solver built on that state."""
    spec = _tiny(cell)
    cfg, traffic = spec["cfg"], spec["traffic"]
    inp = inputs.make_inputs(cfg, 2**31 + 99, 2, "cpu")
    s = program.solver(cfg, traffic, inp)
    s.advance_step(3)
    s.update_fluxes()
    for dst, src in program.copy_pairs(s.as_, inp["states"][1]):
        dst.copy_(src)
    s.advance_step(5)
    s.update_fluxes()
    fresh = program.solver(cfg, traffic, dict(inp, states=[inp["states"][1]]))
    fresh.advance_step(5)
    fresh.update_fluxes()
    got, want = program.gather(program.fluxes(s)), program.gather(program.fluxes(fresh))
    for f in want:
        assert torch.equal(got[f], want[f]), f
    # and the copy touched every tensor of the state
    assert all(torch.equal(d, src) for d, src in program.copy_pairs(s.as_, inp["states"][1]))


@pytest.mark.parametrize("cell", CELLS)
def test_window_runs_on_the_cpu(cell):
    """The closed loop, its step marks and the check, at a tiny size: both
    states are checked, and a sound run reads under the limits."""
    spec = _tiny(cell)
    res = harness.run_cell(spec["cfg"], spec["traffic"], 2**32 + 2, 0.05, False, "cpu", 0.0)
    ctx = res["ctx"]
    assert ctx.steps >= 2 and len(ctx.step_ms) == ctx.steps and ctx.setup_s > 0
    warm = spec["traffic"]["warmup_steps"]
    assert {s % 2 for s in res["checked_steps"]} == {0, 1} and min(res["checked_steps"]) >= warm
    out, lines = run.result_line(spec, res, harness.read_metrics(ctx, ["columns_per_s", "step_ms_p95"]),
                                 False, {})
    assert out["correct"] and out["failed"] == 0 and list(out)[-1] == "compared"
    assert len(lines) == len(compare.NUMBERS)


def test_run_refuses_without_a_card(tmp_path):
    """On a machine without CUDA, ``run.py`` prints no result and exits 3."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "3000000001",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""
    assert "CUDA" in out.stderr
