"""A configuration in another precision than float32, at small sizes on the
CPU:

- the control computes in the precision below the configuration's:
  bfloat16 for float32 (as before: the same readings), float32 for float64;
- a float64 cell's window runs with the solver's column chunking forced
  by the configuration's ``chunk_budget_gb`` (the solver's
  ``$RRTMGP_CHUNK_BUDGET_GB`` while it is built, the run's own restored
  after) and passes the cell's limits, and a float32 run of the same
  configuration, the program's own path in the precision below, fails
  them;
- ``lw_clear_mega_f64_roofline`` reads only the ``double`` instantiation
  of the lw_clear_mega kernel, at the f64 peak, over the bytes of the f64
  tensors; a trace of ``float`` kernels gives it nothing to read.
"""

import json
import os
import types
import warnings

import pytest
import torch

from portbench import compare, harness, inputs, program, reference, run, tracing, work
from rrtmgp_tpu_torch.api import F64_TENSOR_EQUIVALENTS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
F64_CELLS = [c for c in CELLS if run.cell_spec(BENCH, c)["cfg"]["dtype"] == "float64"]
F32_CELL = "dyamond_clear.lw_noscat"
SEED = 2**32 + 23
K7 = "void rrtmgp::lw_clear_mega_kernel<{}, false, false, 0, false>(rrtmgp::OpticsInT<{}>, rrtmgp::Dims)"


def _spec(cell: str, ncol=24, nlay=10):
    spec = run.cell_spec(BENCH, cell)
    spec["cfg"].update(ncol=ncol, nlay=nlay)
    return spec


def test_the_manifest_has_a_float64_cell():
    assert F64_CELLS, "no cell runs a float64 configuration"


@pytest.mark.parametrize("cell", CELLS)
def test_control_precision_follows_the_configuration(cell):
    cfg = run.cell_spec(BENCH, cell)["cfg"]
    below = {"float32": torch.bfloat16, "float64": torch.float32}[cfg["dtype"]]
    assert compare.control_dtype(cfg) == below


def test_float32_control_reads_the_bfloat16_reference():
    """A float32 cell's control is the bfloat16 reference in the program's
    place, reading for reading."""
    spec = _spec(F32_CELL)
    cfg, traffic = spec["cfg"], spec["traffic"]
    res = harness.run_cell(cfg, traffic, SEED, 0.0, False, "cpu", 0.0, keep_inputs=True)
    inp = res["inputs"]
    two_stream = traffic["solver"]["two_stream_lw"]
    low = lambda step, k, lo, hi: reference.step_fluxes(inp["tables"], inp["states"][k], inp["bcs"], two_stream, step,
                                                        lo, hi, torch.bfloat16)
    want = compare.worst(compare.step_errors(inp, cfg, traffic, res["checked"], candidate=low))
    assert compare.control(inp, cfg, traffic, res["checked"]) == want


def _budget_for(cfg: dict, columns: int) -> float:
    """The solver's f64 budget in GB under which it chunks by ``columns``."""
    per_col = cfg["nlay"] * max(cfg["lw"]["n_gpt"], cfg["sw"]["n_gpt"]) * 8 * F64_TENSOR_EQUIVALENTS
    return (columns + 0.5) * per_col / 1e9


@pytest.mark.parametrize("cell", F64_CELLS)
def test_configuration_states_the_chunks(cell, monkeypatch):
    """The configuration's budget, not the run's environment, sets the
    chunks; the environment is as it was once the solver is built."""
    spec = _spec(cell)
    cfg = spec["cfg"]
    assert cfg["chunk_budget_gb"] > 0
    inp = inputs.make_inputs(cfg, SEED, 2, "cpu")
    monkeypatch.setenv("RRTMGP_CHUNK_BUDGET_GB", repr(_budget_for(cfg, 4)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert program.solver(cfg, spec["traffic"], inp).auto_chunk is None
        assert program.solver(dict(cfg, chunk_budget_gb=_budget_for(cfg, 8)), spec["traffic"], inp).auto_chunk == 8
    assert os.environ["RRTMGP_CHUNK_BUDGET_GB"] == repr(_budget_for(cfg, 4))
    monkeypatch.delenv("RRTMGP_CHUNK_BUDGET_GB")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        program.solver(dict(cfg, chunk_budget_gb=_budget_for(cfg, 8)), spec["traffic"], inp)
    assert "RRTMGP_CHUNK_BUDGET_GB" not in os.environ


@pytest.mark.parametrize("cell", F64_CELLS)
def test_float64_window_runs_chunked_and_passes(cell, monkeypatch):
    """The cell's window with the solver's chunking forced (three chunks of
    8 columns): its fluxes are float64, within 1e-12 of the reference's
    scale, and the run comes out correct under the cell's limits."""
    spec = _spec(cell)
    cfg, traffic = spec["cfg"], spec["traffic"]
    cfg["chunk_budget_gb"] = _budget_for(cfg, 8)
    built, solver = [], program.solver
    monkeypatch.setattr(program, "solver", lambda *a: built.append(solver(*a)) or built[-1])
    kept = []
    fluxes = program.fluxes
    monkeypatch.setattr(program, "fluxes", lambda s: kept.append(fluxes(s)) or kept[-1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = harness.run_cell(cfg, traffic, SEED, 0.0, False, "cpu", 0.0)
    assert built[0].auto_chunk == 8 and cfg["ncol"] > 2 * 8
    assert all(v.dtype == torch.float64 for v in kept[-1].values())
    out, _ = run.result_line(spec, res, {}, False, {})
    assert out["correct"] is True and out["failed"] == 0, out["compared"]
    assert all(c["value"] <= 1e-12 for c in out["compared"].values()), out["compared"]


@pytest.mark.parametrize("cell", F64_CELLS)
def test_float32_run_of_the_float64_configuration_fails(cell):
    """The same configuration run in float32, the program's own path in the
    precision below, reads over the float64 cell's limits."""
    spec = _spec(cell)
    spec["cfg"]["dtype"] = "float32"
    res = harness.run_cell(spec["cfg"], spec["traffic"], SEED, 0.0, False, "cpu", 0.0)
    out, _ = run.result_line(spec, res, {}, False, {})
    assert out["correct"] is False and out["failed"] >= 1, out["compared"]


@pytest.mark.parametrize("cell", F64_CELLS)
def test_float64_work_counts_the_float64_bytes(cell):
    """The roofline's bytes are those of the f64 tensors (twice the float32
    configuration's), its operations the same."""
    spec = _spec(cell)
    f64 = work.step_work(spec["cfg"], spec["traffic"], inputs.make_inputs(spec["cfg"], SEED, 2, "cpu"))
    cfg32 = dict(spec["cfg"], dtype="float32")
    f32 = work.step_work(cfg32, spec["traffic"], inputs.make_inputs(cfg32, SEED, 2, "cpu"))
    for wave in ("lw", "sw"):
        assert f64[wave][0] == f32[wave][0] and f64[wave][1] == 2 * f32[wave][1]


def _ctx(ops: list, steps=2):
    """A reduced trace of ``ops`` ((name, start, end)) launched inside
    update_fluxes, in a window of 10,000 ns."""
    trace = tracing.Trace(window=(0, 10_000), device=[(n, s, e, "update_fluxes") for n, s, e in ops], host=[])
    return types.SimpleNamespace(trace=trace, steps=steps, work={"lw": (10**9, 10**7), "sw": (10**9, 10**7)})


def test_f64_roofline_reads_only_the_double_build():
    read = harness.load_reader("lw_clear_mega_f64_roofline")
    float_ops = [(K7.format("float", "float"), 100, 1100), (K7.format("float", "float"), 5000, 6000)]
    assert read(_ctx(float_ops)) is None
    assert read(_ctx([])) is None
    assert read(types.SimpleNamespace(trace=None)) is None
    double_ops = [(K7.format("double", "double"), 100, 2100), (K7.format("double", "double"), 5000, 7000),
                  ("void at::native::vectorized_elementwise_kernel<4>(double)", 2200, 4000)]
    least = max(10**9 / 33.5e12, 10**7 / 3.35e12)
    assert read(_ctx(double_ops + float_ops)) == pytest.approx(100.0 * least * 2 / 4000e-9)
    # and the f32 kernel's roofline reads the float ops as it did
    f32 = harness.load_reader("lw_clear_mega_roofline")
    assert f32(_ctx(float_ops)) == pytest.approx(100.0 * max(10**9 / 67e12, 10**7 / 3.35e12) * 2 / 2000e-9)


def test_no_float32_reader_lists_a_float64_cell():
    """The readers at the f32 peak (``step_mfu``) or of an f32 kernel's
    roofline list no float64 cell; the f64 roofline lists only those."""
    for m in BENCH["per_layer"]:
        listed = set(m.get("workloads", CELLS))
        if m["name"] == "lw_clear_mega_f64_roofline":
            assert listed and listed <= set(F64_CELLS)
        elif m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert not listed & set(F64_CELLS), m["name"]
