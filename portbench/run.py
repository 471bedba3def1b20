"""Run one cell of the benchmark of ``rrtmgp_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, metrics and correctness limits are
found by name: ``BENCHMARK.json`` at the root of the checkout,
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``,
``portbench/metrics/<metric>.py`` and ``portbench/limits/<cell>.json``.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profiler trace of the
window. The last line of standard output is the result as one JSON
object; the numbers compared with the reference end standard error.
Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run (the JAX package
#: and JAX itself), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "rrtmgp_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration, traffic and limits, and the
    names and units of the metrics it reports in each kind of run."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mine = lambda metrics: {m["name"]: m["unit"] for m in metrics if workload in m.get("workloads", [workload])}
    return dict(
        cell=cell,
        cfg=load_json(ROOT, config["file"]),
        traffic=load_json(HERE, "traffic", f"{cell['traffic']}.json"),
        limits=load_json(HERE, "limits", f"{workload}.json"),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]),
    )


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(spec: dict, res: dict, metrics: dict, trace: bool, device: dict) -> tuple:
    """The result object and the lines of compared numbers."""
    limits = spec["limits"]
    worst = {name: max(s[name] for s in res["per_step"]) for name in limits}
    failed = sum(any(s[n] > limits[n]["limit"] for n in limits) for s in res["per_step"])
    # a NaN or an infinity in the fluxes reads infinity: kept as text, so the line stays JSON
    number = lambda v: v if math.isfinite(v) else str(v)
    compared = {name: {"value": number(worst[name]), "limit": limits[name]["limit"]} for name in limits}
    units = spec["per_layer"] if trace else spec["end_to_end"]
    out = dict(correct=failed == 0, attempted=res["ctx"].steps, failed=failed,
               metrics={n: {"value": v, "unit": units[n]} for n, v in metrics.items()}, device=device)
    if trace:
        out["breakdown"] = res["ctx"].trace.breakdown()
    out["compared"] = compared
    lines = [f"compared {n}: {c['value']!r} limit {c['limit']!r} (steps {res['checked_steps']}, "
             f"reference {res['check_s']:.1f} s)" for n, c in compared.items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = cell_spec(load_json(ROOT, "BENCHMARK.json"), args.workload)
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s), this machine has {n}; no result",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    from portbench import harness

    trace = bool(args.trace)
    res = harness.run_cell(spec["cfg"], spec["traffic"], args.seed, args.seconds, trace, "cuda", T0)
    ctx = res["ctx"]
    metrics = harness.read_metrics(ctx, list(spec["per_layer"] if trace else spec["end_to_end"]))
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                  memory_peak_bytes=ctx.peak_bytes)
    if trace:
        # the seconds an op ran, averaged over the cell's cards
        busy_ns = ctx.trace.busy_ns() if chips == 1 else sum(ctx.trace.card_busy_ns().values()) / chips
        device.update(busy_s=busy_ns / 1e9, window_s=ctx.trace.window_ns / 1e9)
    out, lines = result_line(spec, res, metrics, trace, device)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded in the run that may not be: {found}; no result", file=sys.stderr)
        return 4
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
