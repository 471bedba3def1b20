"""Readings for the correctness limits of one cell, in one process: the
program's widest gaps on many seeds (short windows at the cell's own size
and load), and the control's, the reference computed in the precision below
the configuration's (bfloat16 for float32, float32 for float64) in the
program's place, on the first few of them.

    python3 portbench/control.py --workload <name> --seeds 12 --control 3 --seconds 2

Prints one JSON line per seed and reading; needs a CUDA device, as
``run.py`` does. The limits in ``limits/<cell>.json`` are set between the
largest program reading and the smallest control reading. With
``--program-dtype float32`` the program runs the configuration in that
dtype instead (its own path in the precision below, kind
``program_float32``), and no control is read.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import compare, harness, run  # noqa: E402


def readings(spec: dict, seeds: list, n_control: int, seconds: float, device, program_kind: str = "program"):
    """Yield (seed, kind, numbers, details) for each seed's program reading
    and, for the first ``n_control`` seeds, the control's."""
    import torch

    control_kind = "control_" + str(compare.control_dtype(spec["cfg"])).removeprefix("torch.")
    for i, seed in enumerate(seeds):
        res = harness.run_cell(spec["cfg"], spec["traffic"], seed, seconds, False, device, time.perf_counter(),
                               keep_inputs=i < n_control)
        yield seed, program_kind, compare.worst(res["per_step"]), dict(
            steps=res["ctx"].steps, checked=res["checked_steps"], per_step=res["per_step"],
            check_s=round(res["check_s"], 2), check_peak_gb=res["check_peak"] / 1e9)
        if i < n_control:
            t = time.perf_counter()
            numbers = compare.control(res["inputs"], spec["cfg"], spec["traffic"], res["checked"])
            yield seed, control_kind, numbers, dict(check_s=round(time.perf_counter() - t, 2))
        del res
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first", type=int, default=2_654_435_761)
    ap.add_argument("--program-dtype", choices=("float32",), default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 3
    spec = run.cell_spec(run.load_json(run.ROOT, "BENCHMARK.json"), args.workload)
    seeds = [args.first + 104_729 * i for i in range(args.seeds)]
    kind, n_control = "program", args.control
    if args.program_dtype:
        spec["cfg"]["dtype"], kind, n_control = args.program_dtype, f"program_{args.program_dtype}", 0
    for seed, what, numbers, details in readings(spec, seeds, n_control, args.seconds, "cuda", kind):
        print(json.dumps(dict(workload=args.workload, seed=seed, kind=what, numbers=numbers, **details)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
