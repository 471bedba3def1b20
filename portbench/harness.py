"""One run of one cell: set-up, warm-up, the measured window, the trace,
the check against the reference, and the metrics their readers take.

The window is a closed loop of back-to-back radiation steps with no host
synchronisation inside it. A step copies one of the cell's seeded states
into the solver's own state tensors in place (as a host model writes its
columns before each call), sets the McICA step and calls
``update_fluxes()``; a CUDA event is recorded after it. One
synchronisation closes the window.

On a mesh (a configuration with ``mesh``) one process drives every card
of the cell: each card holds its own columns of the two states, the step's
time is that of the card that took longest over it, the window closes when
every card is done, and the peak is the fullest card's. The whole inputs
are off the cards during the window and are made again from the seed for
the check.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import os
import time
import types

import torch

from . import compare, inputs, program, tracing, work

_HERE = os.path.dirname(os.path.abspath(__file__))


class Marks:
    """Step boundaries: a CUDA event on each card, recorded on its current
    stream after the step's work there; the host clock elsewhere (the CPU
    runs of the tests, which report no device metric)."""

    def __init__(self, devices):
        self.devices = devices
        self.cuda = torch.device(devices[0]).type == "cuda"
        self.marks = []

    def record(self):
        if self.cuda:
            events = []
            for d in self.devices:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(d))
                events.append(ev)
            self.marks.append(events)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        """Each step's time: on several cards, the longest any card took
        from its mark before the step to its mark after it."""
        m = self.marks
        if self.cuda:
            return [max(a.elapsed_time(b) for a, b in zip(x, y)) for x, y in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _cards(devices) -> list:
    return [d for d in devices if torch.device(d).type == "cuda"]


def sync(devices):
    """Wait for every card of ``devices``."""
    for d in _cards(devices):
        torch.cuda.synchronize(d)


def reset_peaks(devices):
    for d in _cards(devices):
        torch.cuda.reset_peak_memory_stats(d)


def peak_bytes(devices) -> int:
    """The fullest card's peak allocated memory since its reset; 0 off the
    card."""
    return max((torch.cuda.max_memory_allocated(d) for d in _cards(devices)), default=0)


def load_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, its ``read``."""
    path = os.path.join(_HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, t0: float,
             keep_inputs: bool = False) -> dict:
    """Run the cell once. Returns the window's readings (``ctx``, what the
    metric readers take), the compared numbers and, with ``keep_inputs``,
    the inputs and the checked steps (for the control)."""
    cards = program.devices(cfg, device)
    mesh = len(cards) > 1
    inp = inputs.make_inputs(cfg, seed, traffic["states"], device)
    solver = program.solver(cfg, traffic, inp)
    pairs = [program.copy_pairs(solver.as_, st) for st in inp["states"]]
    if mesh:
        # each card keeps only its own columns of the states, the copy-in's
        # sources, as a host model holds its own; the whole inputs are made
        # again from the seed for the check
        del inp
    spans = tracing.Spans(trace)
    enqueue_s = []

    def step(g):
        with spans("copy_in"):
            for dst, src in pairs[g % len(pairs)]:
                dst.copy_(src)
        t = time.perf_counter()
        with spans("advance_step"):
            solver.advance_step(g)
        with spans("update_fluxes"):
            solver.update_fluxes()
        enqueue_s.append(time.perf_counter() - t)

    warm = traffic["warmup_steps"]
    for g in range(warm):
        step(g)
    sync(cards)
    cuda = torch.device(device).type == "cuda"
    reset_peaks(cards)
    setup_s = time.perf_counter() - t0
    enqueue_s.clear()

    # the checked steps: one of the first four, drawn from the seed, and
    # one of the last two, of the other state
    early = int(seed) % 4
    kept, recent = {}, collections.deque(maxlen=2)
    marks = Marks(cards)
    prof = None
    if trace:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CPU, act.CUDA] if cuda else [act.CPU])
        prof.__enter__()
    with spans(tracing.WINDOW):
        w0 = time.perf_counter()
        marks.record()
        i = 0
        while i < early + 2 or time.perf_counter() - w0 < seconds:
            step(warm + i)
            marks.record()
            out = program.fluxes(solver)
            if i == early:
                kept[i] = out
            recent.append((i, out))
            i += 1
        sync(cards)
        window_s = time.perf_counter() - w0
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = peak_bytes(cards)
    reset_peaks(cards)  # from here on, the reference's peak
    for j, out in recent:
        if (j - early) % len(pairs):
            kept[j] = out
    checked = [(warm + j, (warm + j) % len(pairs), program.gather(out)) for j, out in sorted(kept.items())]
    step_trace = tracing.from_profiler(prof) if prof is not None else None
    del prof, solver, pairs, recent, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if mesh:
        inp = inputs.make_inputs(cfg, seed, traffic["states"], device)

    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, ncol=cfg["ncol"], steps=i, window_s=window_s, step_ms=marks.step_ms(),
        setup_s=setup_s, peak_bytes=peak, enqueue_s=list(enqueue_s), work=work.step_work(cfg, traffic, inp),
        trace=step_trace, kernels=tracing.port_kernels(),
    )
    t = time.perf_counter()
    per_step = compare.step_errors(inp, cfg, traffic, checked)
    result = dict(ctx=ctx, per_step=per_step, checked_steps=[s for s, _, _ in checked],
                  check_s=time.perf_counter() - t, check_peak=peak_bytes(cards))
    if keep_inputs:
        result.update(inputs=inp, checked=checked)
    return result


def read_metrics(ctx, names: list) -> dict:
    """{name: value} of the metrics whose readers find something to read."""
    out = {}
    for name in names:
        value = load_reader(name)(ctx)
        if value is not None:
            out[name] = value
    return out
