"""The traced window: the harness's own spans around the calls into each
layer, and the reduction of the profiler's events to what the per-layer
readers take (device intervals with the host span that launched each,
host events for naming idle gaps) and to the result's ``breakdown``.

Spans are ``torch.profiler.record_function`` ranges named ``portbench.*``,
so that they sit on the profiler's own clock beside the device events.
Nothing is written to disk: the events are reduced in memory.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os

import torch

PREFIX = "portbench."
#: the harness's spans inside a step, in the order a step enters them
STEP_SPANS = ("copy_in", "advance_step", "update_fluxes")
WINDOW = "window"
_HERE = os.path.dirname(os.path.abspath(__file__))


def port_kernels() -> frozenset:
    """The port's own kernel names, frozen in ``kernels.json``."""
    with open(os.path.join(_HERE, "kernels.json")) as f:
        return frozenset(json.load(f)["kernels"])


def short_name(name: str) -> str:
    """A device op's name without its argument list and return type: a
    template kernel ``void k<float, 2>(...)`` becomes ``k<float, 2>``."""
    head = name.split("(", 1)[0].strip()
    return head[5:] if head.startswith("void ") else head


def base_name(name: str) -> str:
    """A kernel's identifier without namespace and template arguments
    (``rrtmgp::lw2_mega_kernel<true, 2>`` is ``lw2_mega_kernel``)."""
    return short_name(name).split("<", 1)[0].strip().rsplit("::", 1)[-1]


class Spans:
    """``spans(name)``: a ``record_function`` range when tracing, else a
    context that does nothing."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class Trace:
    """A traced window reduced: ``device`` holds (name, start, end, span)
    of every device op, ``span`` the harness span in which the host launched
    it (None where the launch is not linked); ``host`` holds (start, end,
    name) of every host event, sorted by start; ``cards`` the card (CUDA
    device index) of each op of ``device``, in its order (empty: all on
    one); ``launches`` the start of the runtime call that launched each op
    of ``device``, in its order, found by correlation id (None where the
    trace holds no such call); times in ns on the profiler's clock."""

    window: tuple
    device: list
    host: list
    cards: list = dataclasses.field(default_factory=list)
    launches: list = dataclasses.field(default_factory=list)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def in_window(self):
        w0, w1 = self.window
        return [(n, max(s, w0), min(e, w1), sp) for n, s, e, sp in self.device if e > w0 and s < w1]

    def busy_ns(self) -> int:
        """Nanoseconds of the window in which some device op runs."""
        return sum(e - s for s, e in self._merged())

    def _merged(self):
        return _union((s, e) for _, s, e, _ in self.in_window())

    def card_busy_ns(self) -> dict:
        """{card: nanoseconds of the window in which some op runs on it},
        for each card that ran an op in the window."""
        w0, w1 = self.window
        by_card = {}
        for (_, s, e, _), card in zip(self.device, self.cards or [0] * len(self.device)):
            if e > w0 and s < w1:
                by_card.setdefault(card, []).append((max(s, w0), min(e, w1)))
        return {card: sum(e - s for s, e in _union(spans)) for card, spans in by_card.items()}

    def gaps(self):
        """(start, end) of the window's idle stretches, longest first."""
        w0, w1 = self.window
        edges = [w0] + [x for se in self._merged() for x in se] + [w1]
        pairs = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)]
        return sorted([p for p in pairs if p[1] > p[0]], key=lambda p: p[0] - p[1])

    def host_at(self, t: int) -> str:
        """The innermost host event running at ``t`` (latest start)."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        for s, e, name in reversed(self.host[max(0, i - 5000):i]):
            if e >= t:
                return name
        return "host idle"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the longest idle gaps,
        named by what the host was doing when each began."""
        by_op = {}
        for n, s, e, _ in self.in_window():
            by_op[short_name(n)] = by_op.get(short_name(n), 0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = self.gaps()[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[self.host_at(s), (e - s) / 1e9] for s, e in gaps]}


def _union(intervals) -> list:
    """[start, end] of the union of (start, end) intervals, in time order."""
    out = []
    for s, e in sorted(intervals, key=lambda p: p[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def from_profiler(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` of the window: the
    ``portbench.window`` span bounds it, each device op is linked through
    its correlation id to the runtime call that launched it, and that call
    to the harness span it fell in."""
    from torch.autograd import DeviceType

    device, host, runtime, spans = [], [], {}, []
    window = None
    for ev in prof.profiler.kineto_results.events():
        name, start = ev.name(), ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            if name.startswith(PREFIX):
                continue  # a record_function range mirrored on the device timeline, not an op
            device.append((name, start, end, ev.correlation_id(), ev.linked_correlation_id(), ev.device_index()))
            continue
        host.append((start, end, name))
        if name.startswith(PREFIX):
            key = name[len(PREFIX):]
            if key == WINDOW:
                window = (start, end)
            elif key in STEP_SPANS:
                spans.append((start, end, key))
        elif name.startswith("cu"):
            runtime[ev.correlation_id()] = start
    if window is None:
        raise RuntimeError("the trace holds no portbench.window span")
    spans.sort()
    starts = [s for s, _, _ in spans]

    def span_at(t):
        if t is None:
            return None
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][2] if i >= 0 and spans[i][1] >= t else None

    launches = [runtime.get(c, runtime.get(lc)) for _, _, _, c, lc, _ in device]
    linked = [(n, s, e, span_at(t)) for (n, s, e, *_), t in zip(device, launches)]
    host.sort()
    return Trace(window=window, device=linked, host=host, cards=[d[-1] for d in device], launches=launches)


#: the harness spans inside which the host calls into the program
PROGRAM_SPANS = ("advance_step", "update_fluxes")


def kernel_ns(trace: Trace, base: str) -> int:
    """Device nanoseconds of the window in the kernel named ``base``."""
    return sum(e - s for n, s, e, _ in trace.in_window() if base_name(n) == base)


def plain_ops(trace: Trace, kernels: frozenset) -> list:
    """The window's device ops that the program launched (from inside its
    calls) and that are not among its own ``kernels``."""
    return [d for d in trace.in_window() if d[3] in PROGRAM_SPANS and base_name(d[0]) not in kernels]
