"""The reduction of a traced window that holds the program's ``rrtmgp.*``
spans, on a synthetic event stream shaped like kineto's: the spans are host
ranges with no copy on the device timeline, every reader the benchmark had
reads the same with and without them, each device op is linked by its
correlation id to the runtime call that launched it, and the readers of the
spans put a nested op down to its innermost span.
"""

import json
import os
import types

import pytest
from torch.autograd import DeviceType

from portbench import harness, program_spans, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ("prologue_ms", "cloud_optics_ms", "aerosol_optics_ms", "host_self_ms", "host_syncs")
#: readers of a float64 build alone, which the stream's float kernels are not
#: (``test_portbench_precision.py`` reads them on a double build)
F64 = ("lw_clear_mega_f64_roofline",)
OLD = [m["name"] for m in BENCH["per_layer"] if m["name"] not in NEW + F64]


class Event:
    """The methods of a kineto event that the reduction calls."""

    def __init__(self, name, start, dur, cuda=False, corr=0, annotation=False):
        self._v = (name, start, dur, cuda, corr, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return 0

    def device_index(self):
        return 0

    def is_user_annotation(self):
        return self._v[5]


def _range(name, start, end, mirror=True):
    """A ``record_function`` range of the harness on the host, and its
    mirror on the device timeline (kineto draws one where the range
    launched device work)."""
    out = [Event(name, start, end - start, annotation=True)]
    if mirror:
        out.append(Event(name, start + 5, end - start, cuda=True, annotation=True))
    return out


def _span(name, start, end):
    """A span of the program: a function-scope range, on the host only."""
    return [Event(name, start, end - start)]


def _op(name, launch, start, dur, corr, call="cudaLaunchKernel", call_dur=4):
    """A device op and the runtime call that launched it."""
    return [Event(call, launch, call_dur, corr=corr), Event(name, start, dur, cuda=True, corr=corr)]


def _stream(program: bool, steps: int = 2) -> list:
    """Two steps of a window: the harness's spans, a copy-in op, and in
    each step's update_fluxes an LW prologue op, a cloud gather, a
    synchronisation with a device-to-host copy, the LW megakernels, an op
    of the SW solve's own and the SW megakernel; with ``program`` the
    program's spans around them. Times in ns; each step 1000 ns apart."""
    ev = _range("portbench.window", 0, 1000 * steps + 100)
    for k in range(steps):
        t, c = 1000 * k + 10, 100 * k
        ev += _range("portbench.copy_in", t, t + 40)
        ev += _op("Memcpy DtoD (Device -> Device)", t + 10, t + 50, 20, c + 1, call="cudaMemcpyAsync")
        ev += _range("portbench.advance_step", t + 50, t + 60, mirror=False)
        ev += _range("portbench.update_fluxes", t + 60, t + 900)
        ev += _op("void at::native::index_elementwise_kernel<128, 4>(...)", t + 100, t + 120, 30, c + 2)
        ev += _op("void at::native::gather_kernel(...)", t + 200, t + 220, 40, c + 3)
        ev += [Event("cudaStreamSynchronize", t + 300, 50)]
        ev += _op("Memcpy DtoH (Device -> Pageable)", t + 290, t + 305, 2, c + 4, call="cudaMemcpyAsync")
        ev += _op("void rrtmgp::lw2_mega_kernel<true, 2>(float const*)", t + 400, t + 410, 150, c + 5)
        ev += _op("void rrtmgp::lw_clear_mega_kernel<1>(float const*)", t + 430, t + 560, 150, c + 7)
        ev += _op("void at::native::vectorized_elementwise_kernel<4>(...)", t + 770, t + 770, 10, c + 6)
        ev += _op("void rrtmgp::sw_clear_mega_kernel<2>(float const*)", t + 790, t + 790, 80, c + 8)
        if program:
            ev += _span("rrtmgp.update_lw_fluxes", t + 70, t + 700)
            ev += _span("rrtmgp.lw", t + 80, t + 690)
            ev += _span("rrtmgp.lw.inputs", t + 90, t + 150)
            ev += _span("rrtmgp.lw.clouds", t + 180, t + 380)
            ev += _span("rrtmgp.lw.solve", t + 390, t + 450)
            ev += _span("rrtmgp.update_sw_fluxes", t + 750, t + 890)
            ev += _span("rrtmgp.sw", t + 760, t + 880)
    return sorted(ev, key=lambda e: e.start_ns())


def _reduce(events):
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return tracing.from_profiler(prof)


def _ctx(trace, steps=2):
    kernels = frozenset({"lw2_mega_kernel", "lw_clear_mega_kernel", "sw_clear_mega_kernel"})
    return types.SimpleNamespace(trace=trace, steps=steps, enqueue_s=[1e-6, 2e-6], kernels=kernels,
                                 work={"lw": (10**9, 10**6), "sw": (10**9, 10**6)})


def test_program_spans_are_no_device_ops():
    """The program's spans add host events and nothing to the device ops."""
    without, with_ = _reduce(_stream(False)), _reduce(_stream(True))
    names = [d[0] for d in with_.device]
    assert len(names) == 16 and not [n for n in names if n.startswith(("portbench.", "rrtmgp."))]
    assert with_.device == without.device
    assert [n for _, _, n in program_spans.spans(with_)] == [
        "rrtmgp.update_lw_fluxes", "rrtmgp.lw", "rrtmgp.lw.inputs", "rrtmgp.lw.clouds", "rrtmgp.lw.solve",
        "rrtmgp.update_sw_fluxes", "rrtmgp.sw"] * 2
    assert program_spans.spans(without) == []


def test_launches_pair_each_op_with_its_call():
    """Each op is paired with the runtime call that launched it (the same
    correlation id in the stream)."""
    events = _stream(True)
    trace = _reduce(events)
    call = {e.correlation_id(): e.start_ns() for e in events
            if e.device_type() == DeviceType.CPU and e.name().startswith("cu") and e.correlation_id()}
    ops = [e.correlation_id() for e in events if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    assert program_spans.launches(trace) == [call[c] for c in ops]


def test_a_call_inside_a_launch_is_not_a_launch_of_its_own():
    """The driver's launch made inside the runtime's is the same launch."""
    events = _stream(True)
    inner = [Event("cuLaunchKernel", e.start_ns() + 1, 2) for e in events if e.name() == "cudaLaunchKernel"]
    trace = _reduce(sorted(events + inner, key=lambda e: e.start_ns()))
    assert program_spans.launches(trace) == program_spans.launches(_reduce(events))


@pytest.mark.parametrize("fault", ["lost_op", "extra_call", "swapped"])
def test_readers_link_each_op_by_its_correlation_id(fault):
    """An op missing from the trace, a launch with no op, or an op that
    starts after an op launched later (where the k-th launch is not the
    k-th op) leave every other op put down to its own span: the readers
    of device time by span read what they read on the whole stream, less
    the lost op."""
    readers = ("prologue_ms", "cloud_optics_ms", "host_syncs", "host_self_ms")
    whole = {n: harness.load_reader(n)(_ctx(_reduce(_stream(True)))) for n in readers}
    events = _stream(True)
    if fault == "lost_op":
        events = [e for e in events if e.name() != "void at::native::gather_kernel(...)" or e.start_ns() > 1000]
    elif fault == "extra_call":
        events = sorted(events + [Event("cudaMemsetAsync", 25, 2)], key=lambda e: e.start_ns())
    else:
        # the copy-in's op starts after the first op of update_fluxes
        events = [Event(e.name(), 135, 20, cuda=True, corr=1) if e.name().startswith("Memcpy DtoD") and
                  e.start_ns() < 1000 else e for e in events]
        events.sort(key=lambda e: e.start_ns())
    ctx = _ctx(_reduce(events))
    assert program_spans.launches(ctx.trace) is not None
    want = dict(whole)
    if fault == "lost_op":
        # the first step's 40-ns cloud gather, over two steps
        want["cloud_optics_ms"] = whole["cloud_optics_ms"] - 40e-6 / 2
    for n in readers:
        assert harness.load_reader(n)(ctx) == pytest.approx(want[n]), n


@pytest.mark.parametrize("name", OLD)
def test_every_earlier_reader_reads_the_same_with_program_spans(name):
    """The benchmark's earlier readers, and the breakdown's device ops, do
    not move when the program adds its spans to the stream."""
    without, with_ = _reduce(_stream(False)), _reduce(_stream(True))
    read = harness.load_reader(name)
    assert read(_ctx(with_)) == read(_ctx(without)) is not None
    assert with_.breakdown()["device_ops"] == without.breakdown()["device_ops"]


def test_idle_gaps_are_named_by_the_innermost_program_span():
    """A gap that begins while the host is inside the program is named by
    the program's innermost span, where the harness's span named it
    before; a gap between the program's calls keeps the harness's name."""
    before, after = _reduce(_stream(False)), _reduce(_stream(True))
    assert before.gaps() == after.gaps()
    inside = lambda t: any(s <= t <= e for s, e, _ in program_spans.spans(after))
    names = [(inside(s), before.host_at(s), after.host_at(s)) for s, _ in after.gaps()]
    renamed = {a for i, b, a in names if i and b == "portbench.update_fluxes"}
    assert renamed == {"rrtmgp.update_lw_fluxes", "rrtmgp.lw.inputs", "rrtmgp.lw.clouds", "rrtmgp.sw"}
    # a gap that begins in a runtime call, or outside the program, keeps its name
    assert all(b == a for i, b, a in names if not (i and b == "portbench.update_fluxes"))


def test_program_ops_take_the_innermost_span():
    ops = program_spans.program_ops(_reduce(_stream(True)))
    where = {op[0].split("(")[0]: op[4] for op in ops}
    assert where == {"Memcpy DtoD ": None, "void at::native::index_elementwise_kernel<128, 4>": "rrtmgp.lw.inputs",
                     "void at::native::gather_kernel": "rrtmgp.lw.clouds", "Memcpy DtoH ": "rrtmgp.lw.clouds",
                     "void rrtmgp::lw2_mega_kernel<true, 2>": "rrtmgp.lw.solve",
                     "void rrtmgp::lw_clear_mega_kernel<1>": "rrtmgp.lw.solve",
                     "void at::native::vectorized_elementwise_kernel<4>": "rrtmgp.sw",
                     "void rrtmgp::sw_clear_mega_kernel<2>": "rrtmgp.sw"}


def test_innermost_over_nested_and_disjoint_spans():
    spans = [(0, 100, "a"), (10, 50, "a.b"), (20, 30, "a.b.c"), (60, 70, "a.d"), (200, 300, "e")]
    times = [5, 25, 30, 40, 55, 65, 150, 250, None, -1]
    assert program_spans.innermost(spans, times) == ["a", "a.b.c", "a.b.c", "a.b", "a", "a.d", None, "e", None, None]


def test_new_readers_attribute_each_op_to_its_span():
    ctx = _ctx(_reduce(_stream(True)))
    read = {name: harness.load_reader(name)(ctx) for name in NEW}
    # per step: the prologue op 30 ns; the cloud gather 40 ns and the copy 2 ns
    assert read["prologue_ms"] == pytest.approx(30e-6)
    assert read["cloud_optics_ms"] == pytest.approx(42e-6)
    assert "aerosol_optics_ms" not in read or read["aerosol_optics_ms"] is None
    # one cudaStreamSynchronize and one Memcpy DtoH inside the program a step
    assert read["host_syncs"] == 2.0
    # the API spans 630 + 140 ns, less the runtime calls in them: 4 + 4 + 54 (the copy's call
    # at t + 290 overlaps the synchronisation, counted once) + 4 + 4 in LW, 4 + 4 in SW
    assert read["host_self_ms"] == pytest.approx((630 + 140 - (4 + 4 + 54 + 4 + 4 + 4 + 4)) / 1e6)


def test_new_readers_read_nothing_without_program_spans():
    """On a program without spans (the benchmark's earlier program) the new
    readers leave their metrics out of the line; with spans and no
    synchronisation, host_syncs reads 0."""
    ctx = _ctx(_reduce(_stream(False)))
    assert all(harness.load_reader(name)(ctx) is None for name in NEW)
    copies = {e.correlation_id() for e in _stream(True) if e.name().startswith("Memcpy DtoH")}
    calm = [e for e in _stream(True) if e.name() != "cudaStreamSynchronize" and e.correlation_id() not in copies]
    assert harness.load_reader("host_syncs")(_ctx(_reduce(calm))) == 0.0
