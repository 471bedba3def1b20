"""The program's spans (``utils.profiling.span``): the ranges an
``RRTMGPSolver`` step records under ``torch.profiler``, nested as the
module docstring of ``utils/profiling.py`` draws them, on the host only;
nothing recorded and no profiler range entered without a profiler; fluxes
bitwise the same with and without one.

On the CPU the torch route records the API and solve spans only; the
megakernel route's children are rehearsed with ``_resolve_impl`` returning
``"kernel"`` (the wrappers then run their plain twins), each kernel wrapper
wrapped in a probe range of its own so that the span it is called in shows.
The ``gpu`` case checks the same on the card from the kernels' device
events, linked to the host spans by correlation id.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import rrtmgp_tpu_torch as rt
from rrtmgp_tpu_torch.data.synthetic import synthetic_atmosphere
from rrtmgp_tpu_torch.models import rrtmgp as tmod
from rrtmgp_tpu_torch.utils import profiling

NCOL, NLAY = 8, 8
LW_KERNEL = ["rrtmgp.lw.inputs", "rrtmgp.lw.clouds", "rrtmgp.lw.aerosols", "rrtmgp.lw.planck", "rrtmgp.lw.solve"]
SW_KERNEL = ["rrtmgp.sw.clouds", "rrtmgp.sw.aerosols", "rrtmgp.sw.inputs", "rrtmgp.sw.solve"]
#: the wrappers the kernel route calls, and the span each must be called in
WRAPPERS = {"mega_lw_inputs": ["rrtmgp.lw.inputs"], "mega_sw_inputs": ["rrtmgp.sw.inputs"],
            "aerosol_bands": ["rrtmgp.lw.aerosols", "rrtmgp.sw.aerosols"],
            "cloud_bands": ["rrtmgp.lw.clouds", "rrtmgp.sw.clouds"], "planck_band_sets": ["rrtmgp.lw.planck"], "sw_clear_mega": ["rrtmgp.sw.solve"]}


def _solver(device="cpu", **kw):
    """An all-sky solver with aerosols in the lower layers (the synthetic
    ones sit below 800 hPa, which 8 layers miss) and a night column."""
    atm = synthetic_atmosphere(ncol=NCOL, nlay=NLAY, dtype=np.float32, with_clouds=True, with_aerosols=True,
                               device=device)
    rng = np.random.default_rng(3)
    mass = rng.uniform(0.0, 2e-5, (15, NLAY, NCOL)).astype(np.float32)
    mass[:, NLAY // 2:] = 0.0
    atm.aerosol_state.aero_mass.copy_(torch.from_numpy(mass))
    full = lambda shape, v: torch.full(shape, v, device=device)
    mu0 = full((NCOL,), 0.6)
    mu0[0] = -0.1
    return rt.RRTMGPSolver(
        rt.RRTMGPGridParams(nlay=NLAY, ncol=NCOL), rt.AllSkyRadiation(aerosol_radiation=True),
        rt.RRTMGPParameters(), rt.LwBCs(sfc_emis=full((16, NCOL), 0.98)),
        rt.SwBCs(cos_zenith=mu0, toa_flux=full((NCOL,), 1361.0), sfc_alb_direct=full((14, NCOL), 0.2),
                 sfc_alb_diffuse=full((14, NCOL), 0.2)),
        atm, **kw)


def _fluxes(s) -> list:
    return [f.clone() for f in (*s.flux_lw, *s.flux_sw, s.diag_lw.cld_cover, s.diag_sw.cld_cover,
                                s.diag_sw.aod_sw_ext)]


def _host_ranges(prof, prefix=("rrtmgp.", "probe.")) -> list:
    """(start, end, name) of the named host ranges, outer first."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU and e.name().startswith(prefix)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _tree(ranges) -> list:
    """(depth, name) of nested ranges in the order they open."""
    out, stack = [], []
    for s, e, name in ranges:
        while stack and stack[-1] < s:
            stack.pop()
        out.append((len(stack), name))
        stack.append(e)
    return out


def _parent(ranges, name) -> list:
    """The innermost program span around each range named ``name``."""
    return [max((r for r in ranges if r[0] <= s and e <= r[1] and r[2].startswith("rrtmgp.")),
                key=lambda r: r[0])[2] for s, e, n in ranges if n == name]


@pytest.fixture
def kernel_route(monkeypatch):
    """The megakernel route on CPU tensors, each wrapper inside a probe
    range named after it."""
    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "kernel")
    for name in [*WRAPPERS, "lw2_mega", "lw_clear_mega"]:
        real = getattr(tmod, name)

        def probed(*args, _real=real, _name=name, **kwargs):
            with record_function("probe." + _name):
                return _real(*args, **kwargs)
        monkeypatch.setattr(tmod, name, probed)


def _step_under_profiler(s, step=4):
    s.advance_step(step)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.update_fluxes()
    return prof


def test_torch_route_records_api_and_solve_spans():
    """update_lw_fluxes holds solve_lw, then update_sw_fluxes holds
    solve_sw; the torch route opens no child span."""
    ranges = _host_ranges(_step_under_profiler(_solver(impl="torch")))
    assert _tree(ranges) == [(0, "rrtmgp.update_lw_fluxes"), (1, "rrtmgp.lw"),
                             (0, "rrtmgp.update_sw_fluxes"), (1, "rrtmgp.sw")]


@pytest.mark.parametrize("two_stream_lw", [True, False])
def test_kernel_route_records_each_part(kernel_route, two_stream_lw):
    """On the megakernel route each solve holds its parts in the order it
    runs them, and each kernel wrapper runs inside its part's span:
    lw2_mega or every angle of lw_clear_mega in ``rrtmgp.lw.solve``, the
    aerosol kernel in each wave's ``aerosols``."""
    s = _solver(two_stream_lw=two_stream_lw, n_gauss_angles=1 if two_stream_lw else 2)
    ranges = _host_ranges(_step_under_profiler(s))
    spans = [(d, n) for d, n in _tree(ranges) if n.startswith("rrtmgp.")]
    assert spans == [(0, "rrtmgp.update_lw_fluxes"), (1, "rrtmgp.lw"), *[(2, n) for n in LW_KERNEL],
                     (0, "rrtmgp.update_sw_fluxes"), (1, "rrtmgp.sw"), *[(2, n) for n in SW_KERNEL]]
    for name, where in WRAPPERS.items():
        assert _parent(ranges, "probe." + name) == where, name
    mega = "lw2_mega" if two_stream_lw else "lw_clear_mega"
    assert _parent(ranges, "probe." + mega) == ["rrtmgp.lw.solve"] * (1 if two_stream_lw else 2)


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    """Without a profiler ``span`` hands back one shared inert context, and
    a whole step on the kernel route creates no profiler range."""
    monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "kernel")
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", lambda name: made.append(name))
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("rrtmgp.lw") is profiling.span("rrtmgp.sw")
    with profiling.span("rrtmgp.lw"):
        pass
    s = _solver()
    s.update_fluxes()
    assert made == []


def test_spans_are_host_ranges_not_user_annotations():
    """The spans record as function-scope ranges: a user annotation (a
    ``record_function`` range) would also be copied onto the device
    timeline, among the device's operations."""
    ranges = [e for e in _step_under_profiler(_solver(impl="torch")).profiler.kineto_results.events()
              if e.name().startswith("rrtmgp.")]
    assert len(ranges) == 4
    assert not [e.name() for e in ranges if e.is_user_annotation() or e.device_type() != DeviceType.CPU]


@pytest.mark.parametrize("route", ["torch", "kernel"])
def test_fluxes_bitwise_with_and_without_profiler(monkeypatch, route):
    """The same step with and without a profiler gives the same bits."""
    if route == "kernel":
        monkeypatch.setattr(tmod, "_resolve_impl", lambda *args, **kwargs: "kernel")
    s = _solver(impl="torch" if route == "torch" else None)
    s.advance_step(4)
    s.update_fluxes()
    plain = _fluxes(s)
    _step_under_profiler(s, 4)
    for a, b in zip(plain, _fluxes(s)):
        assert torch.equal(a, b)


def _device_spans(prof) -> list:
    """(kernel name, innermost program span at its launch) of each device
    op of the profile."""
    runtime, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels.append((e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime[e.correlation_id()] = e.start_ns()
    ranges = _host_ranges(prof, ("rrtmgp.",))

    def inner(t):
        if t is None:
            return None
        return max((r for r in ranges if r[0] <= t <= r[1]), key=lambda r: r[0], default=(0, 0, None))[2]
    return [(name, inner(runtime.get(c))) for name, c in kernels]


@pytest.mark.gpu
@pytest.mark.parametrize("two_stream_lw", [True, False])
def test_card_kernels_launch_inside_their_spans(two_stream_lw):
    """On the card each megakernel launches inside its wave's ``solve``,
    the aerosol kernel inside each wave's ``aerosols``, the cloud kernel
    inside each wave's ``clouds``, the Planck kernel
    inside ``rrtmgp.lw.planck``; every device op inside a solve span, and
    no span copied onto the device timeline; the fluxes bitwise those of
    the step without a profiler."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU build")
    s = _solver("cuda", two_stream_lw=two_stream_lw)
    s.advance_step(4)
    s.update_fluxes()
    plain = _fluxes(s)
    s.advance_step(4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.update_fluxes()
        torch.cuda.synchronize()
    for a, b in zip(plain, _fluxes(s)):
        assert torch.equal(a, b)
    ops = _device_spans(prof)
    assert not [n for n, _ in ops if n.startswith("rrtmgp.")]
    where = lambda base: sorted(sp for n, sp in ops if base in n)
    lw = "lw2_mega_kernel" if two_stream_lw else "lw_clear_mega_kernel"
    assert where(lw) == ["rrtmgp.lw.solve"]
    assert where("sw_clear_mega_kernel") == ["rrtmgp.sw.solve"]
    assert where("aerosol_bands_kernel") == ["rrtmgp.lw.aerosols", "rrtmgp.sw.aerosols"]
    assert where("cloud_bands_kernel") == ["rrtmgp.lw.clouds", "rrtmgp.sw.clouds"]
    assert where("planck_band_kernel") == ["rrtmgp.lw.planck"]
    assert not [n for n, sp in ops if not (sp or "").startswith(("rrtmgp.lw", "rrtmgp.sw"))]
