"""High-level solver API (counterpart of ``rrtmgp_tpu/api.py``).

``RRTMGPGridParams`` and the radiation-method dataclasses, ``LookupBundle``
and ``lookup_tables`` (rrtmgp-data files or synthetic tables), the
canonical aerosol and gas name lists, ``domain_view``, and
``RRTMGPSolver``: a host-side bundle that owns the atmospheric state,
boundary conditions and lookups, runs one LW and one SW solve per
``update_*`` call and keeps the fluxes for its getters.

McICA reproducibility: the cloudy solves draw their mask from the seed
``2 * step + wave`` (wave 0 = LW, 1 = SW) keyed on the global column, so
setting the same step reproduces the same sampling bit for bit.

f64: an f64 solver runs at any column count. Above a memory budget (8 GB
of spectral tensors by default, ``$RRTMGP_CHUNK_BUDGET_GB`` to adjust) every
solve goes through ``solve_chunked`` in ``auto_chunk``-column chunks, the
kernel path too; chunked fluxes equal unchunked ones bit for bit. On CUDA
tensors the clear-sky solves without aerosols take the f64 builds of the
``lw_clear_mega`` kernel (LW no-scattering) and of the ``sw_clear_mega``
kernel (SW two-stream); ``f64_kernel=False`` keeps them on the exact torch
path. Every other f64 solve takes the torch path, whatever
``fused_optics`` says.

Mesh: ``RRTMGPSolver(mesh=...)`` with a ``parallel.sharding.ColumnMesh``
splits the columns over the mesh entries (``grid_params.ncol`` is the
global count and must divide by the mesh size). The state and boundary
conditions may be whole trees, split at construction, or ``ColumnSharded``
ones (``parallel.distributed.globalize``); the lookups are copied once to
each device. Every solve runs once per mesh entry of this process
(``shard_solve``), the McICA stream keyed on the global column as
unsplit, so the fluxes equal the unsplit solver's bit for bit; fluxes,
diagnostics and getters hold ``ColumnSharded`` values. An f64 solver
chunks each entry's columns against the memory budget.

Not ported: the TPU-only arguments of the JAX solver (``pallas_windowed``
"force" and "auto", which choose table windows the port does not have, and
``use_pallas``). The port adds ``impl`` (``"kernel"``, ``"two_kernel"``,
``"sweep"``, ``"torch"`` or None), passed through to ``solve_lw`` /
``solve_sw``: the megakernels; the optics kernel, plain-torch composition and
a sweep kernel; plain-torch optics and a sweep kernel; or plain torch
throughout. With the default None f32 CUDA solves take the megakernels, and
the two-kernel path for several LW angles (``n_gauss_angles > 1``) and for
the SW direct-beam solve (``two_stream_sw=False``); never ``"sweep"``.
``fused_optics=False``, passed through likewise, is the counterpart of
``pallas_windowed="off"``: every f32 CUDA solve takes the two-kernel path
with the unfused optics (the table interpolation and minor-gas kernels in
place of the materialized-optics kernel). f64 routing ignores it, as the
JAX package's f64 ignores ``pallas_windowed``: an f64 solver with
``fused_optics=False`` takes the routes of the fused f64 solver above (the
f64 kernel, unless ``f64_kernel=False``, or the torch path) and gives its
fluxes bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

from .data.lookups import AerosolLookup, CloudLookup, GasLookup
from .models import rrtmgp as _solvers
from .models.gray import solve_gray_lw, solve_gray_sw
from .parallel.sharding import ColumnSharded, column_ids, replicate, shard_columns, shard_solve
from .parameters import RRTMGPParameters
from .states import AtmosphericState, LwBCs, SwBCs, get_vmr
from .utils.datalayouts import domain_view
from .utils.profiling import span

#: (nlay, ncol, ngpt) tensor-equivalents the f64 auto-chunk budgets per solve:
#: the JAX package's figure, kept so that both packages choose the same chunk.
#: The torch path measures 7-18 at its peak on an H100 and the f64 kernel
#: path 2.5 (PERF.md), so the budget is a safe upper bound here.
F64_TENSOR_EQUIVALENTS = 34

# ---------------------------------------------------------------------------
# Grid params + radiation methods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RRTMGPGridParams:
    nlay: int
    ncol: int
    dtype: torch.dtype = torch.float32
    isothermal_boundary_layer: bool = False


@dataclasses.dataclass(frozen=True)
class GrayRadiation:
    pass


@dataclasses.dataclass(frozen=True)
class ClearSkyRadiation:
    aerosol_radiation: bool = False


@dataclasses.dataclass(frozen=True)
class AllSkyRadiation:
    aerosol_radiation: bool = False
    reset_rng_seed: bool = False


@dataclasses.dataclass(frozen=True)
class AllSkyRadiationWithClearSkyDiagnostics:
    aerosol_radiation: bool = False
    reset_rng_seed: bool = False


RadiationMethod = (
    GrayRadiation | ClearSkyRadiation | AllSkyRadiation | AllSkyRadiationWithClearSkyDiagnostics
)
_CLOUDY = (AllSkyRadiation, AllSkyRadiationWithClearSkyDiagnostics)


# ---------------------------------------------------------------------------
# Lookup tables per radiation method
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LookupBundle:
    lookup_lw: GasLookup | None = None
    lookup_sw: GasLookup | None = None
    lookup_lw_cld: CloudLookup | None = None
    lookup_sw_cld: CloudLookup | None = None
    lookup_lw_aero: AerosolLookup | None = None
    lookup_sw_aero: AerosolLookup | None = None


def lookup_tables(
    radiation_method: RadiationMethod,
    data_dir: str | None = None,
    dtype=torch.float64,
    device=None,
) -> LookupBundle:
    """The lookup set of a radiation method, in ``dtype`` on ``device``
    (None: the card when there is one).

    With ``data_dir`` (or $RRTMGP_DATA) pointing at an rrtmgp-data v1.9
    checkout, the NetCDF tables: the checkout is validated first
    (``data.manifest.validate_rrtmgp_data``, the v1.9 sizes not enforced),
    then the two gas files are loaded, the cloud files for the all-sky
    methods and the aerosol files when ``aerosol_radiation`` is set. A
    missing file raises ``FileNotFoundError`` naming it. NetCDF4 files need
    h5py; NetCDF3 files are read with scipy.

    Otherwise synthetic tables at the real files' dimensions (LW 256
    g-points in 16 bands, SW 224 in 14), with the JAX package's seeds, so
    they equal its tables bit for bit."""
    if isinstance(radiation_method, GrayRadiation):
        return LookupBundle()
    data_dir = data_dir or os.environ.get("RRTMGP_DATA")
    cloudy = isinstance(radiation_method, _CLOUDY)
    aero = getattr(radiation_method, "aerosol_radiation", False)
    kw = dict(dtype=dtype, device=device)

    if data_dir:
        from .data.loader import load_aerosol_lookup, load_cloud_lookup, load_gas_lookup
        from .data.manifest import V19_FILES, validate_rrtmgp_data

        # structural validation before first use: a malformed checkout
        # fails loudly instead of scrambling a table
        validate_rrtmgp_data(data_dir, strict_v19=False)
        j = lambda key: os.path.join(data_dir, V19_FILES[key])
        bundle = dict(lookup_lw=load_gas_lookup(j("gas_lw"), **kw), lookup_sw=load_gas_lookup(j("gas_sw"), **kw))
        if cloudy:
            bundle["lookup_lw_cld"] = load_cloud_lookup(j("cloud_lw"), **kw)
            bundle["lookup_sw_cld"] = load_cloud_lookup(j("cloud_sw"), **kw)
        if aero:
            bundle["lookup_lw_aero"] = load_aerosol_lookup(j("aerosol_lw"), **kw)
            bundle["lookup_sw_aero"] = load_aerosol_lookup(j("aerosol_sw"), **kw)
        return LookupBundle(**bundle)

    from .data.synthetic import (
        synthetic_aerosol_lookup,
        synthetic_cloud_lookup,
        synthetic_gas_lookup,
    )

    bundle = dict(
        lookup_lw=synthetic_gas_lookup(longwave=True, n_gpt=256, n_bnd=16, **kw),
        lookup_sw=synthetic_gas_lookup(longwave=False, n_gpt=224, n_bnd=14, seed=1, **kw),
    )
    if cloudy:
        bundle["lookup_lw_cld"] = synthetic_cloud_lookup(n_bnd=16, **kw)
        bundle["lookup_sw_cld"] = synthetic_cloud_lookup(n_bnd=14, seed=5, **kw)
    if aero:
        bundle["lookup_lw_aero"] = synthetic_aerosol_lookup(n_bnd=16, **kw)
        bundle["lookup_sw_aero"] = synthetic_aerosol_lookup(n_bnd=14, seed=6, **kw)
    return LookupBundle(**bundle)


# ---------------------------------------------------------------------------
# Canonical name lists
# ---------------------------------------------------------------------------


def aerosol_names() -> list[str]:
    """Canonical MERRA aerosol-name set."""
    return [
        "dust4", "sea_salt5", "dust1", "sulfate", "organic_carbon", "dust5",
        "sea_salt3", "sea_salt1", "organic_carbon_rh", "dust2", "sea_salt2",
        "sea_salt4", "dust3", "black_carbon_rh", "black_carbon",
    ]


#: aerosol name -> 0-based row of AerosolState.aero_mass / aero_size
AEROSOL_INDEX = {
    "dust1": 0, "sea_salt1": 1, "sulfate": 2, "black_carbon_rh": 3,
    "black_carbon": 4, "organic_carbon_rh": 5, "organic_carbon": 6,
    "dust2": 7, "dust3": 8, "dust4": 9, "dust5": 10,
    "sea_salt2": 11, "sea_salt3": 12, "sea_salt4": 13, "sea_salt5": 14,
}


def gas_names_sw() -> list[str]:
    """Gas names of the SW lookup tables."""
    return [
        "h2o", "cfc11", "h2o_self", "co2", "cfc12", "hfc134a", "cfc22", "ch4",
        "hfc23", "ccl4", "hfc143a", "co", "no2", "n2", "o2", "o3", "h2o_frgn",
        "hfc32", "n2o", "cf4", "hfc125",
    ]


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


class RRTMGPSolver:
    """Host-side solver bundle: state, boundary conditions, lookups, and the
    fluxes of the last ``update_lw_fluxes`` / ``update_sw_fluxes``."""

    def __init__(
        self,
        grid_params: RRTMGPGridParams,
        radiation_method: RadiationMethod,
        params: RRTMGPParameters,
        bcs_lw: LwBCs | None,
        bcs_sw: SwBCs | None,
        as_: AtmosphericState,
        lookups: LookupBundle | None = None,
        center_z=None,
        face_z=None,
        two_stream_lw: bool = True,
        two_stream_sw: bool = True,
        n_gauss_angles: int = 1,
        data_dir: str | None = None,
        aero_species: tuple | None = None,
        mesh=None,
        metric_scaling=None,
        eta_node_mode: str = "continuous",
        f64_kernel: bool | None = None,
        impl: str | None = None,
        fused_optics: bool = True,
    ):
        if mesh is not None:
            as_, bcs_lw, bcs_sw, metric_scaling = _split(mesh, grid_params.ncol, as_, bcs_lw, bcs_sw,
                                                         metric_scaling)
        want, got = grid_params.dtype, as_.p_lay.dtype
        if got != want:
            raise TypeError(
                f"AtmosphericState dtype {got} != grid_params dtype {want}; "
                "build the state with the grid dtype (e.g. synthetic_atmosphere(dtype=...), "
                "setup_gray_as_pr_grid(dtype=...))"
            )
        self.grid_params = grid_params
        self.radiation_method = radiation_method
        self.params = params
        self.bcs_lw = bcs_lw
        self.bcs_sw = bcs_sw
        self.as_ = as_
        self.center_z = center_z
        self.face_z = face_z
        self.two_stream_lw = two_stream_lw
        self.two_stream_sw = two_stream_sw
        self.n_gauss_angles = n_gauss_angles
        self.aero_species = aero_species
        self.mesh = mesh
        self.metric_scaling = metric_scaling
        self.eta_node_mode = eta_node_mode
        self.f64_kernel = f64_kernel
        self.impl = impl
        self.fused_optics = fused_optics
        if lookups is None:
            device = as_.p_lay.devices[0] if mesh is not None else as_.p_lay.device
            lookups = lookup_tables(radiation_method, data_dir, dtype=want, device=device)
        self.lookups = lookups
        #: what each solve is given as its lookups: the bundle, or in mesh
        #: mode its copies by device; and the global column ids by mesh entry
        self._lookups_arg = lookups if mesh is None else replicate(lookups, mesh)
        self._col_ids = None if mesh is None else column_ids(mesh, grid_params.ncol)
        #: columns per chunk of every solve, or None: set for f64 problems
        #: above the memory budget (never for the gray model, which has no
        #: spectral tensors)
        self.auto_chunk: int | None = None
        if want == torch.float64 and not isinstance(radiation_method, GrayRadiation):
            self._set_auto_chunk()

        self.flux_lw: _solvers.FluxLW | None = None
        self.flux_sw: _solvers.FluxSW | None = None
        self.clear_flux_lw: _solvers.FluxLW | None = None
        self.clear_flux_sw: _solvers.FluxSW | None = None
        self.diag_lw: _solvers.SolveDiagnostics | None = None
        self.diag_sw: _solvers.SolveDiagnostics | None = None
        self._step = 0

    def _set_auto_chunk(self):
        """f64 auto-chunking: an f64 solve on the torch path materializes the
        (nlay, ncol, ngpt) spectral tensors, budgeted at 34 tensor-equivalents,
        ~4 MB per column at 60 layers x 256 g-points. Above the budget
        (default 8 GB, override $RRTMGP_CHUNK_BUDGET_GB) every solve runs
        through ``solve_chunked``; the f64 kernel's scratch (2 tensors) counts
        against the same budget. The chunk is the largest power of two under
        the budget and need not divide ncol. McICA stays chunk-invariant
        (global-column keying). In mesh mode the budget holds per mesh
        entry (the JAX package does not chunk in mesh mode)."""
        lk = self.lookups
        ncol = self.as_.ncol if self.mesh is None else self.grid_params.ncol // len(self.mesh)
        ngpt_max = max(lk.lookup_lw.n_gpt, lk.lookup_sw.n_gpt)
        per_col = self.as_.nlay * ngpt_max * 8 * F64_TENSOR_EQUIVALENTS
        budget = float(os.environ.get("RRTMGP_CHUNK_BUDGET_GB", "8")) * 1e9
        cmax = max(int(budget // per_col), 1)
        if ncol > cmax:
            self.auto_chunk = 1 << (cmax.bit_length() - 1)
            warnings.warn(
                f"f64 solve at ncol={ncol}{'' if self.mesh is None else ' per mesh entry'} would materialize "
                f"~{ncol * per_col / 1e9:.1f} GB of spectral tensors; "
                f"auto-chunking into {self.auto_chunk}-column chunks "
                f"(budget {budget / 1e9:.0f} GB, "
                f"$RRTMGP_CHUNK_BUDGET_GB to adjust)",
                stacklevel=3,
            )

    # -- solves ------------------------------------------------------------

    def _aero(self, lk: LookupBundle, wave: int):
        if not getattr(self.radiation_method, "aerosol_radiation", False):
            return None
        return lk.lookup_sw_aero if wave else lk.lookup_lw_aero

    def _per_shard(self, fn, *args):
        """``fn(*args)``; in mesh mode once per mesh entry of this process,
        on its columns, as a ``ColumnSharded``."""
        if self.mesh is None:
            return fn(*args)
        return shard_solve(fn, self.mesh, self.grid_params.ncol)(*args)

    def _solve(self, solve_fn, bcs, cloudy: bool, wave: int, **kw):
        """One solve of the whole state (in mesh mode of each entry's
        columns), in ``auto_chunk``-column chunks when that is set. Metric
        scaling is applied to the assembled fluxes."""
        seed = self._mcica_key(wave) if cloudy else None

        def run(lk, atm, b, col_ids, scale):
            kw_lk = dict(kw, lkp_aero=self._aero(lk, wave))
            if cloudy:
                kw_lk["lkp_cld"] = lk.lookup_sw_cld if wave else lk.lookup_lw_cld
            # the global index of the first column, on which the McICA stream is keyed
            base = 0 if col_ids is None else int(col_ids[0])
            if self.auto_chunk is None:
                if cloudy:
                    kw_lk["col_offset"] = base
                return solve_fn(lk, atm, b, metric_scaling=scale, cld_mask_seed=seed, **kw_lk)
            if cloudy:
                one = lambda a, bb, s, off: solve_fn(lk, a, bb, cld_mask_seed=s, col_offset=base + off, **kw_lk)
            else:
                one = lambda a, bb: solve_fn(lk, a, bb, **kw_lk)
            flux, diag = _solvers.solve_chunked(one, atm, b, self.auto_chunk, cld_mask_seed=seed)
            return _solvers._apply_metric_scaling(flux, scale), diag

        return self._per_shard(run, self._lookups_arg, self.as_, bcs, self._col_ids, self.metric_scaling)

    def _route(self) -> dict:
        """The solves' ``impl`` and ``fused_optics``: with ``f64_kernel=False``
        an f64 solver takes the exact path also where f64 has a kernel (f64
        ignores fused_optics)."""
        if self.impl is None and self.f64_kernel is False and self.grid_params.dtype == torch.float64:
            return dict(impl="torch", fused_optics=True)
        return dict(impl=self.impl, fused_optics=self.fused_optics)

    def _lw(self, cloudy: bool):
        solve = lambda lk, a, b, **kw: _solvers.solve_lw(lk.lookup_lw, a, b, **kw)
        return self._solve(
            solve, self.bcs_lw, cloudy, 0, two_stream=self.two_stream_lw,
            n_gauss_angles=self.n_gauss_angles, aero_species=self.aero_species,
            eta_node_mode=self.eta_node_mode, **self._route(),
        )

    def _sw(self, cloudy: bool):
        solve = lambda lk, a, b, **kw: _solvers.solve_sw(lk.lookup_sw, a, b, **kw)
        return self._solve(
            solve, self.bcs_sw, cloudy, 1, two_stream=self.two_stream_sw,
            aero_species=self.aero_species, eta_node_mode=self.eta_node_mode, **self._route(),
        )

    def _mcica_key(self, wave: int) -> int:
        """McICA seed of this step and wave (0 = LW, 1 = SW)."""
        return 2 * self._step + wave

    def advance_step(self, step: int | None = None):
        """Advance (or set) the step that keys the McICA sampling."""
        self._step = self._step + 1 if step is None else step

    def check_window(self, as_=None) -> bool:
        """Always True: the port's kernels read whole tables, with no table
        windows to outgrow."""
        return True

    def update_fluxes(self):
        """``update_lw_fluxes()`` then ``update_sw_fluxes()``; returns
        (flux_lw, flux_sw)."""
        self.update_lw_fluxes()
        self.update_sw_fluxes()
        return self.flux_lw, self.flux_sw

    def update_lw_fluxes(self):
        with span("rrtmgp.update_lw_fluxes"):
            m = self.radiation_method
            if isinstance(m, GrayRadiation):
                gray = lambda a, b: _solvers.FluxLW(*solve_gray_lw(
                    a, b.sfc_emis[0], self.params, two_stream=self.two_stream_lw,
                    n_gauss_angles=self.n_gauss_angles))
                self.flux_lw = self._per_shard(gray, self.as_, self.bcs_lw)
                return self.flux_lw
            if isinstance(m, AllSkyRadiationWithClearSkyDiagnostics):
                self.clear_flux_lw, _ = self._lw(cloudy=False)
            self.flux_lw, self.diag_lw = self._lw(cloudy=isinstance(m, _CLOUDY))
            return self.flux_lw

    def update_sw_fluxes(self):
        with span("rrtmgp.update_sw_fluxes"):
            m = self.radiation_method
            if isinstance(m, GrayRadiation):
                gray = lambda a, b: _solvers.FluxSW(*solve_gray_sw(
                    a, b.cos_zenith, b.toa_flux, b.sfc_alb_direct[0], b.sfc_alb_diffuse[0],
                    two_stream=self.two_stream_sw))
                self.flux_sw = self._per_shard(gray, self.as_, self.bcs_sw)
                return self.flux_sw
            if isinstance(m, AllSkyRadiationWithClearSkyDiagnostics):
                self.clear_flux_sw, _ = self._sw(cloudy=False)
            self.flux_sw, self.diag_sw = self._sw(cloudy=isinstance(m, _CLOUDY))
            return self.flux_sw

    # -- getters -------------------------------------------------------------

    def top_of_atmosphere_lw_flux_dn(self):
        return None if self.bcs_lw is None else self.bcs_lw.inc_flux

    def top_of_atmosphere_diffuse_sw_flux_dn(self):
        return None if self.bcs_sw is None else self.bcs_sw.inc_flux_diffuse

    def lw_flux_up(self):
        return self.flux_lw.flux_up

    def lw_flux_dn(self):
        return self.flux_lw.flux_dn

    def lw_flux_net(self):
        return self.flux_lw.flux_net

    def clear_lw_flux_up(self):
        return self.clear_flux_lw.flux_up

    def clear_lw_flux_dn(self):
        return self.clear_flux_lw.flux_dn

    def clear_lw_flux(self):
        return self.clear_flux_lw.flux_net

    def surface_emissivity(self):
        return self.bcs_lw.sfc_emis

    def sw_flux_up(self):
        return self.flux_sw.flux_up

    def sw_flux_dn(self):
        return self.flux_sw.flux_dn

    def sw_flux_net(self):
        return self.flux_sw.flux_net

    def sw_direct_flux_dn(self):
        return self.flux_sw.flux_dn_dir

    def clear_sw_flux_up(self):
        return self.clear_flux_sw.flux_up

    def clear_sw_flux_dn(self):
        return self.clear_flux_sw.flux_dn

    def clear_sw_direct_flux_dn(self):
        return self.clear_flux_sw.flux_dn_dir

    def clear_sw_flux(self):
        return self.clear_flux_sw.flux_net

    def cloud_liquid_effective_radius(self):
        return self.as_.cloud_state.cld_r_eff_liq

    def cloud_ice_effective_radius(self):
        return self.as_.cloud_state.cld_r_eff_ice

    def cloud_liquid_water_path(self):
        return self.as_.cloud_state.cld_path_liq

    def cloud_ice_water_path(self):
        return self.as_.cloud_state.cld_path_ice

    def cloud_fraction(self):
        return self.as_.cloud_state.cld_frac

    def sw_cloud_cover(self):
        return None if self.diag_sw is None else self.diag_sw.cld_cover

    def lw_cloud_cover(self):
        return None if self.diag_lw is None else self.diag_lw.cld_cover

    def aod_sw_extinction(self):
        return None if self.diag_sw is None else self.diag_sw.aod_sw_ext

    def aod_sw_scattering(self):
        return None if self.diag_sw is None else self.diag_sw.aod_sw_sca

    def get_center_z(self):
        return self.center_z

    def get_face_z(self):
        return self.face_z

    def cos_zenith(self):
        return self.bcs_sw.cos_zenith

    def toa_flux(self):
        return self.bcs_sw.toa_flux

    def direct_sw_surface_albedo(self):
        return self.bcs_sw.sfc_alb_direct

    def diffuse_sw_surface_albedo(self):
        return self.bcs_sw.sfc_alb_diffuse

    def latitude(self):
        return self.as_.lat

    def surface_temperature(self):
        return self.as_.t_sfc

    def domain_view(self, data):
        """``data`` without the isothermal boundary layer when the grid has
        one (see ``domain_view``)."""
        if data is None:
            return None
        if isinstance(data, ColumnSharded):
            return data.map(lambda d: domain_view(self.grid_params.isothermal_boundary_layer, d))
        return domain_view(self.grid_params.isothermal_boundary_layer, data)

    def pressure(self):
        return self.domain_view(self.as_.p_lay)

    def temperature(self):
        return self.domain_view(self.as_.t_lay)

    def relative_humidity(self):
        return self.domain_view(self.as_.rel_hum)

    def optical_thickness_parameter(self):
        return getattr(self.as_, "otp", None)

    def isothermal_boundary_layer(self) -> bool:
        return self.grid_params.isothermal_boundary_layer

    def aero_radius(self, name: str):
        return self.as_.aerosol_state.aero_size[AEROSOL_INDEX[name]]

    def aero_column_mass_density(self, name: str):
        return self.as_.aerosol_state.aero_mass[AEROSOL_INDEX[name]]

    def volume_mixing_ratio(self, name: str):
        """VMR by gas name through the SW lookup's gas names."""
        sw = self.lookups.lookup_sw
        names = list(sw.gas_names) if sw is not None else gas_names_sw()
        name = {"h2o_self": "h2o", "h2o_frgn": "h2o"}.get(name, name)
        ig = names.index(name) + 1
        if isinstance(self.as_, ColumnSharded):
            return self.as_.map(lambda a: get_vmr(a.vmr, ig))
        return get_vmr(self.as_.vmr, ig)


def _split(mesh, ncol: int, as_, bcs_lw, bcs_sw, metric_scaling):
    """The solver's state, boundary conditions and metric scaling split over
    the mesh; a ``ColumnSharded`` value is taken as it is."""
    if not isinstance(as_, ColumnSharded) and as_.ncol != ncol:
        raise ValueError(f"the state has {as_.ncol} columns, grid_params.ncol is {ncol}")
    split = lambda x: x if x is None or isinstance(x, ColumnSharded) else shard_columns(x, mesh, ncol)
    return split(as_), split(bcs_lw), split(bcs_sw), split(metric_scaling)
