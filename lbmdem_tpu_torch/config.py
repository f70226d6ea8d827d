"""Configuration: typed dataclasses + reference-style input files.

A copy of the JAX package's `lbmdem_tpu/config.py`: the same fields,
defaults and deck grammar, so a JAX `SimConfig` crosses over as
`SimConfig(**dataclasses.asdict(jax_cfg))`.

SURVEY.md SS2 C18 (parameter input) and C19 (particle input). The
reference is driven by a keyword text parameter file plus a particle
list file; we keep that style (one `key value...` pair per line, `#`
comments) so reference decks port mechanically, and layer a typed
`SimConfig` on top. All shape-determining fields are static Python ints
so the whole step loop jit-compiles with fixed shapes.

Parameter keywords (reference-format; SURVEY C18 lists the set):
    nx, ny                lattice size
    tau                   BGK relaxation time (or `nu` in lattice units)
    gx, gy                fluid body force / gravity (lattice units)
    steps                 number of LBM steps
    out_interval          snapshot interval (0 = never)
    particles <path>      particle input file
    kn, kt                contact normal/tangential spring stiffness
    gamma_n, gamma_t      contact normal/tangential damping
    mu                    Coulomb friction coefficient
    rho_s                 solid density (lattice units; fluid rho0 = 1)
    n_sub                 DEM substeps per LBM step
    bc <side> <type>      side in {west,east,south,north}, type in
                          {wall, periodic}; west also takes `inlet`
                          (Zou/He velocity) paired with east `outlet`
                          (Zou/He pressure)
    u_inlet <u>           inlet x-velocity (peak for poiseuille profile)
    inlet_profile <p>     uniform | poiseuille
    rho_outlet <rho>      outlet density (0 = rho0)
    g_px, g_py            gravity acting on particles (lattice units)
    buoyancy [0|1]        add analytic buoyancy -rho_f*V*g to disks
    smagorinsky <Cs>      LES constant (0 disables; SURVEY C8)
    collision bgk|trt     collision operator (default bgk; trt adds a
                          second relaxation rate for the odd moments)
    trt_magic <L>         TRT magic parameter (default 3/16: exact
                          mid-link walls)
    eps_samples <n>       n x n subgrid samples per cell for the solid
                          fraction (SURVEY C9)
    eps_method sample|ramp|exact   coverage model (default sample =
                          reference-style subgrid sampling; ramp is the
                          measured speed tier, exact the accuracy tier
                          - see tools/ab_eps.py / docs/performance.md)
    eps_r_shift <d>       hydrodynamic radius calibration (cells, in
                          [-1, 0]): shrinks the COVERAGE radius only,
                          compensating the diffuse-interface drag bias
                          (SimConfig.eps_r_shift; default 0)
    nt_mode nt|lambda     NT blend weighting (default nt; lambda = the
                          TRT/Lambda-consistent experiment, measured
                          WORSE on 2D-1 drag - docs/performance.md)
    dtype float32|float64
    f_storage float32|bfloat16   HBM storage of f on the fused path
                          (bfloat16 = shifted-population storage)

Particle file: one disk per line, `x y r [vx vy omega [fixed]]` in
lattice units (fixed = 0/1: infinite-mass obstacle / prescribed-motion
disk, see DiskSpec).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

WALL = "wall"
PERIODIC = "periodic"
INLET = "inlet"
OUTLET = "outlet"
_SIDES = ("west", "east", "south", "north")


@dataclasses.dataclass(frozen=True)
class DiskSpec:
    """Initial condition of one DEM disk (lattice units).

    `fixed` disks have infinite mass/inertia: forces (hydro, contact,
    gravity) never change their velocity, but position still integrates
    from the (constant) initial v/omega. v = 0 gives a stationary
    obstacle (flow past a cylinder, porous beds); v != 0 a prescribed-
    motion boundary (towed or rotating cylinder). The IMB coupling is
    unchanged - hydro force/torque on fixed disks is still computed, so
    drag on obstacles is observable (Simulation.hydro_forces)."""

    x: float
    y: float
    r: float
    vx: float = 0.0
    vy: float = 0.0
    omega: float = 0.0
    fixed: bool = False
    # per-disk solid density (lattice units); 0.0 = use cfg.rho_s.
    # Mixed densities drive segregation/stratification problems.
    rho_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full static configuration of a simulation (all lattice units)."""

    nx: int
    ny: int
    tau: float = 1.0
    # Fluid body force (e.g. channel driving; gravity acting on the fluid).
    gx: float = 0.0
    gy: float = 0.0
    steps: int = 0
    out_interval: int = 0
    # Boundary conditions per side: "wall" (half-way bounce-back) or
    # "periodic".
    bc_west: str = PERIODIC
    bc_east: str = PERIODIC
    bc_south: str = WALL
    bc_north: str = WALL
    # --- DEM / coupling ---
    max_disks: int = 0  # static capacity; >= number of actual disks
    rho_s: float = 2.0
    kn: float = 1.0
    kt: float = 0.0
    gamma_n: float = 0.0
    gamma_t: float = 0.0
    mu: float = 0.0
    n_sub: int = 10
    # Gravity acting on disks; with `buoyancy`, the analytic Archimedes
    # force -rho_f * V * g is added (fluid itself usually unforced then).
    g_px: float = 0.0
    g_py: float = 0.0
    buoyancy: bool = True
    # Max simultaneous near-contacts per disk (pruned Verlet list slots;
    # hex-packing coordination is 6 - overflow is counted, never dropped).
    contact_cap: int = 10
    # Solid-fraction stamping: subgrid sample count per axis, and the
    # static per-disk stamp window (cells per axis). window=0 -> derived
    # from max radius at scene build time. eps_method "sample" uses
    # eps_samples^2 subgrid points (reference-style; fastest on TPU -
    # the compare-accumulate loop is a wide independent tree the VPU
    # pipelines, measured 1839 vs 1555 MLUPS against "exact" at
    # 4096^2/10k); "exact" the analytic tangent-plane circle-cell
    # overlap (ops/imb.exact_coverage - ~10x more accurate per cell,
    # but a serial sqrt/reciprocal chain); "ramp" the linear
    # diffuse-interface approximation clip(r + 1/2 - d, 0, 1).
    eps_samples: int = 4
    eps_method: str = "sample"
    # Hydrodynamic radius shift (lattice cells) applied ONLY to the
    # solid-fraction coverage (stamp + force-share gather), never to DEM
    # contacts or binning: the diffuse IMB interface places the
    # effective no-slip surface OUTSIDE the nominal radius (the
    # partially-covered boundary ring still blends solid behavior), so
    # the obstacle acts hydrodynamically larger - the classical
    # calibration (Ladd-style hydrodynamic radius) subtracts a fixed
    # sub-cell shift. Measured on Schafer-Turek 2D-1 (D=20): the
    # uncorrected drag bias is +4.4% and scales like a constant
    # ~+0.4-cell radius excess (it drops to +0.93% at D=40). Opt-in
    # (default 0), range [-1, 0]: a resolution-independent calibration,
    # not a physics change - tests pin kernel/oracle parity under it.
    eps_r_shift: float = 0.0
    # NT blend weighting (ops/imb.nt_weight): "nt" = the published
    # Noble-Torczynski B(eps, tau); "lambda" = the TRT/Lambda-consistent
    # variant (tm = 3/16 / (tau - 1/2), the odd relaxation depth that
    # places plane bounce-back walls mid-link) - the VERDICT r4 #7
    # interface-side experiment; measured verdict in
    # docs/performance.md. Orthogonal to eps_method/eps_r_shift.
    nt_mode: str = "nt"
    window: int = 0
    # Per-tile disk capacity for the Pallas stamp/reduce kernels
    # (0 = derived from disk radii at scene build time).
    tile_cap: int = 0
    # Ghost-disk capacity per periodic block (x / y / corner): disks
    # whose stamp window can cross a periodic edge get a min-image
    # shifted copy appended for the coupling paths (ops/imb.py ghost
    # helpers). 0 = derived from disk count at scene build time;
    # overflow is counted into SimState.overflow, never dropped.
    ghost_cap: int = 0
    # Smagorinsky LES constant (0 = plain BGK).
    smagorinsky: float = 0.0
    # Collision operator: "bgk" (single relaxation time, the reference's
    # operator) or "trt" (two-relaxation-time: the even/odd parts of
    # f - feq relax at separate rates; the odd rate follows from the
    # "magic" parameter Lambda = (tau+ - 1/2)(tau- - 1/2), default 3/16,
    # which pins the half-way bounce-back wall EXACTLY mid-link at any
    # tau - removing BGK's viscosity-dependent wall slip). Viscosity,
    # B(eps, tau) and the LES closure all keep using tau (= tau+).
    collision: str = "bgk"
    trt_magic: float = 3.0 / 16.0
    # Coupling-cadence temporal blocking (opt-in speed tier, Pallas
    # coupled path): k LBM steps per fused-kernel pass / HBM round-trip
    # with the solid fields (stamp + binning) FROZEN at window-start
    # disk positions; the hydro force reduce still runs per inner step,
    # so the DEM integrates every step with a fresh force - only the
    # geometry the fluid sees lags by < k steps (disks travel ~1e-3
    # cells/step; the coverage model is itself ~1e-2-accurate/cell).
    # 1 = exact per-step coupling (default; the reference's semantics).
    # Range 2..8 (the fused window's 8-row solid halo); must divide the
    # binning cadence (simulation.BIN_CADENCE = 8). Physics deltas
    # measured on hardware in docs/performance.md.
    coupling_k: int = 1
    # Paranoid/debug mode (SURVEY SS5.2/5.3): validate f finite, rho>0,
    # disk state finite and zero overflow inside the jitted chunk; the
    # first failing step number lands in SimState.fail_step and the
    # state freezes there. True (= "step"): validate after EVERY step -
    # exact step reporting, but the big-grid fast chunk structures
    # (static-solid hoist, sharded Verlet cadence) are forfeited for the
    # per-step path, and each step pays one extra pass over f. "chunk":
    # validate at the kernel-chunk boundary (every TEMPORAL_K steps on
    # the hoisted paths, every BIN_CADENCE steps on the Verlet-cadence
    # paths) - the fast structures stay, fail_step reports the END of
    # the failing block (within k of the exact step). Off in production.
    paranoia: bool | str = False
    # Numerics
    dtype: str = "float32"
    # HBM storage dtype for the f array on the fused-kernel path:
    # "bfloat16" stores the SHIFTED populations g_i = f_i - w_i*rho0
    # (compute stays float32 in-kernel; moments are shift-free since
    # sum(w)=1, sum(w e)=0, and the rest state is exactly 0 in bf16) -
    # halves the HBM traffic floor of the coupled step. Opt-in: bf16
    # re-rounding adds ~2^-9-relative noise to the hydrodynamic
    # fluctuation field each step (validated <1% on settling parity).
    f_storage: str = "float32"
    # Initial fluid density / velocity.
    rho0: float = 1.0
    u0x: float = 0.0
    u0y: float = 0.0
    # Tangential wall speeds (moving-wall bounce-back, e.g. lid-driven
    # cavity): west/east walls move along y, south/north along x.
    uw_west: float = 0.0
    uw_east: float = 0.0
    uw_south: float = 0.0
    uw_north: float = 0.0
    # Open boundaries (Zou/He non-equilibrium bounce-back): bc_west
    # 'inlet' prescribes the x-velocity profile at the west column and
    # bc_east 'outlet' prescribes the density at the east column (0 ->
    # rho0) with the normal velocity from the Zou/He closure. They come
    # as a pair. inlet_profile: 'uniform' (u = u_inlet everywhere) or
    # 'poiseuille' (parabola peaking at u_inlet, zero at the y walls).
    u_inlet: float = 0.0
    inlet_profile: str = "uniform"
    rho_outlet: float = 0.0
    # Physical base scales of the deck (SURVEY C17): 0 = the deck was
    # written directly in lattice units. When set (SI decks: `dx`,
    # `dt_phys`, `rho_phys` keywords), every other field above is
    # already converted to lattice units; these record the scales for
    # output conversion (`cfg.units`).
    phys_dx: float = 0.0
    phys_dt: float = 0.0
    phys_rho: float = 0.0

    def __post_init__(self):
        if self.bc_west not in (WALL, PERIODIC, INLET):
            raise ValueError(
                f"bad bc west {self.bc_west!r}: want {WALL!r}, "
                f"{PERIODIC!r} or {INLET!r}"
            )
        if self.bc_east not in (WALL, PERIODIC, OUTLET):
            raise ValueError(
                f"bad bc east {self.bc_east!r}: want {WALL!r}, "
                f"{PERIODIC!r} or {OUTLET!r}"
            )
        for s in (self.bc_south, self.bc_north):
            if s not in (WALL, PERIODIC):
                raise ValueError(f"bad bc {s!r}: want {WALL!r} or {PERIODIC!r}")
        # open boundaries come as a west-inlet / east-outlet pair (the
        # canonical channel orientation; rotate the scene otherwise)
        if (self.bc_west == INLET) != (self.bc_east == OUTLET):
            raise ValueError("open bc must pair: west inlet with east outlet")
        if self.bc_west == INLET:
            if self.inlet_profile not in ("uniform", "poiseuille"):
                raise ValueError(
                    f"bad inlet_profile {self.inlet_profile!r}: want "
                    "'uniform' or 'poiseuille'"
                )
            if not -0.4 < self.u_inlet < 0.4:
                raise ValueError(
                    f"u_inlet {self.u_inlet} out of the stable lattice "
                    f"range (|u| < 0.4)"
                )
            if self.rho_outlet and not 0.2 <= self.rho_outlet <= 5.0:
                raise ValueError(
                    f"rho_outlet {self.rho_outlet} is not a plausible "
                    f"lattice density (want 0 = rho0, or ~O(1); SI decks "
                    f"use rho_outlet_phys)"
                )
        # pairing must hold in BOTH directions: a lone periodic east
        # side would wrap the fluid exchange against a wall side, and
        # disks would get neither wall forces nor wrap on that axis
        # (wrap_lx/wrap_ly key off bc_west/bc_south)
        if (self.bc_west == PERIODIC) != (self.bc_east == PERIODIC):
            raise ValueError("periodic bc must pair: west/east")
        if (self.bc_south == PERIODIC) != (self.bc_north == PERIODIC):
            raise ValueError("periodic bc must pair: south/north")
        if self.tau <= 0.5:
            raise ValueError(f"tau must exceed 0.5 (got {self.tau})")
        if self.f_storage not in ("float32", "bfloat16"):
            raise ValueError(
                f"bad f_storage {self.f_storage!r}: want 'float32' or "
                "'bfloat16'"
            )
        if self.f_storage == "bfloat16" and self.dtype != "float32":
            raise ValueError(
                "f_storage='bfloat16' requires dtype='float32' (bf16 is a "
                "storage format for the f32 fused-kernel path)"
            )
        if self.collision not in ("bgk", "trt"):
            raise ValueError(
                f"bad collision {self.collision!r}: want 'bgk' or 'trt'"
            )
        if self.collision == "trt" and self.trt_magic <= 0.0:
            raise ValueError(
                f"trt_magic must be positive (got {self.trt_magic})"
            )
        if not (1 <= self.coupling_k <= 8 and 8 % self.coupling_k == 0):
            raise ValueError(
                f"coupling_k {self.coupling_k} out of range: want a "
                "divisor of the binning cadence in 1..8 (the fused "
                "window's 8-row solid halo bounds the temporal block)"
            )
        if self.nt_mode not in ("nt", "lambda"):
            raise ValueError(
                f"bad nt_mode {self.nt_mode!r}: want 'nt' or 'lambda'"
            )
        if self.eps_method not in ("exact", "sample", "ramp"):
            raise ValueError(
                f"bad eps_method {self.eps_method!r}: "
                "want 'exact', 'sample' or 'ramp'"
            )
        if not -1.0 <= self.eps_r_shift <= 0.0:
            raise ValueError(
                f"eps_r_shift {self.eps_r_shift} out of range [-1, 0]: "
                "it shrinks the hydrodynamic (coverage) radius by a "
                "sub-cell calibration; growing it would overflow the "
                "stamp window/bin margins"
            )
        if self.paranoia not in (False, True, "step", "chunk"):
            raise ValueError(
                f"bad paranoia {self.paranoia!r}: want False, True "
                "(per-step) or 'chunk' (validate at kernel-chunk "
                "granularity, keeping the fast chunk structures)"
            )

    def validate_periodic_dem(self) -> None:
        """Periodic DEM uses minimum-image contacts + ghost-disk
        stamping (ops/imb.py, ops/dem.py): both need the wrapped axis
        to be much longer than one stamp window so a disk has a unique
        nearest image and at most ONE ghost per axis. Called by
        Simulation once the window is derived (NOT in __post_init__:
        the sharded path derives shard-local configs via replace(),
        whose small local extents are not user geometry)."""
        if self.max_disks <= 0 or self.window <= 0:
            return
        for L, name in ((self.wrap_lx, "x"), (self.wrap_ly, "y")):
            if L and L < 4 * self.window:
                raise ValueError(
                    f"periodic {name}-extent {int(L)} too small for "
                    f"DEM disks with stamp window {self.window} "
                    f"(need >= 4*window for unambiguous minimum-image "
                    f"wrapping)"
                )

    @property
    def nu(self) -> float:
        return (self.tau - 0.5) / 3.0

    @property
    def paranoia_mode(self) -> str:
        """'off' | 'step' | 'chunk' (True normalizes to 'step')."""
        if not self.paranoia:
            return "off"
        return "chunk" if self.paranoia == "chunk" else "step"

    @property
    def trt_lambda(self) -> float:
        """TRT magic parameter Lambda, or 0.0 when collision='bgk'
        (the single scalar the collide paths branch on)."""
        return self.trt_magic if self.collision == "trt" else 0.0

    @property
    def wrap_lx(self) -> float:
        """Periodic x wrap length for disks (0.0 = x sides are walls)."""
        return float(self.nx) if self.bc_west == PERIODIC else 0.0

    @property
    def wrap_ly(self) -> float:
        """Periodic y wrap length for disks (0.0 = y sides are walls)."""
        return float(self.ny) if self.bc_south == PERIODIC else 0.0

    @property
    def units(self):
        """UnitSystem of a physical-units deck, or None (lattice deck)."""
        if self.phys_dx > 0 and self.phys_dt > 0 and self.phys_rho > 0:
            from lbmdem_tpu_torch.units import UnitSystem

            return UnitSystem(dx=self.phys_dx, dt=self.phys_dt,
                              rho0=self.phys_rho)
        return None

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def window_for_radius(r_max: float) -> int:
    """Static stamp window (cells/axis) that fully covers a disk of radius
    r_max from the cell nearest its center: need cells with center
    distance <= r_max + half-cell diagonal, plus one cell of slack for
    subgrid samples."""
    return 2 * (int(math.ceil(r_max + 0.5)) + 1) + 1


# SI-deck keywords (SURVEY C17 physical<->lattice workflow): each maps
# to (target lattice-unit field, converter name on UnitSystem or a scale
# property to divide by). Requires `dx`, `dt_phys`, `rho_phys` in the
# same deck.
_PHYS_KEYS = {
    "nu_phys": ("tau", "nu"),            # m^2/s -> tau = 3 nu_lat + 1/2
    "gx_phys": ("gx", "accel"),          # m/s^2 fluid driving accel
    "gy_phys": ("gy", "accel"),
    "g_px_phys": ("g_px", "accel"),      # m/s^2 particle gravity
    "g_py_phys": ("g_py", "accel"),
    "rho_s_phys": ("rho_s", "density"),  # kg/m^3 solid density
    "kn_phys": ("kn", "stiffness"),      # N/m contact springs
    "kt_phys": ("kt", "stiffness"),
    "gamma_n_phys": ("gamma_n", "damping"),  # N s/m dashpots
    "gamma_t_phys": ("gamma_t", "damping"),
    "u0x_phys": ("u0x", "velocity"),     # m/s
    "u0y_phys": ("u0y", "velocity"),
    "uw_west_phys": ("uw_west", "velocity"),
    "uw_east_phys": ("uw_east", "velocity"),
    "uw_south_phys": ("uw_south", "velocity"),
    "uw_north_phys": ("uw_north", "velocity"),
    "u_inlet_phys": ("u_inlet", "velocity"),
    "rho_outlet_phys": ("rho_outlet", "density"),  # kg/m^3
    "t_end_phys": ("steps", "time"),         # s -> step count
    "out_interval_phys": ("out_interval", "time"),
}


def _convert_phys(phys: dict, kw: dict) -> dict:
    """Fold `*_phys` deck keys into lattice-unit SimConfig kwargs."""
    from lbmdem_tpu_torch.units import UnitSystem

    base = {k: phys.pop(k, None) for k in ("dx", "dt_phys", "rho_phys")}
    if phys and any(v is None for v in base.values()):
        missing = [k for k, v in base.items() if v is None]
        raise ValueError(
            f"physical-units keywords {sorted(phys)} require base scales "
            f"{missing} in the same deck"
        )
    if all(v is None for v in base.values()):
        return kw
    if any(v is None for v in base.values()):
        missing = [k for k, v in base.items() if v is None]
        raise ValueError(f"physical base scales incomplete: missing {missing}")
    us = UnitSystem(dx=base["dx"], dt=base["dt_phys"], rho0=base["rho_phys"])
    kw["phys_dx"], kw["phys_dt"], kw["phys_rho"] = us.dx, us.dt, us.rho0
    for key, val in phys.items():
        field, kind = _PHYS_KEYS[key]
        if kind == "nu":
            kw[field] = 3.0 * us.nu_to_lattice(val) + 0.5
        elif kind == "accel":
            kw[field] = us.accel_to_lattice(val)
        elif kind == "density":
            kw[field] = us.density_to_lattice(val)
        elif kind == "stiffness":
            kw[field] = val / us.stiffness_scale
        elif kind == "damping":
            kw[field] = val / us.damping_scale
        elif kind == "velocity":
            kw[field] = us.velocity_to_lattice(val)
        elif kind == "time":
            kw[field] = int(round(us.time_to_lattice(val)))
    return kw


def load_param_file(path: str) -> Tuple[SimConfig, Optional[str]]:
    """Parse a reference-style keyword parameter file.

    Returns (config, particle_file_path_or_None). The particle file path
    is resolved relative to the parameter file's directory. Decks may be
    written in lattice units (bare keywords) or SI (`dx dt_phys rho_phys`
    base scales plus `*_phys` keywords; see _PHYS_KEYS) - mixing is
    allowed, `*_phys` wins over its lattice twin only if both appear
    because conversion happens after parsing.
    """
    import os

    kw = {}
    bc = {}
    phys = {}
    particles = None
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key, vals = parts[0].lower(), parts[1:]
            if key == "bc":
                if len(vals) != 2 or vals[0] not in _SIDES:
                    raise ValueError(f"bad bc line: {raw!r}")
                bc[f"bc_{vals[0]}"] = vals[1]
            elif key == "particles":
                particles = os.path.join(os.path.dirname(os.path.abspath(path)), vals[0])
            elif key == "nu":
                kw["tau"] = 3.0 * float(vals[0]) + 0.5
            elif key == "dtype":
                kw["dtype"] = vals[0]
            elif key == "f_storage":
                kw["f_storage"] = vals[0]
            elif key in ("dx", "dt_phys", "rho_phys") or key in _PHYS_KEYS:
                phys[key] = float(vals[0])
            elif key in ("nx", "ny", "steps", "out_interval", "n_sub",
                         "eps_samples", "window", "max_disks",
                         "coupling_k"):
                kw[key] = int(float(vals[0]))
            elif key == "buoyancy":
                kw[key] = bool(int(vals[0]))
            elif key == "paranoia":
                # `paranoia 1` = per-step, `paranoia chunk` = validate
                # at kernel-chunk granularity (keeps fast structures)
                kw[key] = (vals[0] if vals[0] in ("step", "chunk")
                           else bool(int(vals[0])))
            elif key == "collision":
                kw["collision"] = vals[0]
            elif key == "eps_method":
                kw["eps_method"] = vals[0]
            elif key == "nt_mode":
                kw["nt_mode"] = vals[0]
            elif key == "inlet_profile":
                kw["inlet_profile"] = vals[0]
            elif key in ("tau", "gx", "gy", "kn", "kt", "gamma_n", "gamma_t",
                         "mu", "rho_s", "g_px", "g_py", "smagorinsky",
                         "trt_magic", "rho0", "u0x", "u0y", "uw_west",
                         "uw_east", "uw_south", "uw_north",
                         "u_inlet", "rho_outlet", "eps_r_shift"):
                kw[key] = float(vals[0])
            else:
                raise ValueError(f"unknown parameter keyword {key!r}")
    kw = _convert_phys(phys, kw)
    return SimConfig(**kw, **bc), particles


def load_particle_file(path: str, units=None) -> list[DiskSpec]:
    """Parse a particle list file:
    `x y r [vx vy omega [fixed [rho_s]]]` per line (`fixed` = 0/1 marks
    an infinite-mass obstacle disk; `rho_s` = per-disk solid density,
    0 = the deck's global rho_s - see DiskSpec).

    With `units` (a UnitSystem, e.g. `cfg.units` of an SI deck) the file
    is read as SI — x/y/r in m, vx/vy in m/s, omega in rad/s, rho_s in
    kg/m^3 — and converted to lattice units.
    """
    disks = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            v = [float(t) for t in line.split()]
            if len(v) not in (3, 6, 7, 8):
                raise ValueError(f"bad particle line: {raw!r}")
            rho_s = v.pop() if len(v) == 8 else 0.0
            fixed = bool(v.pop()) if len(v) == 7 else False
            if units is not None:
                v[0:3] = [q / units.dx for q in v[0:3]]
                if len(v) == 6:
                    v[3] /= units.velocity_scale
                    v[4] /= units.velocity_scale
                    v[5] *= units.dt  # rad/s -> rad/step
                if rho_s:
                    rho_s = units.density_to_lattice(rho_s)
            disks.append(DiskSpec(*v, fixed=fixed, rho_s=rho_s))
    return disks


def save_particle_file(path: str, disks: Sequence[DiskSpec]) -> None:
    if any(d.rho_s for d in disks):
        with open(path, "w") as fh:
            fh.write("# x y r vx vy omega fixed rho_s\n")
            for d in disks:
                fh.write(f"{d.x} {d.y} {d.r} {d.vx} {d.vy} {d.omega} "
                         f"{int(d.fixed)} {d.rho_s}\n")
        return
    if any(d.fixed for d in disks):
        with open(path, "w") as fh:
            fh.write("# x y r vx vy omega fixed\n")
            for d in disks:
                fh.write(f"{d.x} {d.y} {d.r} {d.vx} {d.vy} {d.omega} "
                         f"{int(d.fixed)}\n")
        return
    with open(path, "w") as fh:
        fh.write("# x y r vx vy omega\n")
        for d in disks:
            fh.write(f"{d.x} {d.y} {d.r} {d.vx} {d.vy} {d.omega}\n")
