"""Physical <-> lattice unit conversion (SURVEY.md SS2 C17).

A copy of the JAX package's `lbmdem_tpu/units.py`.

The solver works internally in lattice units (dx = dt = rho0 = 1). A
`UnitSystem` pins the three base scales and derives every quantity the
framework needs. This replaces the reference's C unit-scaling helpers
with an explicit, testable converter.

    us = UnitSystem(dx=1e-4, dt=1e-6, rho0=1000.0)
    tau = lattice.tau_from_nu(us.nu_to_lattice(1e-6))
    g_lat = us.accel_to_lattice(9.81)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UnitSystem:
    """Base scales: dx [m / lattice spacing], dt [s / step], rho0 [kg/m^3]."""

    dx: float = 1.0
    dt: float = 1.0
    rho0: float = 1.0

    # --- derived scales (physical units per lattice unit) ---
    @property
    def velocity_scale(self) -> float:
        return self.dx / self.dt

    @property
    def accel_scale(self) -> float:
        return self.dx / self.dt**2

    @property
    def nu_scale(self) -> float:
        return self.dx**2 / self.dt

    @property
    def mass_scale(self) -> float:
        # 2D code: "mass" is per unit depth -> rho0 * dx^2 per lattice cell
        # for an areal density; we keep full 3D-consistent mass with unit
        # depth dx: rho0 * dx^3.
        return self.rho0 * self.dx**3

    @property
    def force_scale(self) -> float:
        return self.mass_scale * self.accel_scale

    @property
    def torque_scale(self) -> float:
        return self.force_scale * self.dx

    @property
    def pressure_scale(self) -> float:
        return self.rho0 * self.velocity_scale**2

    @property
    def stiffness_scale(self) -> float:
        # contact spring k [N/m]: force per overlap length
        return self.force_scale / self.dx

    @property
    def damping_scale(self) -> float:
        # contact dashpot gamma [N s/m]: force per relative velocity
        return self.force_scale / self.velocity_scale

    # --- physical -> lattice ---
    def length_to_lattice(self, x: float) -> float:
        return x / self.dx

    def time_to_lattice(self, t: float) -> float:
        return t / self.dt

    def velocity_to_lattice(self, u: float) -> float:
        return u / self.velocity_scale

    def accel_to_lattice(self, a: float) -> float:
        return a / self.accel_scale

    def nu_to_lattice(self, nu: float) -> float:
        return nu / self.nu_scale

    def density_to_lattice(self, rho: float) -> float:
        return rho / self.rho0

    # --- lattice -> physical ---
    def length_from_lattice(self, x: float) -> float:
        return x * self.dx

    def time_from_lattice(self, t: float) -> float:
        return t * self.dt

    def velocity_from_lattice(self, u: float) -> float:
        return u * self.velocity_scale

    def force_from_lattice(self, f: float) -> float:
        return f * self.force_scale

    def pressure_from_lattice(self, p: float) -> float:
        return p * self.pressure_scale
