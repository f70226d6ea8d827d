r"""D2Q9 lattice model constants (SURVEY.md SS2 C1).

A verbatim copy of the JAX package's `lbmdem_tpu/lattice.py` (that
package imports JAX on import, so the port carries its own copy).

The nine discrete velocities, quadrature weights, the speed of sound,
and the opposite-direction table. Index convention (standard D2Q9):

      6   2   5
        \ | /
      3 - 0 - 1        e_0 = ( 0, 0)   w_0 = 4/9
        / | \          e_1..4 = axis   w   = 1/9
      7   4   8        e_5..8 = diag   w   = 1/36

Arrays are plain numpy so they are compile-time constants inside jit /
Pallas kernels (baked into the program, never traced).

Lattice-unit conventions used across the framework:
- dx = dt = 1, cs^2 = 1/3, kinematic viscosity nu = cs^2 (tau - 1/2).
- Fluid arrays are indexed [i, y, x]; cell (iy, ix) has its center at
  coordinate (x=ix, y=iy). Domain walls sit half a link outside the
  outermost cell centers, i.e. at -0.5 and n-0.5 (half-way bounce-back).
"""

from __future__ import annotations

import numpy as np

Q = 9
D = 2

# Discrete velocities e[i] = (ex, ey).
E = np.array(
    [
        [0, 0],
        [1, 0],
        [0, 1],
        [-1, 0],
        [0, -1],
        [1, 1],
        [-1, 1],
        [-1, -1],
        [1, -1],
    ],
    dtype=np.int32,
)
EX = E[:, 0].astype(np.float32)
EY = E[:, 1].astype(np.float32)

# Quadrature weights.
W = np.array(
    [4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36],
    dtype=np.float64,
)

# OPP[i] is the index of -e_i (bounce-back partner).
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Speed of sound squared and its inverse (cs^2 = 1/3 for D2Q9).
CS2 = 1.0 / 3.0
INV_CS2 = 3.0
INV_CS4 = 9.0

# Direction index groups, useful for boundary handling. "IN_*" lists the
# populations with a velocity component pointing in that direction.
IN_E = np.array([1, 5, 8], dtype=np.int32)  # ex = +1
IN_W = np.array([3, 6, 7], dtype=np.int32)  # ex = -1
IN_N = np.array([2, 5, 6], dtype=np.int32)  # ey = +1
IN_S = np.array([4, 7, 8], dtype=np.int32)  # ey = -1


def nu_from_tau(tau: float) -> float:
    """Kinematic viscosity (lattice units) from the BGK relaxation time."""
    return CS2 * (tau - 0.5)


def tau_from_nu(nu: float) -> float:
    """BGK relaxation time from kinematic viscosity (lattice units)."""
    return INV_CS2 * nu + 0.5


def wall_corr(i: int, uwx: float, uwy: float, rho0: float) -> float:
    """Half-way MOVING-wall bounce-back correction (C6):
    f_i(x_b, t+1) = f_opp^post(x_b, t) + 6 w_i rho0 (e_i . u_w),
    with rho_w approximated by the reference density rho0. 0.0 for
    resting walls. The single definition shared by the oracle
    (ops/lbm.apply_bounce_back), the fused kernels and the sharded
    edge fixups - the formula must never diverge between them."""
    return (6.0 * float(W[i]) * rho0
            * (float(E[i, 0]) * uwx + float(E[i, 1]) * uwy))
