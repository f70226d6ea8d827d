"""One file per hand-written kernel of the program: the pattern that
finds its device records in a trace, and the work one call needs.

Each module K<n>.py holds

    MATCH  a regular expression that a record of the kernel's first
           launch matches (the call is counted once, at that launch)
    WITH   patterns of the call's further launches, counted to it where
           the last call seen of a kernel without AFTER was this one
    AFTER  None, or the kernels one of which must be the last call seen
           of a kernel without AFTER (two kernels that share one CUDA
           function are told apart by what runs before them)
    per_call(g, k) -> (bytes, operations) of one call that advances k
           steps, from the cell's geometry g (`roofline.geometry`)

Bytes count each input read once and each output written once, from
the shapes and the storage dtype: never the buffers a wrapper happens
to take. Operations count float32 arithmetic of the formulas at the
inputs given (frozen constants of `chip_smoke.py` at commit caccc23).
A kernel that is added to the program gets a file here; none is
edited.
"""

# float32 operations per cell and step: the pure-fluid collide (BGK with
# a body force, the pair form), the NT-blended collide at a cell with
# coverage and on its fluid branch
FLOPS_FLUID = 130
FLOPS_NT = 350
FLOPS_NT_FLUID = 180
# the pair law of one disk-disk or disk-wall evaluation, and one
# velocity-Verlet update of one disk
FLOPS_PAIR = 60
FLOPS_VERLET = 20


def cov_flops(g: dict) -> float:
    """Operations of every disk's window under the sample coverage (6
    per sample test, ns^2 tests per cell) and ~12 to weight and sum its
    share, per window cell."""
    return g["n_disks"] * g["window"] ** 2 * (6 * g["eps_samples"] ** 2 + 12)


def collide_flops(g: dict) -> float:
    """One NT collide step over the lattice at the start's coverage."""
    s = g["solid_cells"]
    return FLOPS_NT * s + FLOPS_NT_FLUID * (g["cells"] - s)


def dem_flops(g: dict) -> float:
    """One DEM step: n_sub + 1 force evaluations over the neighbour
    pairs (directed, surface gap within the skin) and the walls, and
    n_sub velocity-Verlet updates."""
    evals = g["pairs"] + g["n_disks"] * g["walls"]
    return ((g["n_sub"] + 1) * evals * FLOPS_PAIR
            + g["n_sub"] * g["n_disks"] * FLOPS_VERLET)
