"""K3, the slab DEM subcycle (`ops/slab_dem.subcycle_slabs` ->
`csrc/slab_dem.cu`) after a K2 step: one LBM step of disk motion;
reads each disk's x, v, theta, omega, r, mass, inertia and hydrodynamic
force and torque, writes x, v, theta and omega."""

from bench_gpu.work import dem_flops

MATCH = r"subcycle_kernel<"
WITH = ()
AFTER = ("K2",)


def per_call(g: dict, k: int):
    return g["n_disks"] * (12 + 6) * 4, dem_flops(g)
