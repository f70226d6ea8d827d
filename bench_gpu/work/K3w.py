"""K3w, the window DEM subcycle (`ops/slab_dem.subcycle_slabs_window` ->
`csrc/slab_dem.cu`, the CUDA function K3 launches) after a K6 pass: one
inner step of disk motion per call, K3's inputs and outputs."""

from bench_gpu.work import dem_flops

MATCH = r"subcycle_kernel<"
WITH = ()
AFTER = ("K6",)


def per_call(g: dict, k: int):
    return g["n_disks"] * (12 + 6) * 4, dem_flops(g)
