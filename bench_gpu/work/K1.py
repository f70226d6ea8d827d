"""K1, the stamp (`ops/stamp.stamp_fields` -> `csrc/stamp.cu`): reads
each disk's x, y, v, omega and r, writes the solid stack (eps_raw and
the two solid velocity planes) over the whole lattice."""

from bench_gpu.work import cov_flops

MATCH = r"stamp_kernel<"
WITH = ()
AFTER = None


def per_call(g: dict, k: int):
    return 3 * g["cells"] * 4 + g["n_disks"] * 6 * 4, cov_flops(g)
