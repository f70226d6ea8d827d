"""K6, the coupled block (`ops/fused_lbm.fused_step_imb_reduce_multi` ->
`csrc/imb_multi.cu`, `csrc/tblock.cuh`): k coupled steps per call over
one solid stack; reads f, the solid stack and each disk's x, y, r,
writes f and k steps' force and torque per disk. Its row sweep, then
the prefix and the reduce."""

from bench_gpu.work import collide_flops, cov_flops

MATCH = r"temporal_block_kernel<.*NTCell<.*WSteps"
WITH = (r"slot_offsets_kernel", r"reduce_kernel<")
AFTER = None


def per_call(g: dict, k: int):
    moved = (2 * 9 * g["cells"] * g["f_bytes"] + 3 * g["cells"] * 4
             + g["n_disks"] * 3 * 4 + k * g["n_disks"] * 3 * 4)
    return moved, k * (collide_flops(g) + cov_flops(g))
