"""K2, the fused coupled step (`ops/fused_lbm.fused_step_imb_reduce` ->
`csrc/imb_reduce.cu`): one coupled step per call; reads f, the solid
stack and each disk's x, y, r, writes f and each disk's force and
torque. Its step, then the prefix and the reduce."""

from bench_gpu.work import collide_flops, cov_flops

MATCH = r"coupled_step_kernel<"
WITH = (r"slot_offsets_kernel", r"reduce_kernel<")
AFTER = None


def per_call(g: dict, k: int):
    moved = (2 * 9 * g["cells"] * g["f_bytes"] + 3 * g["cells"] * 4
             + g["n_disks"] * 3 * 4 + g["n_disks"] * 3 * 4)
    return moved, collide_flops(g) + cov_flops(g)
