"""K5, the pure-fluid row sweep (`ops/fused_fluid.fused_step_fluid_multi`
-> `csrc/fluid.cu`, `csrc/tblock.cuh`): k steps per call; reads and
writes f once."""

from bench_gpu.work import FLOPS_FLUID

MATCH = r"temporal_block_kernel<.*FluidCell<"
WITH = ()
AFTER = None


def per_call(g: dict, k: int):
    return 2 * 9 * g["cells"] * g["f_bytes"], k * FLOPS_FLUID * g["cells"]
