"""K7, the static coupled block (`ops/fused_static.
fused_step_imb_static_multi` -> `csrc/imb_static.cu`, `csrc/tblock.cuh`):
k coupled steps per call over the solid stack of a bed of fixed disks at
rest, stamped once by K1 before the run; reads f and the solid stack
once, writes f. No coverage work (the stamp is K1's) and no reduce (no
force feeds back)."""

from bench_gpu.work import collide_flops

MATCH = r"temporal_block_kernel<.*NTCell<.*NoSink"
WITH = ()
AFTER = None


def per_call(g: dict, k: int):
    return (2 * 9 * g["cells"] * g["f_bytes"] + 3 * g["cells"] * 4,
            k * collide_flops(g))
