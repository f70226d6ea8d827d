"""glue_ms_per_step: device milliseconds per step of every record that
is none of the hand-written kernels of bench_gpu/work/ (the coupled
step's PyTorch glue: binning checks, gathers, slab build and unslab)."""


def read(ctx):
    return 1e3 * ctx.trace.glue_s / ctx.trace.steps
