"""step_mfu: the whole step's share of the chip's peaks, in percent:
the least time the published peaks need for the work of every
hand-written kernel call of the traced window, over the window's
host-clock length (bench_gpu/roofline.step_share)."""

from bench_gpu import roofline


def read(ctx):
    return roofline.step_share(ctx)
