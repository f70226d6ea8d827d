"""K1_roofline: K1's share of its roofline in the traced window, in
percent (bench_gpu/roofline.py; its work in bench_gpu/work/K1.py)."""

from bench_gpu import roofline


def read(ctx):
    return roofline.share(ctx, "K1")
