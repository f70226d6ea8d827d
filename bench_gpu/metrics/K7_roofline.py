"""K7_roofline: K7's share of its roofline in the traced window, in
percent (bench_gpu/roofline.py; its work in bench_gpu/work/K7.py)."""

from bench_gpu import roofline


def read(ctx):
    return roofline.share(ctx, "K7")
