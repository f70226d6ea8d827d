"""launches_per_step: device records (kernels, copies, sets) of the
traced window per LBM step the window completed."""


def read(ctx):
    return ctx.trace.records / ctx.trace.steps
