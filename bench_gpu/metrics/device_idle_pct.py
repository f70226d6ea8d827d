"""device_idle_pct: the share of the traced window in which no
operation ran on the card (1 - union of the device records' intervals
/ the window's host-clock length), in percent."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
