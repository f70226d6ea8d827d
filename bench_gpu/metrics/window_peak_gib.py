"""window_peak_gib: the most device memory that PyTorch's allocator held
in the window alone, in GiB (the peak is reset after set-up): the
state, the spare f buffer and each step's temporaries, which the
set-up's larger peak in peak_mem_gib hides."""


def read(ctx):
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
