"""static_stamps: the solid stacks that the program's static hoist
stamped in this process, set-up and window together (the program's
counter `profiling.counters()["static_stamps"]`): 1 where the hoist
keeps its one stamp, more where a call stamps again. None where the
program has no such counter."""

from lbmdem_tpu_torch.utils import profiling


def read(ctx):
    return profiling.counters().get("static_stamps")
