"""Multi-process launch: the counterpart of the JAX package's
`lbmdem_tpu/parallel/launch.py` (`jax.distributed.initialize`). Its port
runs one process per card on `torch.distributed` (NCCL) and is not done
yet: both entry points raise naming the ROADMAP.md item. A mesh in one
process (`make_mesh`, `Simulation(mesh=...)`) needs neither."""

from __future__ import annotations

from lbmdem_tpu_torch.ops import not_ported


def init_distributed(*args, **kwargs) -> None:
    """Multi-process initialisation (not ported)."""
    raise not_ported("multi-process runs (parallel/launch.py on "
                     "torch.distributed)", 12)


def process_info(*args, **kwargs):
    """(process id, process count, local and global devices) of a
    multi-process run (not ported)."""
    raise not_ported("multi-process runs (parallel/launch.py on "
                     "torch.distributed)", 12)
