"""lbmdem_tpu_torch: the coupled 2D LBM-DEM solver ported to PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

The JAX package `lbmdem_tpu` is the reference this port is held
against; this package imports `torch` and numpy, never JAX. On CUDA
tensors the main path's three kernels run as CUDA C++ built from
`csrc/` at first use; on CPU tensors each takes its plain PyTorch
version.

    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse
    sim = Simulation(*column_collapse(), device="cuda")
    sim.run(100)
"""

from lbmdem_tpu_torch.config import (DiskSpec, SimConfig, load_param_file,
                                     load_particle_file)
from lbmdem_tpu_torch.ops.dem import DiskState
from lbmdem_tpu_torch.simulation import SimState, Simulation

__all__ = [
    "SimConfig",
    "DiskSpec",
    "load_param_file",
    "load_particle_file",
    "Simulation",
    "SimState",
    "DiskState",
]
