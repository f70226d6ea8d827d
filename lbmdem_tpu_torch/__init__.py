"""lbmdem_tpu_torch: the coupled 2D LBM-DEM solver ported to PyTorch,
with hand-written CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

The JAX package `lbmdem_tpu` is the reference this port is held
against; this package imports `torch` and numpy, never JAX. On CUDA
tensors the kernels run as CUDA C++ built from `csrc/` at first use; on
CPU tensors each takes its plain PyTorch version. `Simulation(...,
use_kernels=False)` takes the plain path (the JAX package's
use_pallas=False) on either device: float64, lattices the stamp tiles
cannot take, coupled scenes without disks. Paranoid mode raises
SimulationDiverged at the first failing step. The user's entry point is
the CLI, `python -m lbmdem_tpu_torch.cli run.par --out out/`, with
checkpoints, metrics, VTK output and profiling in `utils/`. `parallel/`
shards the lattice over a mesh of devices in one process
(`Simulation(..., mesh=parallel.make_mesh(...))`, the CLI's --mesh YxX)
or across processes (`parallel.init_distributed`, the CLI's
--distributed).

    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse
    sim = Simulation(*column_collapse(), device="cuda")
    sim.run(100)
"""

from lbmdem_tpu_torch.config import (DiskSpec, SimConfig, load_param_file,
                                     load_particle_file)
from lbmdem_tpu_torch.ops.dem import DiskState
from lbmdem_tpu_torch.simulation import (FluidState, SimState, Simulation,
                                         SimulationDiverged)

__all__ = [
    "SimConfig",
    "DiskSpec",
    "load_param_file",
    "load_particle_file",
    "Simulation",
    "SimulationDiverged",
    "SimState",
    "FluidState",
    "DiskState",
]
