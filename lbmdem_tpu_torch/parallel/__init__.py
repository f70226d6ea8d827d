"""The lattice mesh: the lattice sharded over a ('y', 'x') grid of
devices, in one process or across the processes of a torch.distributed
group, with a halo exchange between shards, the walls and Zou/He
closures on the shards that hold a global edge, one sum of each disk's
force and torque over the shards, and the DEM replicated per device.
Counterpart of the JAX package's `lbmdem_tpu/parallel/`."""

from lbmdem_tpu_torch.parallel.launch import (init_distributed,
                                              local_devices, process_info)
from lbmdem_tpu_torch.parallel.sharding import (
    Mesh,
    MeshState,
    make_mesh,
    make_sharded_step,
    shard_state,
    unshard,
)

__all__ = [
    "Mesh",
    "MeshState",
    "init_distributed",
    "local_devices",
    "make_mesh",
    "make_sharded_step",
    "process_info",
    "shard_state",
    "unshard",
]
