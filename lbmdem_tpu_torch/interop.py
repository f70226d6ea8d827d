"""State across the two packages, as plain numpy.

The numpy form uses the JAX `SimState`/`DiskState` field names:

    {"f": (9, ny, nx), "f_dtype": "float32" | "float64" | "bfloat16",
     "disks": {"x": (N, 2), "v", "theta", "omega", "r", "mass",
     "inertia", "active", "mobile", "ct_j", "ct_xi", "wall_xi"},
     "step": int, "overflow": int, "n_contacts": int, "fail_step": int}

so a JAX state converts field by field (`np.asarray` of each leaf) and
loads with `Simulation.load_state`; a JAX `SimConfig` crosses over as
`SimConfig(**dataclasses.asdict(jax_cfg))`.

bfloat16 f (`f_storage="bfloat16"`, the shifted populations) has no
numpy dtype of its own: `state_to_numpy` writes its uint16 bit pattern
with `"f_dtype": "bfloat16"`, which is lossless and needs no extra
package. `state_from_numpy` takes that form, or an array whose dtype is
named "bfloat16" (`ml_dtypes.bfloat16`, what `np.asarray` of a JAX bf16
state gives), and returns a `torch.bfloat16` f.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch.ops.dem import DiskState
from lbmdem_tpu_torch.simulation import SimState

_COUNTERS = ("step", "overflow", "n_contacts", "fail_step")


def _f_from_numpy(d: dict, device) -> torch.Tensor:
    a = np.asarray(d["f"])
    if a.dtype.name == "bfloat16" or d.get("f_dtype") == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.as_tensor(np.array(a), device=device)


def state_from_numpy(d: dict, device="cuda") -> SimState:
    """SimState on `device` from the numpy form (fail_step defaults to
    -1 when absent or None). The state goes to the card unless it is
    asked for the CPU, as `Simulation` does; without a card the default
    raises RuntimeError."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "state_from_numpy: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "load the state on the CPU")
    disks = DiskState(**{
        k: torch.as_tensor(np.array(d["disks"][k]), device=device)
        for k in DiskState._fields
    })
    counters = {}
    for k in _COUNTERS:
        v = d.get(k)
        v = -1 if (v is None and k == "fail_step") else int(v)
        counters[k] = torch.full((), v, dtype=torch.int32, device=device)
    return SimState(f=_f_from_numpy(d, device), disks=disks, **counters)


def mesh_state_from_numpy(d: dict, mesh):
    """A MeshState on `mesh` (parallel.make_mesh) from the numpy form:
    the state is built on the CPU and each rank takes its own shards onto
    its devices (`parallel.shard_state`), so nothing of another rank's
    shards reaches a card. A JAX state crosses onto a mesh of the port,
    one process or several, this way."""
    from lbmdem_tpu_torch.parallel import shard_state

    return shard_state(state_from_numpy(d, "cpu"), mesh)


def state_to_numpy(state: SimState) -> dict:
    """The numpy form of a SimState."""
    f = state.f.cpu()
    if f.dtype == torch.bfloat16:
        f_np = f.view(torch.int16).numpy().view(np.uint16)
    else:
        f_np = f.numpy()
    return {
        "f": f_np,
        "f_dtype": str(f.dtype).removeprefix("torch."),
        "disks": {k: v.cpu().numpy() for k, v in state.disks._asdict().items()},
        **{k: int(getattr(state, k)) for k in _COUNTERS},
    }
