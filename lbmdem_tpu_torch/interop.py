"""State across the two packages, as plain numpy.

The numpy form uses the JAX `SimState`/`DiskState` field names:

    {"f": (9, ny, nx), "disks": {"x": (N, 2), "v", "theta", "omega",
     "r", "mass", "inertia", "active", "mobile", "ct_j", "ct_xi",
     "wall_xi"}, "step": int, "overflow": int, "n_contacts": int,
     "fail_step": int}

so a JAX state converts field by field (`np.asarray` of each leaf) and
loads with `Simulation.load_state`; a JAX `SimConfig` crosses over as
`SimConfig(**dataclasses.asdict(jax_cfg))`.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmdem_tpu_torch.ops.dem import DiskState
from lbmdem_tpu_torch.simulation import SimState

_COUNTERS = ("step", "overflow", "n_contacts", "fail_step")


def state_from_numpy(d: dict, device="cpu") -> SimState:
    """SimState on `device` from the numpy form (fail_step defaults to
    -1 when absent or None)."""
    disks = DiskState(**{
        k: torch.as_tensor(np.array(d["disks"][k]), device=device)
        for k in DiskState._fields
    })
    counters = {}
    for k in _COUNTERS:
        v = d.get(k)
        v = -1 if (v is None and k == "fail_step") else int(v)
        counters[k] = torch.full((), v, dtype=torch.int32, device=device)
    return SimState(f=torch.as_tensor(np.array(d["f"]), device=device),
                    disks=disks, **counters)


def state_to_numpy(state: SimState) -> dict:
    """The numpy form of a SimState."""
    return {
        "f": state.f.cpu().numpy(),
        "disks": {k: v.cpu().numpy() for k, v in state.disks._asdict().items()},
        **{k: int(getattr(state, k)) for k in _COUNTERS},
    }
