"""Checkpoint / resume in the JAX package's format
(`lbmdem_tpu/utils/checkpoint.py`), so that a checkpoint written by
either package restores in the other.

One .npz holds the SimState's leaves as `leaf_0` ... `leaf_16`, in the
order `jax.tree.flatten` gives a JAX SimState: f, the DiskState fields in
order, then step, overflow, n_contacts, fail_step. bfloat16 f widens to
float32 on save (exact); `__meta__` (JSON) holds the magic, the leaf
count, the original dtype names and the config. The write goes to a
temporary file that is renamed into place.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from lbmdem_tpu_torch.ops.dem import DiskState
from lbmdem_tpu_torch.simulation import SimState

_MAGIC = "lbmdem_tpu_ckpt_v1"


def _leaves(state: SimState) -> list:
    return [state.f, *state.disks, state.step, state.overflow,
            state.n_contacts, state.fail_step]


def _from_leaves(leaves: list) -> SimState:
    nd = len(DiskState._fields)
    return SimState(leaves[0], DiskState(*leaves[1:1 + nd]), *leaves[1 + nd:])


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy name of a tensor's dtype ("bfloat16" included)."""
    return str(t.dtype).removeprefix("torch.")


def to_host(state: SimState) -> SimState:
    """A copy of the state on the CPU, safe to hand to a writer thread
    while the run goes on (the next steps overwrite the f buffers)."""
    return _from_leaves([t.to("cpu", copy=True) for t in _leaves(state)])


def save_state(path: str, state: SimState, cfg=None) -> None:
    """Write `state` (on any device) and, if given, its config."""
    leaves = _leaves(state)

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        # numpy has no bfloat16: widen to float32 (exact); load_state
        # casts back through the template
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    meta = {
        "magic": _MAGIC,
        "n_leaves": len(leaves),
        # original (pre-widening) dtypes: load_state refuses to cast
        # across a real dtype change (a float32-storage checkpoint
        # resumed into a bf16-storage run would reinterpret physical f as
        # shifted g)
        "dtypes": [_dtype_name(t) for t in leaves],
    }
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"  # atomic write: tmp + rename
    np.savez(tmp, __meta__=np.asarray(json.dumps(meta)),
             **{f"leaf_{i}": host(t) for i, t in enumerate(leaves)})
    os.replace(tmp, path)


def load_state(path: str, like: SimState) -> SimState:
    """Restore into the structure, dtypes and device of `like` (a
    SimState template, e.g. a fresh Simulation's state). Raises
    ValueError on a leaf count, shape or dtype change."""
    with np.load(path, allow_pickle=False) as z:
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
    template = _leaves(like)
    if len(leaves) != len(template):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, state needs "
            f"{len(template)} - the checkpoint was written by a different "
            f"framework version (the SimState/DiskState pytree gained or "
            f"lost fields, e.g. DiskState.mobile); re-create the state from "
            f"the deck and copy fields over manually to migrate")
    orig_dtypes = meta.get("dtypes") or [a.dtype.name for a in leaves]
    for got, want, odt in zip(leaves, template, orig_dtypes):
        if got.shape != tuple(want.shape):
            raise ValueError(
                f"checkpoint leaf shape {got.shape} != state "
                f"{tuple(want.shape)} (different lattice/disk capacity?)")
        if odt != _dtype_name(want):
            raise ValueError(
                f"checkpoint leaf dtype {odt} != state {_dtype_name(want)} - "
                f"resuming across an f_storage/dtype change would silently "
                f"reinterpret the data (convert explicitly instead)")
    # the only cast here undoes save_state's bf16 -> f32 widening
    return _from_leaves([
        torch.from_numpy(np.array(a)).to(device=w.device, dtype=w.dtype)
        for a, w in zip(leaves, template)])
