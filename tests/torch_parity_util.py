"""Shared helpers of the PyTorch-port parity tests: move configs, disks
and states between the JAX package and lbmdem_tpu_torch as numpy, and
make seeded inputs both packages consume."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import lbmdem_tpu.config as jconfig
import lbmdem_tpu_torch.config as tconfig

# tier-1 runs several xdist workers: keep each one's intra-op pool small
torch.set_num_threads(2)

DTYPES = ("float32", "float64")
TORCH_DT = {"float32": torch.float32, "float64": torch.float64}


def to_torch_cfg(cfg: jconfig.SimConfig) -> tconfig.SimConfig:
    return tconfig.SimConfig(**dataclasses.asdict(cfg))


def to_torch_disks(specs):
    return [tconfig.DiskSpec(**dataclasses.asdict(d)) for d in specs]


def jx(a, dtype=None):
    """numpy/torch -> jnp."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return jnp.asarray(np.asarray(a), dtype)


def tt(a, dtype=None):
    """jnp/numpy -> CPU torch tensor."""
    t = torch.as_tensor(np.array(a))
    return t.to(dtype) if dtype is not None else t


def npy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def jax_state_to_numpy(state) -> dict:
    """A JAX SimState in the numpy form of lbmdem_tpu_torch.interop."""
    return {
        "f": np.asarray(state.f),
        "disks": {k: np.asarray(v) for k, v in state.disks._asdict().items()},
        "step": int(state.step), "overflow": int(state.overflow),
        "n_contacts": int(state.n_contacts),
        "fail_step": None if state.fail_step is None else int(state.fail_step),
    }


def random_disks(n, nx, ny, seed, r_lo=2.0, r_hi=4.0, margin=1.0,
                 n_inactive=0):
    """Seeded disk arrays (numpy): x (n, 2), v (n, 2), omega, r, active."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(margin, nx - margin, n),
                  rng.uniform(margin, ny - margin, n)], 1)
    v = rng.uniform(-0.05, 0.05, (n, 2))
    om = rng.uniform(-0.01, 0.01, n)
    r = rng.uniform(r_lo, r_hi, n)
    act = np.r_[np.ones(n - n_inactive, bool), np.zeros(n_inactive, bool)]
    return x, v, om, r, act


def perturbed_f(shape, seed, dtype, amp=0.02):
    """Equilibrium-at-rest populations with seeded multiplicative noise."""
    from lbmdem_tpu_torch import lattice

    rng = np.random.default_rng(seed)
    w = lattice.W[:, None, None]
    return (w * (1.0 + amp * rng.standard_normal(shape))).astype(dtype)

