"""Carry a plasma, 3-D plasma or cavity state between the JAX package and
the port as numpy.

state_from_numpy takes the JAX package's PlasmaState as numpy arrays (a
mapping with f, g, Ex, Ey, phi, step) and returns the port's PlasmaState on
`device`; state_to_numpy goes the other way. cavity_state_from_numpy and
cavity_state_to_numpy do the same for a CavityState (f, rho, ux, uy,
step), and plasma3d_state_from_numpy and plasma3d_state_to_numpy for a
Plasma3DState (f, g, Ex, Ey, Ez, phi, step). bfloat16 crosses as raw bits:
numpy has no bfloat16 of its own, so the numpy side uses ml_dtypes'
(the type JAX hands out), imported only when a bf16 array crosses.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .models.cavity import CavityState
from .models.plasma import PlasmaState
from .models.plasma3d import Plasma3DState

_FIELDS = ("f", "g", "Ex", "Ey", "phi")
_FIELDS_3D = ("f", "g", "Ex", "Ey", "Ez", "phi")
_CAVITY_FIELDS = ("f", "rho", "ux", "uy")


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)   # a writable contiguous copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_from_numpy(arrays: Mapping[str, np.ndarray], device) -> PlasmaState:
    return PlasmaState(
        **{k: tensor_from_numpy(arrays[k], device) for k in _FIELDS},
        step=int(arrays["step"]))


def state_to_numpy(state: PlasmaState) -> Dict[str, np.ndarray]:
    out = {k: tensor_to_numpy(getattr(state, k)) for k in _FIELDS}
    out["step"] = np.asarray(state.step, np.int32)
    return out


def cavity_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device) -> CavityState:
    return CavityState(
        **{k: tensor_from_numpy(arrays[k], device) for k in _CAVITY_FIELDS},
        step=int(arrays["step"]))


def cavity_state_to_numpy(state: CavityState) -> Dict[str, np.ndarray]:
    out = {k: tensor_to_numpy(getattr(state, k)) for k in _CAVITY_FIELDS}
    out["step"] = np.asarray(state.step, np.int32)
    return out


def plasma3d_state_from_numpy(arrays: Mapping[str, np.ndarray],
                              device) -> Plasma3DState:
    return Plasma3DState(
        **{k: tensor_from_numpy(arrays[k], device) for k in _FIELDS_3D},
        step=int(arrays["step"]))


def plasma3d_state_to_numpy(state: Plasma3DState) -> Dict[str, np.ndarray]:
    out = {k: tensor_to_numpy(getattr(state, k)) for k in _FIELDS_3D}
    out["step"] = np.asarray(state.step, np.int32)
    return out
