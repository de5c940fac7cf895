"""Checkpoint / resume for the simulation states (counterpart of
lbm_tpu/io/checkpoint.py, without its Orbax variant).

The npz layout is the JAX package's, key by key, so a file written by
either package loads into the other bit for bit: one array per state
field, named as the state's field; bfloat16 arrays as their raw bits,
uint16, under "<field>__bf16" (npz has no bfloat16); the step counter as a
0-d int32 array (a host int in the port's states); and two layout tags,
"__meta_neutral_delta" (int8: f[2] holds deviations from the uniform
neutral background) and "__meta_storage" (the population storage, native
or bf16), so that a resume can tell a layout it must convert from one it
may take as is (reconcile_resumed_state, reconcile_cavity_state).

bfloat16 crosses through int16 views of the tensors, never through a
numpy bfloat16 type. Every load builds its state on the device it is
given. with_fresh_phi stores the potential that fft_engine="pallas" never
forms.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import BC, PoissonSolver
from ..constants import D2Q9, D3Q19
from ..models import cavity as _cav
from ..models import plasma as _plasma
from ..models.cavity import CavityState
from ..models.plasma import PlasmaState
from ..models.plasma3d import Plasma3DState

# npz keys carrying layout metadata rather than state arrays
_META_DELTA = "__meta_neutral_delta"
_META_STORAGE = "__meta_storage"
_BF16 = "__bf16"
_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bfloat16 as its raw bits (uint16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _save(path: str, state, fields, *,
          neutral_delta: Optional[bool] = None,
          storage: Optional[str] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if len(tuple(state)) != len(fields):
        # e.g. a Plasma3DState passed to the 2-D save: a silent zip would
        # mislabel fields and drop the tail
        raise ValueError(f"state has {len(tuple(state))} fields, "
                         f"checkpoint schema expects {len(fields)}")
    arrays = {}
    for k, v in zip(fields, state):
        if k == "step":
            arrays[k] = np.asarray(int(v), np.int32)
        elif v.dtype == torch.bfloat16:
            arrays[k + _BF16] = _host_array(v)
        else:
            arrays[k] = _host_array(v)
    if neutral_delta is not None:
        arrays[_META_DELTA] = np.asarray(int(neutral_delta), np.int8)
    if storage is not None:
        arrays[_META_STORAGE] = np.asarray(storage, np.str_)
    np.savez_compressed(path, **arrays)


def save(path: str, state: PlasmaState, *,
         neutral_delta: Optional[bool] = None,
         storage: Optional[str] = None) -> None:
    _save(path, state, PlasmaState._fields, neutral_delta=neutral_delta,
          storage=storage)


def save3d(path: str, state: Plasma3DState, *,
           neutral_delta: Optional[bool] = None,
           storage: Optional[str] = None) -> None:
    """Plasma3DState variant (f, g, Ex, Ey, Ez, phi, step)."""
    _save(path, state, Plasma3DState._fields, neutral_delta=neutral_delta,
          storage=storage)


def save_cavity(path: str, state: CavityState, *,
                storage: Optional[str] = None) -> None:
    """CavityState variant (f, rho, ux, uy, step). ``storage`` records the
    population layout: "bf16" means f holds bfloat16 DELTAS from the
    uniform background w_i (CavityConfig.storage)."""
    _save(path, state, CavityState._fields, storage=storage)


def load_meta(path: str) -> dict:
    """Layout metadata recorded in the checkpoint (empty for pre-metadata
    files, whose layout the caller must declare: --assume-ckpt-layout)."""
    meta = {}
    with np.load(path) as z:
        if _META_DELTA in z:
            meta["neutral_delta"] = bool(z[_META_DELTA])
        if _META_STORAGE in z:
            meta["storage"] = str(z[_META_STORAGE])
    return meta


def _load(path: str, state_cls, device, dtype=None):
    """An explicit dtype converts every floating field (bf16 storage stays
    bf16 only for dtype=None), as the JAX package's _load."""
    vals = {}
    with np.load(path) as z:
        for k in state_cls._fields:
            if k == "step":
                vals[k] = int(z[k])
                continue
            if k + _BF16 in z:
                bits = np.ascontiguousarray(z[k + _BF16]).view(np.int16)
                t = torch.from_numpy(bits).view(torch.bfloat16)
                if dtype is not None:
                    t = t.to(dtype)    # exact: bf16 widens
            else:
                a = z[k]
                if dtype is not None and a.dtype.kind == "f":
                    # numpy's cast, as the JAX package's (one rounding)
                    a = a.astype(_NUMPY_DTYPES[dtype])
                t = torch.from_numpy(np.ascontiguousarray(a))
            vals[k] = t.to(device)
    return state_cls(**vals)


def load(path: str, device, dtype=None) -> PlasmaState:
    return _load(path, PlasmaState, device, dtype)


def load3d(path: str, device, dtype=None) -> Plasma3DState:
    return _load(path, Plasma3DState, device, dtype)


def load_cavity(path: str, device, dtype=None) -> CavityState:
    return _load(path, CavityState, device, dtype)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in `dtype`, float64 -> bfloat16 rounded through float32 as numpy's
    bfloat16 (ml_dtypes) rounds it, on any device."""
    if dtype == torch.bfloat16 and t.dtype == torch.float64:
        t = t.to(torch.float32)
    return t.to(dtype)


def reconcile_cavity_state(state: CavityState, path: str, cfg) -> CavityState:
    """Convert a loaded cavity checkpoint to cfg's storage layout.

    The bf16 cavity layout stores f as deviations from w_i, so a storage
    mismatch is a LAYOUT mismatch, converted here through the model's
    decode/encode pair, inline rather than through a storage-swapped
    config (CavityConfig refuses bf16 + f64, which would make a bf16
    checkpoint unresumable into an f64 native run). Metadata-less
    checkpoints are declared native."""
    ck = load_meta(path).get("storage", "native")
    macros = dict(rho=state.rho.to(cfg.dtype), ux=state.ux.to(cfg.dtype),
                  uy=state.uy.to(cfg.dtype))
    if ck == cfg.storage:
        if cfg.storage == "bf16":
            return state   # f is bf16 by construction; macros load as f32
        return CavityState(f=state.f.to(cfg.dtype), step=state.step,
                           **macros)
    f_full = (_cav.decode_f(cfg, state.f).to(cfg.dtype) if ck == "bf16"
              else state.f)
    return CavityState(f=_cav.encode_f(cfg, f_full), step=state.step,
                       **macros)


def convert_neutral_layout(state, *, to_delta: bool, rho_n_ref: float):
    """Convert f[2] between the classic and delta neutral layouts of a
    PlasmaState or Plasma3DState (D2Q9 or D3Q19 stacks).

    classic -> delta subtracts the uniform background rho_n_ref * w_i per
    direction; delta -> classic adds it. The sum runs in float64 on the
    state's device (the background is ~1.8e10 lattice units at the golden
    scaling) and is cast back to the stored dtype as numpy casts it:
    float64 -> bfloat16 rounds through float32 (see cast)."""
    f = state.f
    Q = f.shape[1]
    W = {9: D2Q9.W, 19: D3Q19.W}[Q]
    sign = -1.0 if to_delta else 1.0
    bg = sign * (np.asarray(W, np.float64) * float(rho_n_ref))
    bg = torch.from_numpy(bg.reshape((Q,) + (1,) * (f.ndim - 2))).to(f.device)
    out = f.clone()
    out[2] = cast(f[2].to(torch.float64) + bg, f.dtype)
    return state._replace(f=out)


def reconcile_resumed_state(state, path: str, cfg, *,
                            assume_layout: Optional[str] = None, log=print):
    """Make a loaded plasma checkpoint's layout and dtype match cfg before
    stepping (the 2-D and 3-D CLIs' --resume). Reconciles
      * the NEUTRAL LAYOUT (classic full populations or deltas from the
        uniform background), read from the checkpoint's metadata or from
        `assume_layout` ("classic" | "delta") for pre-metadata files;
        refuses (ValueError) when neither says, since reading full
        populations as deltas would double rho_n;
      * the POPULATION DTYPE with cfg.storage (bf16 <-> native)."""
    meta = load_meta(path)
    ckpt_delta = meta.get("neutral_delta")
    if ckpt_delta is None and assume_layout:
        ckpt_delta = assume_layout == "delta"
    if ckpt_delta is None:
        raise ValueError(
            f"{path} predates layout metadata; declare its neutral layout "
            f"via assume_layout='classic'|'delta' (CLI: "
            f"--assume-ckpt-layout). classic = full neutral populations, "
            f"the pre-metadata default; delta = deviations from the "
            f"uniform background")
    if ckpt_delta != cfg.neutral_delta:
        log(f"resume: converting neutral layout "
            f"{'delta' if ckpt_delta else 'classic'} -> "
            f"{'delta' if cfg.neutral_delta else 'classic'}")
        state = convert_neutral_layout(state, to_delta=cfg.neutral_delta,
                                       rho_n_ref=cfg.units().rho_n_init)
    want = torch.bfloat16 if cfg.storage == "bf16" else cfg.dtype
    if state.f.dtype != want:
        log(f"resume: converting populations "
            f"{str(state.f.dtype).replace('torch.', '')} -> "
            f"{str(want).replace('torch.', '')}")
        state = state._replace(f=cast(state.f, want), g=cast(state.g, want))
    return state


def load_for_run(path: str, cfg, device, *,
                 assume_layout: Optional[str] = None, log=print):
    """The plasma CLIs' --resume: the checkpoint's state (a Plasma3DState
    when cfg.NZ > 0) on `device`, loaded at cfg.dtype and reconciled with
    cfg (reconcile_resumed_state). ValueError for a grid other than cfg's
    or an undeclared pre-metadata layout."""
    three = bool(cfg.NZ)
    state = (load3d if three else load)(path, device, dtype=cfg.dtype)
    grid = (cfg.NZ, cfg.NY, cfg.NX) if three else (cfg.NY, cfg.NX)
    if tuple(state.Ex.shape) != grid:
        raise ValueError(f"checkpoint grid {tuple(state.Ex.shape)} != run "
                         f"grid {grid}")
    return reconcile_resumed_state(state, path, cfg,
                                   assume_layout=assume_layout, log=log)


def with_fresh_phi(cfg, state: PlasmaState) -> PlasmaState:
    """The state to save: under fft_engine="pallas" (FFT, periodic) the
    step never forms phi, so the stored one is the solve of the current
    rho_q (models/plasma.reconstruct_phi: the warm start a resume's first
    solve reproduces); otherwise the state itself."""
    if (cfg.poisson == PoissonSolver.FFT and cfg.bc == BC.PERIODIC
            and _plasma._use_pallas_fft(cfg, (cfg.NY, cfg.NX))):
        return state._replace(phi=_plasma.reconstruct_phi(cfg, state))
    return state
