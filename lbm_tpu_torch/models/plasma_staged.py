"""Stage-granular plasma step for the debug-dump harness (counterpart of
lbm_tpu/models/plasma_staged.py).

The reference's debug build dumps the whole grid after each of the 5
pipeline stages of every step (old codes/Plasma debug/
plasma_debug.cpp:1480-1557: UpdateMacro, ComputeEquilibrium, Collisions,
Streaming, SolvePoisson). The step of models/plasma.py does not keep those
stages apart, so this module has a plain-backend step that keeps a snapshot
after every stage, for io.debug_dump to write in the C++ dump's format.

The stale-buffer semantics are replicated, so a dump diffs cleanly against
the C++ file line for line:
  * the 9 equilibrium sets are carried across steps (the C++ buffers are
    written in ComputeEquilibrium and stay stale through the next step's
    UpdateMacro dump; they start zeroed);
  * the macros shown at Collisions, Streaming and SolvePoisson are the ones
    of this step's UpdateMacro;
  * E shown before SolvePoisson is the previous step's post-solve field,
    and the debug variant's step-0 pulse zeroing lands AFTER the
    SolvePoisson dump (plasma_debug.cpp:1558-1566).

The numerics are the plain step's (the same ops).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..config import BC, PlasmaConfig
from ..ops import stream as stream_ops
from ..ops.collide import collide
from ..ops.equilibrium import equilibrium_from_polys, equilibrium_polys
from ..ops.macros import Macros, update_macro
from ..ops.stream import stream_bounceback, stream_periodic
from .plasma import (PlasmaState, _g_holes_with_background, _solve_poisson,
                     check_supported, guard_values)

# Dump order of the materialised equilibrium sets (plasma_debug.cpp's
# buffer names): f_eq_s = eq(rho_s, u_s); f_eq_a_b = eq(rho_a, u_ab) with
# the pairwise mixture velocity (pair axes: ei=0, en=1, in=2).
EQ_LABELS = ("f_eq_e", "f_eq_i", "f_eq_n",
             "f_eq_e_i", "f_eq_i_e", "f_eq_e_n",
             "f_eq_n_e", "f_eq_i_n", "f_eq_n_i")
# (species amplitude, velocity source): velocity -1 -> self, else pair axis
_EQ_SPEC = {"f_eq_e": (0, -1), "f_eq_i": (1, -1), "f_eq_n": (2, -1),
            "f_eq_e_i": (0, 0), "f_eq_i_e": (1, 0),
            "f_eq_e_n": (0, 1), "f_eq_n_e": (2, 1),
            "f_eq_i_n": (1, 2), "f_eq_n_i": (2, 2)}

STAGES = ("UpdateMacro", "ComputeEquilibrium", "Collisions",
          "Streaming", "SolvePoisson")


class StageSnapshot(NamedTuple):
    """Everything the C++ per-stage dump prints."""

    mac: Macros
    Ex: torch.Tensor
    Ey: torch.Tensor
    f: torch.Tensor                      # (3, Q, NY, NX)
    feq: Dict[str, torch.Tensor]         # label -> (Q, NY, NX)


def init_feq(cfg: PlasmaConfig, device) -> Dict[str, torch.Tensor]:
    """The C++ equilibrium buffers start zeroed (allocated, not filled)."""
    z = torch.zeros((9, cfg.NY, cfg.NX), dtype=cfg.dtype, device=device)
    return {k: z for k in EQ_LABELS}


def _materialize_eq(mac: Macros, cs2: float) -> Dict[str, torch.Tensor]:
    polys_self = [equilibrium_polys(mac.ux[s], mac.uy[s], cs2)
                  for s in range(3)]
    polys_pair = [equilibrium_polys(mac.ux_pair[p], mac.uy_pair[p], cs2)
                  for p in range(3)]
    out = {}
    for label, (s, vel) in _EQ_SPEC.items():
        polys = polys_self[s] if vel < 0 else polys_pair[vel]
        out[label] = torch.stack(equilibrium_from_polys(mac.rho[s], polys))
    return out


def make_staged_step(cfg: PlasmaConfig):
    """(state, feq_prev) -> (new_state, feq, {stage: StageSnapshot}).

    Plain ops only (the dump is for tiny grids); native storage only: bf16
    populations would dump rounded bits, not the C++-comparable fields."""
    check_supported(cfg)
    if cfg.storage != "native":
        raise ValueError("staged debug step supports native storage only")
    u = cfg.units()
    periodic = cfg.bc == BC.PERIODIC
    debug_variant = cfg.compat.debug_variant
    guard_vals = guard_values(cfg)
    neutral_ref = u.rho_n_init if cfg.neutral_delta else 0.0

    def staged(state: PlasmaState, feq_prev: Dict[str, torch.Tensor]
               ) -> Tuple[PlasmaState, Dict[str, torch.Tensor],
                          Dict[str, StageSnapshot]]:
        stages = {}
        mac = update_macro(state.f, state.g, state.Ex, state.Ey,
                           q_e=u.q_e, q_i=u.q_i, m_e=u.m_e, m_i=u.m_i,
                           guard_vals=guard_vals, neutral_ref=neutral_ref)
        stages["UpdateMacro"] = StageSnapshot(mac, state.Ex, state.Ey,
                                              state.f, feq_prev)
        feq = _materialize_eq(mac, u.cs2)
        stages["ComputeEquilibrium"] = StageSnapshot(mac, state.Ex, state.Ey,
                                                     state.f, feq)
        f_post, g_post = collide(state.f, state.g, mac, state.Ex, state.Ey,
                                 taus=cfg.taus, q_e=u.q_e, q_i=u.q_i,
                                 m_e=u.m_e, m_i=u.m_i, cs2=u.cs2, kb=u.kb,
                                 neutral_ref=neutral_ref)
        stages["Collisions"] = StageSnapshot(mac, state.Ex, state.Ey,
                                             f_post, feq)
        if periodic:
            f = stream_periodic(f_post)
            g = stream_periodic(g_post)
        else:
            # the corner-hole quirks of models/plasma.py's plain step
            f = stream_bounceback(f_post, stale=state.f)
            if debug_variant:
                g = stream_bounceback(g_post, stale=state.g)
            else:
                g_holes = _g_holes_with_background(
                    stream_ops.hole_values(f_post), neutral_ref)
                g = stream_ops.bounceback_from_periodic(
                    stream_periodic(g_post), g_holes)
        stages["Streaming"] = StageSnapshot(mac, state.Ex, state.Ey, f, feq)
        Ex, Ey, phi = _solve_poisson(cfg, mac.rho_q, state.phi,
                                     state.Ex, state.Ey)
        stages["SolvePoisson"] = StageSnapshot(mac, Ex, Ey, f, feq)
        if debug_variant and state.step == 0:
            # pulsed external field: zeroed after the step-0 SolvePoisson
            # dump (plasma_debug.cpp:1558-1566)
            Ex, Ey = torch.zeros_like(Ex), torch.zeros_like(Ey)
        new_state = PlasmaState(f=f, g=g, Ex=Ex, Ey=Ey, phi=phi,
                                step=state.step + 1)
        return new_state, feq, stages

    return staged
