"""Helpers shared by the tests/test_torch_*.py files (not collected).

One configuration is built in both packages, lbm_tpu (JAX, the reference)
and lbm_tpu_torch (the port); states cross between them as numpy arrays
through lbm_tpu_torch.interop. Inputs and noise are made with numpy from a
seed, so both packages see the same numbers.
"""
from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lbm_tpu import config as jcfg
from lbm_tpu.models import plasma as jplasma
from lbm_tpu_torch import config as tcfg
from lbm_tpu_torch import interop

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float64": (jnp.float64, torch.float64)}


def _jax_field(v):
    """An lbm_tpu_torch.config enum member as lbm_tpu.config's."""
    if isinstance(v, enum.Enum):
        return getattr(jcfg, type(v).__name__)[v.name]
    return v


def configs(dtype: str = "float64", backend: str = "plain", **fields):
    """(lbm_tpu config, lbm_tpu_torch config) with the same fields (enums
    given as lbm_tpu_torch.config's). backend "plain" maps to the JAX
    package's "jnp"; "fused" and "pallas" to its interpret-mode Pallas
    kernels."""
    jdt, tdt = DTYPES[dtype]
    jax_kw = {k: _jax_field(v) for k, v in fields.items()}
    jax_kw.update(dtype=jdt, backend="jnp")
    if backend in ("fused", "pallas"):
        jax_kw.update(backend=backend, kernel_interpret=True)
    return (dataclasses.replace(jcfg.PlasmaConfig(), **jax_kw),
            dataclasses.replace(tcfg.PlasmaConfig(), **fields, dtype=tdt,
                                backend=backend))


def jax_state_after(cfg_jax, n_steps: int):
    """The JAX package's state after n_steps of its jnp step."""
    state = jplasma.init_state(cfg_jax)
    step = jax.jit(jplasma.make_step(dataclasses.replace(cfg_jax,
                                                         backend="jnp")))
    for _ in range(n_steps):
        state = step(state)
    return state


def op_by_op(fn):
    """fn with JAX run op by op (jax.disable_jit), also inside lax.while_loop.
    XLA's CPU compiler contracts a*b + c into one fused multiply-add within
    a compiled computation (the iterative solvers' loop body), which moves
    last bits; the port's ops and its CUDA kernels (built -fmad=false)
    round every product, as JAX's ops do one at a time."""
    def run(*args, **kw):
        with jax.disable_jit():
            return fn(*args, **kw)
    return run


def as_numpy(state) -> dict:
    """A JAX PlasmaState as a dict of numpy arrays (bf16 stays ml_dtypes)."""
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def perturb(arrays: dict, seed: int, rel: float = 1e-3) -> dict:
    """A seeded relative perturbation of f, g, Ex and Ey, made in float64
    and cast back; Ey gets an additive one (it starts at 0)."""
    rng = np.random.default_rng(seed)
    out = dict(arrays)
    ex_scale = float(np.abs(arrays["Ex"].astype(np.float64)).max())
    for k in ("f", "g", "Ex", "Ey"):
        a = arrays[k].astype(np.float64)
        noise = rng.standard_normal(a.shape)
        a = a * (1.0 + rel * noise)
        if k == "Ey":
            a = a + rel * ex_scale * noise
        out[k] = a.astype(arrays[k].dtype)
    return out


def to_jax(arrays: dict):
    return jplasma.PlasmaState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def to_torch(arrays: dict):
    return interop.state_from_numpy(arrays, "cpu")


def np_of(x) -> np.ndarray:
    """numpy view of a torch tensor or a JAX array, in float64."""
    if isinstance(x, torch.Tensor):
        x = interop.tensor_to_numpy(x)
    return np.asarray(x).astype(np.float64)


def assert_close(got, want, rtol: float, atol_rel: float = 0.0, name=""):
    """|got - want| <= atol_rel * max|want| + rtol * |want|."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
    np.testing.assert_allclose(g, w, rtol=rtol,
                               atol=atol_rel * float(np.abs(w).max()),
                               err_msg=name)


def bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    _, e = np.frexp(np.abs(a.astype(np.float64)))
    return np.where(a == 0, 0.0, np.ldexp(1.0, e - 8))


def assert_within_bf16_ulp(got, want, name=""):
    """Each element within one bf16 ulp of its magnitude, or within the f32
    resolution (eps * scale) of its species' scale: values below that are
    rounding noise of the f32 arithmetic (e.g. neutral deltas that cancel
    to ~1e-11 against terms of ~50) and carry no bits to compare."""
    g, w = np_of(got), np_of(want)
    assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
    axes = tuple(range(1, w.ndim)) if w.ndim == 4 else None
    scale = np.abs(w).max(axis=axes, keepdims=axes is not None)
    floor = np.finfo(np.float32).eps * scale
    allowed = np.maximum(bf16_ulp(np.maximum(np.abs(g), np.abs(w))), floor)
    bad = np.abs(g - w) > allowed
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements differ by "
                           f"more than one bf16 ulp, worst "
                           f"{np.abs(g - w)[bad].max():.3e}")
