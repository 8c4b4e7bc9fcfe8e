"""Carry parameters and streaming state between the JAX package and the
port.

The port's NamedTuples have the reference's field names in the
reference's order, so a structure converts field by field. Leaves travel
as numpy arrays: the `*_from_jax` functions call `np.asarray` on each JAX
leaf (this module imports no JAX) and give the port's tensors, and
`to_numpy` returns a port structure with numpy leaves — flattened, a
state has the same leaf order as the reference's, so either package can
resume the other's stream mid-way.
"""

from __future__ import annotations

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import agc, cx, demod, mixer, squelch
from supersdr_tpu_torch.runtime import chain, wideband

# NamedTuple fields that are themselves NamedTuples
_NESTED = {
    (wideband.WidebandState, "pfb_carry"): cx.CX,
    (wideband.WidebandState, "chain"): chain.ChainState,
    (wideband.WidebandParams, "chain"): chain.ChainParams,
    (chain.ChainState, "os_carry"): cx.CX,
    (chain.ChainState, "demod"): demod.DemodState,
    (chain.ChainState, "agc"): agc.AGCState,
    (chain.ChainState, "squelch"): squelch.SquelchState,
    (chain.ChainParams, "nco"): mixer.NCOParams,
    (chain.ChainParams, "H_pass"): cx.CX,
    (chain.ChainParams, "agc"): agc.AGCParams,
    (chain.ChainParams, "squelch"): squelch.SquelchParams,
    (chain.ChainParams, "blanker"): squelch.BlankerParams,
    (chain.ChainParams, "rot_in"): cx.CX,
    (chain.ChainParams, "rot_out"): cx.CX,
    (demod.DemodState, "last_sample"): cx.CX,
}


def _rebuild(kind, src, leaf):
    """`kind` rebuilt from the same-named fields of `src`, with `leaf`
    applied to every array (None fields stay None)."""
    vals = []
    for name in kind._fields:
        v = getattr(src, name)
        sub = _NESTED.get((kind, name))
        if v is None:
            vals.append(None)
        else:
            vals.append(_rebuild(sub, v, leaf) if sub is not None
                        else leaf(v))
    return kind(*vals)


def _to_tensor(device):
    """Leaf converter onto `device` (None: the current CUDA device)."""
    device = default_device(device)

    def leaf(v):
        a = np.asarray(v)
        a = a.astype(np.int32 if np.issubdtype(a.dtype, np.integer)
                     else np.float32)
        return torch.from_numpy(np.array(a)).to(device)
    return leaf


def chain_params_from_jax(params, device=None) -> chain.ChainParams:
    """The reference's ChainParams (any ChainConfig) → the port's."""
    return _rebuild(chain.ChainParams, params, _to_tensor(device))


def chain_state_from_jax(state, device=None) -> chain.ChainState:
    """The reference's ChainState → the port's, on `device`."""
    return _rebuild(chain.ChainState, state, _to_tensor(device))


def params_from_jax(wb_params, device=None) -> wideband.WidebandParams:
    """The reference's WidebandParams → the port's."""
    return _rebuild(wideband.WidebandParams, wb_params, _to_tensor(device))


def state_from_jax(wb_state, device=None) -> wideband.WidebandState:
    """The reference's WidebandState → the port's, on `device`."""
    return _rebuild(wideband.WidebandState, wb_state, _to_tensor(device))


def to_numpy(tree):
    """A port state or params structure (wideband or chain) with numpy
    leaves (float32, int32 for `mode_id`), in the reference's field
    layout."""
    return _rebuild(type(tree), tree,
                    lambda v: v.detach().cpu().numpy())

