"""Carry parameters and streaming state between the JAX package and the
port.

The port's NamedTuples have the reference's field names in the
reference's order, so a structure converts field by field. Leaves travel
as numpy arrays: `params_from_jax` / `state_from_jax` call `np.asarray`
on each JAX leaf (this module imports no JAX), and `state_to_numpy`
returns the port's state with numpy leaves — flattened, it has the same
leaf order as the reference's `WidebandState`, so either package can
resume the other's stream mid-way.
"""

from __future__ import annotations

import numpy as np
import torch

from supersdr_tpu_torch.ops import agc, cx, demod, squelch
from supersdr_tpu_torch.runtime import chain, wideband

# NamedTuple fields that are themselves NamedTuples
_NESTED = {
    (wideband.WidebandState, "pfb_carry"): cx.CX,
    (wideband.WidebandState, "chain"): chain.ChainState,
    (chain.ChainState, "os_carry"): cx.CX,
    (chain.ChainState, "demod"): demod.DemodState,
    (chain.ChainState, "agc"): agc.AGCState,
    (chain.ChainState, "squelch"): squelch.SquelchState,
    (demod.DemodState, "last_sample"): cx.CX,
}


def _rebuild(kind, src, leaf):
    """`kind` rebuilt from the same-named fields of `src`, with `leaf`
    applied to every array."""
    vals = []
    for name in kind._fields:
        v = getattr(src, name)
        sub = _NESTED.get((kind, name))
        vals.append(_rebuild(sub, v, leaf) if sub is not None else leaf(v))
    return kind(*vals)


def _to_tensor(device):
    def leaf(v):
        return torch.from_numpy(np.array(np.asarray(v), np.float32)
                                ).to(device)
    return leaf


def params_from_jax(wb_params, device=None) -> wideband.WidebandParams:
    """The reference's WidebandParams → the port's (the fields the slice
    reads: W_pfb, W_tailpass, P_interp, AGC and squelch)."""
    t = _to_tensor(device)
    ch = wb_params.chain
    return wideband.WidebandParams(
        W_pfb=t(wb_params.W_pfb),
        chain=chain.ChainParams(
            P_interp=t(ch.P_interp),
            agc=agc.AGCParams(*(t(getattr(ch.agc, f))
                                for f in agc.AGCParams._fields)),
            squelch=squelch.SquelchParams(
                *(t(getattr(ch.squelch, f))
                  for f in squelch.SquelchParams._fields)),
            W_tailpass=None if ch.W_tailpass is None else t(ch.W_tailpass)))


def state_from_jax(wb_state, device=None) -> wideband.WidebandState:
    """The reference's WidebandState → the port's, on `device`."""
    return _rebuild(wideband.WidebandState, wb_state, _to_tensor(device))


def state_to_numpy(state):
    """A port WidebandState (or ChainState) with numpy float32 leaves, in
    the reference's field layout."""
    kind = type(state)
    return _rebuild(kind, state,
                    lambda v: v.detach().cpu().numpy().astype(np.float32))
