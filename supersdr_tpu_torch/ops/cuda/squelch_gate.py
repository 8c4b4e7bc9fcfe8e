"""Squelch gate on time-major audio, in place.

The kernel is `csrc/squelch_gate.cu`. It replaces no kernel of the JAX
package: `supersdr_tpu/ops/squelch.py`'s gate is jnp code that XLA fuses
into the tail's program. `squelch_gate_tmajor_plain` is the same function
in plain PyTorch: the state gathered into the audio's row order by `order`,
`ops/squelch.apply_squelch_tmajor`, the new state scattered back into bin
order. `squelch_gate_tmajor` runs the plain version for CPU tensors and the
kernel for CUDA tensors; it raises on what the kernel does not take and
never falls back. On a card the audio is gated in place and returned as
it came (contiguous, time-major); the plain version returns a new tensor.
Both return the new state in new tensors. The two agree bit for bit but
for the sign of zero: the kernel stores a shut channel's negative sample
as +0.0 where the plain product gives −0.0.
"""

from __future__ import annotations

import ctypes

import torch

from supersdr_tpu_torch import _build
from supersdr_tpu_torch.ops import squelch as squelch_ops

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check(params: squelch_ops.SquelchParams,
           state: squelch_ops.SquelchState, audioT: torch.Tensor,
           rssi_db: torch.Tensor, order: torch.Tensor | None) -> None:
    """Shapes, types, layout and device of one call; raises ValueError."""
    if audioT.ndim != 2 or audioT.dtype not in _DTYPES:
        raise ValueError("audioT must be [n, C] float32, float16 or "
                         f"bfloat16, got {tuple(audioT.shape)} "
                         f"{audioT.dtype}")
    if not audioT.is_contiguous():
        raise ValueError("audioT must be contiguous time-major [n, C]")
    n, C = audioT.shape
    if n < 1 or C < 1:
        raise ValueError(f"audioT must not be empty, got {(n, C)}")
    dev = audioT.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    vectors = {"rssi_db": rssi_db, "state.open_": state.open_,
               "state.gain": state.gain}
    if order is not None:
        vectors["order"] = order
    for name, v in vectors.items():
        want = torch.int64 if name == "order" else torch.float32
        if v.shape != (C,) or v.dtype != want:
            raise ValueError(f"{name} must be {want} [{C}], got "
                             f"{tuple(v.shape)} {v.dtype}")
        if v.device != dev:
            raise ValueError(f"{name} is on {v.device}, audioT on {dev}")
    for name, p in zip(squelch_ops.SquelchParams._fields, params):
        if p.numel() != 1 or p.dtype != torch.float32 or p.device != dev:
            raise ValueError(f"params.{name} must be one float32 on {dev}")


def squelch_gate_tmajor_plain(params: squelch_ops.SquelchParams,
                              state: squelch_ops.SquelchState,
                              audioT: torch.Tensor, rssi_db: torch.Tensor,
                              order: torch.Tensor | None = None
                              ) -> tuple[squelch_ops.SquelchState,
                                         torch.Tensor]:
    """Plain PyTorch gate (see `squelch_gate_tmajor`), on whatever device
    the tensors are on."""
    if order is None:
        return squelch_ops.apply_squelch_tmajor(params, state, audioT,
                                                rssi_db)
    sq_in = squelch_ops.SquelchState(*(v[order] for v in state))
    gated, audioT = squelch_ops.apply_squelch_tmajor(params, sq_in, audioT,
                                                     rssi_db)
    out = [torch.empty_like(v) for v in gated]
    for o, v in zip(out, gated):
        o[order] = v
    return squelch_ops.SquelchState(*out), audioT


def _launch(params, state, audioT, rssi_db, order):
    lib = _build.load()
    n, C = audioT.shape
    dev = audioT.device
    rssi_db, open_in, gain_in = (v.contiguous() for v in
                                 (rssi_db, state.open_, state.gain))
    if order is not None:
        order = order.contiguous()
    open_out = torch.empty(C, dtype=torch.float32, device=dev)
    gain_out = torch.empty(C, dtype=torch.float32, device=dev)
    err = lib.squelch_gate(
        audioT.data_ptr(), _DTYPES[audioT.dtype], n, C, rssi_db.data_ptr(),
        open_in.data_ptr(), gain_in.data_ptr(),
        None if order is None else order.data_ptr(), open_out.data_ptr(),
        gain_out.data_ptr(), *(p.data_ptr() for p in params),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "squelch_gate")
    squelch_gate_tmajor.launches += 1
    return squelch_ops.SquelchState(open_=open_out, gain=gain_out), audioT


def squelch_gate_tmajor(params: squelch_ops.SquelchParams,
                        state: squelch_ops.SquelchState,
                        audioT: torch.Tensor, rssi_db: torch.Tensor,
                        order: torch.Tensor | None = None
                        ) -> tuple[squelch_ops.SquelchState, torch.Tensor]:
    """The squelch gate on time-major audio.

    audioT: contiguous [n, C] float32, float16 or bfloat16, row c the
    channel whose RSSI is rssi_db[c] (float32 [C]); state: the gate's
    state (float32 [C] leaves) in bin order, row c's bin being order[c]
    (int64 [C], a permutation; None: the identity); params: the gate's
    scalars at the audio rate (`ops/squelch.SquelchParams`, one float32
    each, the ramp per audio sample). Returns (the new state in bin order,
    the gated audio). CPU tensors run the plain version; CUDA tensors the
    kernel, which gates audioT in place and reads every input on the card
    (no host synchronise)."""
    _check(params, state, audioT, rssi_db, order)
    if audioT.device.type == "cuda":
        return _launch(params, state, audioT, rssi_db, order)
    return squelch_gate_tmajor_plain(params, state, audioT, rssi_db, order)


squelch_gate_tmajor.launches = 0
