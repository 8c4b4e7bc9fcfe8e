"""Batched dual-RX: MAIN + SUB receivers as ONE chain call.

Counterpart of `supersdr_tpu/runtime/dualrx.py`: a fixed [2, chunk]
channel axis through `chain.process` with `cfg.mode = "MULTI"` — every
per-slot control (NCO offset, passband response, AGC set, demod mode id,
active mask) is runtime data stacked from per-slot `chain.make_params`
structures, so enabling/disabling the SUB or changing any slot's
mode/tuning changes data only. The reference's single jit signature for
the life of the session becomes fixed tensors here: `refresh` writes the
new values into the tensors the first refresh made (`copy_`), keeping
their storage, shape and dtype across SUB add/drop, mode changes and
retunes. An inactive slot runs with a muted output mask and its state
keeps threading (no pops on enable/disable).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from supersdr_tpu_torch.device import PinnedStager, default_device
from supersdr_tpu_torch.ops import demod as demod_ops
from supersdr_tpu_torch.runtime import chain


def _stack(xs):
    """Stack same-structured NamedTuples of tensors leaf by leaf along a new
    leading axis (None fields stay None)."""
    if xs[0] is None:
        return None
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(_stack([getattr(x, f) for x in xs])
                             for f in xs[0]._fields))
    return torch.stack(list(xs))


def _stack_params(plist: list[chain.ChainParams],
                  modes: list[str]) -> chain.ChainParams:
    """Per-slot ChainParams → one batched structure with a leading [slots]
    axis; scalar control leaves get a trailing singleton so they broadcast
    against [slots, n] sample axes."""
    stacked = _stack(plist)
    # broadcast shapes per consumer: AGC compares against [slots, n]
    # sample arrays (→ [slots, 1]); squelch gates on [slots] block RSSI
    # except `ramp`, which multiplies a [n] time index; the blanker works
    # on [slots, n] IQ with [slots, 1] keepdims medians
    agc = type(stacked.agc)(*[v[:, None] for v in stacked.agc])
    sq = stacked.squelch._replace(ramp=stacked.squelch.ramp[:, None])
    bl = type(stacked.blanker)(*[v[:, None] for v in stacked.blanker])
    mode_id = torch.tensor([demod_ops.MODE_IDS[m.upper()] for m in modes],
                           dtype=torch.int32, device=plist[0].P_interp.device)
    # structural (slot-independent) matrices stay unstacked: the
    # resampler design depends only on the rates
    return stacked._replace(agc=agc, squelch=sq, blanker=bl,
                            mode_id=mode_id,
                            P_interp=plist[0].P_interp,
                            W_interp=plist[0].W_interp)


def _copy_into(dst, src) -> None:
    """Write `src`'s leaves into `dst`'s tensors in place (same
    structure, shapes and dtypes)."""
    if dst is None:
        if src is not None:
            raise ValueError("dual-RX parameter structure changed")
        return
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)
        return
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"dual-RX parameter leaf changed: {dst.shape} "
                         f"{dst.dtype} → {src.shape} {src.dtype}")
    dst.copy_(src)


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, device) for v in tree))
    return tree.to(device)


class DualChain:
    """Two receiver slots in one chain call.

    Per-slot settings come from `Receiver` controllers; call
    `refresh(receivers, active)` whenever any slot's tuning changed
    (host-side parameter build, written into the fixed device tensors)
    and `process(iq)` per chunk. Slot 1 is the SUB; when inactive its
    audio is masked to silence but its state keeps threading.
    """

    def __init__(self, cfg: chain.ChainConfig, device=None):
        if cfg.mode.upper() == "IQ":
            raise ValueError("dual-RX slots are audio receivers")
        if cfg.passband_impl != "fft":
            raise ValueError("batched dual-RX needs the fft passband "
                             "(per-slot responses broadcast through the "
                             "frequency-domain multiply)")
        self.device = default_device(device)
        # squelch stays compiled in: per-slot enables are runtime data
        self.cfg = dataclasses.replace(cfg, mode="MULTI",
                                       squelch_enabled=True)
        self.state = chain.init_state(self.cfg, (2,), device=self.device)
        self.params = None
        self.active = np.array([1.0, 0.0], np.float32)
        self._mask = torch.tensor(self.active, device=self.device)[:, None]
        self._stager = PinnedStager(self.device)

    def refresh(self, receivers, active: list[bool]) -> None:
        """receivers: [main, sub] Receiver-like objects (sub may equal
        main when disabled); rebuilds the batched parameters on the host
        and writes them into the device tensors in place."""
        plist, modes = [], []
        for r in receivers:
            cfg_slot = dataclasses.replace(self.cfg, mode=r.radio_mode)
            plist.append(chain.make_params(
                cfg_slot, freq_offset_hz=r.freq_offset_hz,
                low_cut=r.lc, high_cut=r.hc,
                agc_kwargs=r.agc.kwargs(),
                squelch_kwargs=dict(enabled=r.squelch_on,
                                    thresh_db=r.squelch_thresh_db),
                blanker_kwargs=dict(enabled=r.nb_on,
                                    thresh_ratio=r.nb_thresh),
                device="cpu"))
            modes.append(r.radio_mode)
        new = _stack_params(plist, modes)
        if self.params is None:
            self.params = _to(new, self.device)
        else:
            _copy_into(self.params, new)
        self.active = np.asarray([1.0 if a else 0.0 for a in active],
                                 np.float32)
        self._mask.copy_(torch.from_numpy(self.active)[:, None])

    def process(self, iq_chunk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One chunk through both slots: iq [chunk] complex → (audio [2,
        chunk·L] float32, rssi [2, n_rows]) on the host. One chain call;
        the parameter tensors are the same across SUB add/drop and any
        mode/tune change."""
        iq = self._stager.put(np.asarray(iq_chunk, np.complex64))
        self.state, out = chain.process(self.cfg, self.params, self.state,
                                        iq.expand(2, -1))
        return ((out.audio * self._mask).cpu().numpy(),
                out.rssi.cpu().numpy())
