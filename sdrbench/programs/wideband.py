"""`supersdr_tpu_torch`'s wideband receiver (`runtime/wideband`), one
`process_i16` call a chunk.

A configuration file names the tier (`profile`, a key of the program's
`PROFILES`, or null for the receiver's defaults) and any further
`WidebandConfig` fields (`wideband`), the layout its output rows follow
(`rows`, a key of `design.ROW_ORDERS`), and how often each kernel wrapper
launches a chunk (`launches`: {"<module of ops/cuda>.<wrapper>": count}),
which the drivers hold every timed chunk to. A `squelch` block in the
deployment turns the receiver's squelch gate on (`squelch_enabled`) with
its thresholds and ramp; `wideband` may not say otherwise.
"""

from __future__ import annotations

import functools
import importlib

import torch

from sdrbench.reference import design, modes, squelch
from sdrbench.reference.pipeline import RefState


def config(conf: dict, frames: int):
    """The program's WidebandConfig for a configuration file and a chunk
    of `frames` frames."""
    from supersdr_tpu_torch.runtime import wideband
    dep = conf["deployment"]
    kw = dict(wideband.PROFILES[conf["profile"]]) if conf["profile"] else {}
    kw.update(conf["wideband"])
    gate = "squelch" in dep
    if kw.get("squelch_enabled", gate) != gate:
        raise ValueError("wideband.squelch_enabled contradicts the "
                         "deployment's squelch block")
    if gate:
        kw["squelch_enabled"] = True
    return wideband.WidebandConfig(
        fs_in=dep["fs_in"], n_chan=dep["n_chan"],
        chunk_in=dep["n_chan"] * frames, taps_per=dep["taps_per"],
        mode=dep["mode"], n_taps=dep["n_taps"],
        audio_rate=dep["audio_rate"], **kw)


def _agc_kwargs(dep: dict) -> dict:
    a = dep["agc"]
    return dict(on=a["on"], hang=a["hang"], thresh_db=a["thresh_db"],
                slope_db=a["slope_db"], decay_ms=a["decay_ms"],
                target_db=a["target_db"], attack_ms=a["attack_ms"])


def _squelch_kwargs(dep: dict) -> dict:
    q = dep["squelch"]
    return dict(enabled=True, thresh_db=q["thresh_db"],
                hyst_db=q["hyst_db"], ramp_samples=q["ramp_samples"])


def _leaf(obj, path: str) -> torch.Tensor:
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def ref_state(st, leaves: tuple) -> RefState:
    """The program's stream state as the reference holds it (bins in
    order, float64); `leaves` names the chain state's leaves the reference
    carries besides the histories (the demodulator's, and the gate's)."""
    c = st.chain

    def cplx(p):
        return torch.complex(p.re.double(), p.im.double())
    return RefState(pfb=cplx(st.pfb_carry), os=cplx(c.os_carry),
                    interp=c.interp_carry.double(),
                    leaves={k: _leaf(c, k).double() for k in leaves})


class Program:
    kind = "program"

    def __init__(self, conf: dict, frames: int, device):
        from supersdr_tpu_torch.runtime import wideband
        self._wb = wideband
        dep = conf["deployment"]
        self.device = torch.device(device)
        self.cfg = config(conf, frames)
        kwargs = dict(agc_kwargs=_agc_kwargs(dep))
        leaves = modes.load(dep["mode"]).LEAVES
        if "squelch" in dep:
            kwargs["squelch_kwargs"] = _squelch_kwargs(dep)
            leaves += squelch.LEAVES
        self.params = wideband.make_params(self.cfg, device=self.device,
                                           **kwargs)
        self.row_bins = design.row_order(conf["rows"], dep["n_chan"])
        # a plain function, so that it outlives the program's parameters
        self.ref_state = functools.partial(ref_state, leaves=leaves)
        self.launches_per_chunk = dict(conf["launches"])

    def init_state(self):
        return self._wb.init_state(self.cfg, device=self.device)

    def step(self, state, iq16):
        st, out = self._wb.process_i16(self.cfg, self.params, state, iq16)
        audio = out.audio if self.cfg.time_major else out.audio.T
        return st, audio, out.rssi

    def launches(self) -> dict | None:
        """Each counted wrapper's launches so far; None off the card,
        where the wrappers run their plain versions."""
        if self.device.type != "cuda":
            return None
        out = {}
        for name in self.launches_per_chunk:
            mod, fn = name.rsplit(".", 1)
            wrapper = getattr(importlib.import_module(
                f"supersdr_tpu_torch.ops.cuda.{mod}"), fn)
            out[name] = wrapper.launches
        return out
