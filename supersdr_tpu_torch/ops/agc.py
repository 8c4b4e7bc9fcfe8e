"""AGC with the KiwiSDR parameter surface (`SET agc=…`).

Counterpart of `supersdr_tpu/ops/agc.py`: envelope → dB, a peak tracker
with instant attack and a linear-in-dB decay (a max-plus recurrence), an
optional hang (a causal sliding-window max, exact), the kneed gain law,
and a one-pole smoother on the gain. The fused chain tail
(`ops/cuda/chain_tail.py`) runs the same law inside its kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from supersdr_tpu_torch.ops import scans

MANUAL_UNITY_DB = 50.0
ENV_FLOOR = 1e-9


class AGCParams(NamedTuple):
    """Runtime AGC parameters, float32 tensors (0-d, or per slot)."""
    on: torch.Tensor                    # 1 = auto, 0 = manual gain
    hang: torch.Tensor                  # 1 = hang enabled
    thresh_db: torch.Tensor             # knee, dBFS
    slope_db: torch.Tensor              # output rise over thresh→0
    decay_per_sample_db: torch.Tensor
    man_gain_db: torch.Tensor
    target_db: torch.Tensor
    attack_coeff: torch.Tensor          # one-pole gain smoothing


def make_params(fs: float, on: bool = True, hang: bool = False,
                thresh_db: float = -80.0, slope_db: float = 0.0,
                decay_ms: float = 4000.0, man_gain_db: float = 50.0,
                target_db: float = -10.0, attack_ms: float = 5.0,
                device=None) -> AGCParams:
    """`decay_ms`: time for the tracked peak to fall 60 dB. The attack
    coefficient is exp(−1/(attack·fs)) rounded once to float32."""
    PEAK_DROP_DB = 60.0
    decay_per_sample = PEAK_DROP_DB / (max(decay_ms, 1e-3) * 1e-3 * fs)
    attack_coeff = np.exp(-1.0 / (max(attack_ms, 1e-3) * 1e-3 * fs))

    def f32(v):
        return torch.tensor(np.float32(v), dtype=torch.float32,
                            device=device)
    return AGCParams(on=f32(1.0 if on else 0.0),
                     hang=f32(1.0 if hang else 0.0),
                     thresh_db=f32(thresh_db), slope_db=f32(slope_db),
                     decay_per_sample_db=f32(decay_per_sample),
                     man_gain_db=f32(man_gain_db), target_db=f32(target_db),
                     attack_coeff=f32(attack_coeff))


class AGCState(NamedTuple):
    peak_db: torch.Tensor   # tracked envelope peak at the end of a block
    gain_db: torch.Tensor   # smoothed gain at the end of a block


def init_state(batch_shape: tuple[int, ...] = (), device=None) -> AGCState:
    return AGCState(
        peak_db=torch.full(batch_shape, -120.0, dtype=torch.float32,
                           device=device),
        gain_db=torch.zeros(batch_shape, dtype=torch.float32, device=device))


def hang_samples(fs: float, hang_ms: float = 500.0) -> int:
    return max(1, int(round(hang_ms * 1e-3 * fs)))


def apply(params: AGCParams, state: AGCState, audio: torch.Tensor,
          hang_window: int = 1, decimation: int = 1,
          shard_axis: int | None = None, comm=None
          ) -> tuple[AGCState, torch.Tensor]:
    """AGC over one block, audio [*batch, n] (complex in IQ mode: the
    envelope is |audio|). `hang_window` samples (1 = off); `decimation`
    runs the ballistics on per-group envelope peaks (n % decimation ==
    0) and repeats the gain back to the sample rate. With `shard_axis=-2`
    (the reference's `axis_name`) audio is `[*batch, D, n_local]` and the
    ballistics run exactly across the time shards (of `comm`, the mesh's
    transport): the general scans with their cross-shard fold, the hang
    window reaching into the left shards; the state seeds shard 0 and the
    returned state holds every shard's (`[*batch, D]`)."""
    sharded = shard_axis is not None
    env = audio.abs().float()
    n = env.shape[-1]
    if decimation > 1:
        if n % decimation:
            raise ValueError("block length must be divisible by decimation")
        env = env.reshape(*env.shape[:-1], n // decimation,
                          decimation).amax(-1)
        if hang_window > 1:
            hang_window = max(1, hang_window // decimation)
    env_db = 20.0 * torch.log10(torch.clamp_min(env, ENV_FLOOR))
    d = -params.decay_per_sample_db * decimation
    if d.ndim == 0 and not sharded:
        peak_db = scans.maxplus_scan_const(d, env_db, state.peak_db)
    else:
        peak_db = scans.maxplus_scan(d, env_db, state.peak_db,
                                     shard_axis=shard_axis, comm=comm)
    if hang_window > 1:
        held = scans.sliding_max(peak_db, hang_window,
                                 shard_axis=shard_axis, comm=comm)
        peak_db = torch.where(params.hang > 0, held, peak_db)
    max_gain = params.target_db - params.thresh_db
    above = (params.target_db - peak_db) + params.slope_db * (
        (peak_db - params.thresh_db)
        / torch.clamp_min(-params.thresh_db, 1e-6))
    auto_gain = torch.where(peak_db <= params.thresh_db, max_gain, above)
    gain_db = torch.where(params.on > 0, auto_gain,
                          params.man_gain_db - MANUAL_UNITY_DB)
    attack = params.attack_coeff ** decimation
    if attack.ndim == 0 and not sharded:
        gain_db = scans.linear_scan_const(attack, (1.0 - attack) * gain_db,
                                          state.gain_db)
    else:
        gain_db = scans.linear_scan(attack, (1.0 - attack) * gain_db,
                                    state.gain_db, shard_axis=shard_axis,
                                    comm=comm)
    new_state = AGCState(peak_db=peak_db[..., -1], gain_db=gain_db[..., -1])
    if decimation > 1:
        gain_db = torch.repeat_interleave(gain_db, decimation, dim=-1)
    return new_state, audio * torch.pow(10.0, gain_db / 20.0)
