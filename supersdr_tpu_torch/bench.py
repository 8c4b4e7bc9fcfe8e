"""Benchmark: wideband IQ→audio throughput on one card, self-validating.

Counterpart of the repository's `bench.py`, section by section, on the
port (`python -m supersdr_tpu_torch.cli bench [--device DEV]`, or
`python -m supersdr_tpu_torch.bench`). It runs the flagship pipeline, a
polyphase channelizer splitting a 30.72 MHz capture into 2560 channels,
each through the receiver chain (passband FIR → AM demod → AGC → 4×
polyphase resample), and reports aggregate input Msamples/s for both
tuning profiles (`runtime.wideband.PROFILES`). On the card the timed
calls launch the channelizer kernel (`csrc/channelize_fused.cu`) and the
FIR tail kernel (`csrc/chain_tail.cu`) once a chunk each; the run fails
if either counter stands still.

Method, as in `bench.py`:
  * Integrity gates BEFORE timing, each ≥ 50 dB, finite, nonzero:
      - SMALL (16 channels, two chunks, seed 0) against the JAX package's
        own CPU audio for the same input, committed as
        `data/bench_small_ref.npz` with the sha256 of the input's bytes
        (`bench.py`'s `_ORACLE_SRC` recipe); the input is drawn again
        here with numpy, and a draw whose hash differs is refused;
      - MID (2560 channels, 512 frames, seed 2), MID-SSB (USB, seed 4)
        and MID-NBFM (Carson-safe FM carriers, AGC off, the carrier rows
        past the first 1280 audio samples, seed 6), each twice: every
        row against the port's plain path (`WidebandConfig(**base)`, no
        tuning) on the host CPU, the configuration `bench.py`'s oracle
        runs, without JAX, which the card's machine does not have; and
        the rows in `data/bench_mid_ref.npz` (every 40th channel; NBFM
        its 16 carriers) against the JAX package's own CPU audio,
        committed with the sha256 of each input's bytes like SMALL's, so
        that no gate rests on the port's code alone.
    Oracle outputs do not depend on the profile, so they are computed
    once and shared by both tiers. `oracle` in the output names each.
  * Timing is fetch-forced: the clock stops when a device-side
    `abs().mean()` of the last audio has been read on the host; that
    reduction is inside the figure, as in the reference. The input is
    made on the device from a seeded generator.
  * Consistency: the timed configuration's first 512·L audio samples a
    channel, from a fresh state, must match the MID gate's level within
    25 %; otherwise `integrity` is "fail" and `value` 0.
  * int16 ingest: `process_i16` against `process` on the dequantized
    chunk (> 80 dB), then timed.

Baseline: the north-star target of 1 Gsample/s aggregate over ≥ 2 hosts,
i.e. 500 Msamples/s a host; `vs_baseline` = the headline Msamples/s /
500. Prints ONE JSON line (the headline profile, the other as a
sub-object, the card under "device") and exits 1 unless `integrity` is
"pass" and `value` > 0.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from supersdr_tpu_torch.device import default_device
from supersdr_tpu_torch.ops import cx
from supersdr_tpu_torch.ops.cuda import chain_tail, channelize_fused
from supersdr_tpu_torch.runtime import wideband
from supersdr_tpu_torch.runtime.wideband import PROFILES

PROFILE = os.environ.get("BENCH_PROFILE", "fast")

SMALL = dict(fs_in=192_000, n_chan=16, chunk_in=32_768, mode="AM",
             taps_per=8, n_taps=257, audio_rate=48_000)
# MID: the headline's n_chan (the same factoring and kernel classes) at a
# chunk small enough for the CPU oracle
MID = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512, mode="AM",
           taps_per=8, n_taps=257, audio_rate=48_000)
MID_SSB = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512,
               mode="USB", taps_per=8, n_taps=257, audio_rate=48_000)
MID_NBFM = dict(fs_in=30_720_000, n_chan=2560, chunk_in=2560 * 512,
                mode="NBFM", taps_per=8, n_taps=257, audio_rate=48_000)
HEADLINE = dict(fs_in=30_720_000, n_chan=2560,
                chunk_in=2560 * (16384 - 256), mode="AM",
                taps_per=8, n_taps=257, audio_rate=48_000)
# chunks a timed step (`process_n`); 1 steps through `process`
N_SCAN = int(os.environ.get("BENCH_N_SCAN", "2"))
MIN_MEASURE_S = 2.0

DATA = Path(__file__).resolve().parent / "data"
SMALL_REF = DATA / "bench_small_ref.npz"
MID_REF = DATA / "bench_mid_ref.npz"
# the MID and MID-SSB rows held against the JAX package's audio
MID_REF_ROWS = np.arange(0, 2560, 40)
_MID_ORACLE = ("port plain path, cpu, every row; jax-cpu fixture "
               "(data/bench_mid_ref.npz), 64 rows")
ORACLE = {"small": "jax-cpu fixture (data/bench_small_ref.npz)",
          "mid": _MID_ORACLE, "midssb": _MID_ORACLE,
          "midnbfm": "port plain path, cpu, and jax-cpu fixture "
                     "(data/bench_mid_ref.npz): the 16 carrier rows past "
                     "1280 samples, agc off"}


def _snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    num = float(np.linalg.norm(ref))
    den = float(np.linalg.norm(got - ref))
    if den == 0.0:
        return np.inf
    return 20.0 * np.log10(max(num, 1e-30) / den)


def noise_input(base_cfg: dict, n_chunks: int, seed: int) -> np.ndarray:
    """`bench.py`'s gate input: complex Gaussian noise, 0.05 a plane."""
    rng = np.random.default_rng(seed)
    n = (n_chunks, base_cfg["chunk_in"])
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.05
            ).astype(np.complex64)


def input_sha256(iq: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(iq).tobytes()).hexdigest()


def _refuse_other_input(iq: np.ndarray, want: str, name: str) -> None:
    got = input_sha256(iq)
    if got != want:
        raise RuntimeError(
            f"a gate's input (sha256 {got}) is not the one {name} was "
            f"made from ({want}): this numpy draws another sequence from "
            f"the seed, so the fixture cannot gate it")


def small_reference(iq: np.ndarray) -> np.ndarray:
    """The JAX package's CPU audio for SMALL on `iq`, from the committed
    fixture; refuses an input that is not the one the fixture was made
    from."""
    with np.load(SMALL_REF) as d:
        _refuse_other_input(iq, str(d["iq_sha256"]), SMALL_REF.name)
        return d["audio"]


def mid_reference(tag: str, iq: np.ndarray) -> tuple:
    """The JAX package's CPU audio for the MID gate `tag` on `iq`, at the
    committed channel rows: (rows [R] in channel order, audio [1, R, n]);
    refuses an input that is not the fixture's."""
    with np.load(MID_REF) as d:
        _refuse_other_input(iq, str(d[f"{tag}_iq_sha256"]), MID_REF.name)
        return d[f"{tag}_rows"], d[f"{tag}_audio"]


def plain_audio(base_cfg: dict, iq: np.ndarray, **chain_kwargs
                ) -> np.ndarray:
    """The port's plain path on the host CPU: `WidebandConfig(**base_cfg)`
    with no tuning (the chan-major tier in float32, the configuration
    `bench.py`'s oracle runs), over `iq` [n_chunks, chunk_in]."""
    cfg = wideband.WidebandConfig(**base_cfg)
    params = wideband.make_params(cfg, device="cpu", **chain_kwargs)
    state = wideband.init_state(cfg, device="cpu")
    _, audio = wideband.process_many(cfg, params, state, iq)
    return audio.numpy()


def _oracle(base_cfg: dict, n_chunks: int, seed: int, tag: str,
            refs: dict):
    """(input, every row's reference, the JAX fixture's (rows, audio) or
    None where the first is the JAX package's own)."""
    if tag not in refs:
        iq = noise_input(base_cfg, n_chunks, seed)
        refs[tag] = ((iq, small_reference(iq), None) if tag == "small"
                     else (iq, plain_audio(base_cfg, iq),
                           mid_reference(tag, iq)))
    return refs[tag]


def _rows_of(cfg, bins: np.ndarray) -> np.ndarray:
    """The audio rows that carry channels `bins` (`audio_channel_order`)."""
    return np.argsort(wideband.audio_channel_order(cfg))[bins]


def _audio_np(audio: torch.Tensor, time_major: bool) -> np.ndarray:
    got = audio.float().cpu().numpy()
    return np.swapaxes(got, -1, -2) if time_major else got


def _gate(tuning: dict, base_cfg: dict, n_chunks: int, seed: int,
          tag: str, device, refs: dict) -> dict:
    """Run `base_cfg` + tuning on `device` against the oracle; require
    finite, nonzero, ≥ 50 dB agreement on every row and, where the
    reference is the port's own, on the JAX fixture's rows too. Rows are
    compared through `audio_channel_order`."""
    iq, ref, jax_ref = _oracle(base_cfg, n_chunks, seed, tag, refs)
    cfg = wideband.WidebandConfig(**base_cfg, **tuning)
    params = wideband.make_params(cfg, device=device)
    state = wideband.init_state(cfg, device=device)
    _, audio = wideband.process_many(cfg, params, state, iq)
    got = _audio_np(audio, tuning.get("time_major", False))
    snr = _snr_db(ref[:, wideband.audio_channel_order(cfg), :], got)
    ok = bool(np.isfinite(got).all() and np.abs(got).mean() > 0
              and snr >= 50.0)
    out = {f"oracle_snr_db_{tag}": round(float(snr), 1),
           f"audio_mean_abs_{tag}": round(float(np.abs(got).mean()), 6)}
    if jax_ref is not None:
        bins, jax_audio = jax_ref
        jsnr = _snr_db(jax_audio, got[:, _rows_of(cfg, bins), :])
        out[f"jax_snr_db_{tag}"] = round(float(jsnr), 1)
        ok = ok and jsnr >= 50.0
    return {**out, f"ok_{tag}": ok}


def nbfm_input(seed: int):
    """FM carriers at 16 channel centres (Carson-safe deviation: the
    discriminator wraps at ±fs_chan/2) over a −52 dB noise floor. On noise
    alone the angle of a near-zero sample is ill-defined and differs
    between correct implementations."""
    C, n = MID_NBFM["n_chan"], MID_NBFM["chunk_in"]
    fs = MID_NBFM["fs_in"]
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    z = 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    kbins = rng.choice(C, size=16, replace=False)
    for k in kbins:
        fk = (k if k < C // 2 else k - C) * (fs / C)
        g = rng.uniform(300.0, 1000.0)
        beta = rng.uniform(1.0, 2.5)
        z = z + 0.4 * np.exp(1j * (2 * np.pi * fk * t
                                   + beta * np.sin(2 * np.pi * g * t)))
    return z.astype(np.complex64)[None, :], kbins


def _gate_nbfm(tuning: dict, device, refs: dict, seed: int = 6) -> dict:
    """NBFM at the headline channel count, AGC off: with it on, both paths
    lift the ill-conditioned FIR ramp-up angles into the tracked peak and
    the decay carries that through the window. Compared on the carrier
    rows past the FIR and attack transient, against the port's plain path
    and the JAX fixture."""
    tag = "midnbfm"
    off = dict(agc_kwargs=dict(on=False))
    if tag not in refs:
        iq, kbins = nbfm_input(seed)
        jax_bins, jax_audio = mid_reference(tag, iq)
        if not np.array_equal(jax_bins, kbins):
            raise RuntimeError(f"{MID_REF.name}'s NBFM rows {jax_bins} "
                               f"are not the carriers {kbins}")
        refs[tag] = (iq, kbins, plain_audio(MID_NBFM, iq, **off), jax_audio)
    iq, kbins, ref, jax_audio = refs[tag]
    cfg = wideband.WidebandConfig(**MID_NBFM, **tuning)
    params = wideband.make_params(cfg, device=device, **off)
    state = wideband.init_state(cfg, device=device)
    _, audio = wideband.process_many(cfg, params, state, iq)
    got = _audio_np(audio, tuning.get("time_major", False))
    S = 1280                       # the FIR + attack transient
    gg = got[:, _rows_of(cfg, kbins), S:]
    snr = _snr_db(ref[:, kbins, S:], gg)
    jsnr = _snr_db(jax_audio[..., S:], gg)
    ok = bool(np.isfinite(gg).all() and np.abs(gg).mean() > 0
              and min(snr, jsnr) >= 50.0)
    return {"oracle_snr_db_midnbfm": round(float(snr), 1),
            "jax_snr_db_midnbfm": round(float(jsnr), 1),
            "audio_mean_abs_midnbfm": round(float(np.abs(gg).mean()), 6),
            "ok_midnbfm": ok}


def integrity_check(tuning: dict, device, refs: dict) -> dict:
    small = _gate(tuning, SMALL, 2, 0, "small", device, refs)
    mid = _gate(tuning, MID, 1, 2, "mid", device, refs)
    ssb = _gate(tuning, MID_SSB, 1, 4, "midssb", device, refs)
    nbfm = _gate_nbfm(tuning, device, refs)
    ok = all([small.pop("ok_small"), mid.pop("ok_mid"),
              ssb.pop("ok_midssb"), nbfm.pop("ok_midnbfm")])
    return {"integrity": "pass" if ok else "fail", **small, **mid, **ssb,
            **nbfm}


def consistent(prefix: float, mid_level: float) -> bool:
    """The headline's audio prefix level within 25 % of the MID gate's."""
    return abs(prefix - mid_level) <= 0.25 * mid_level


def _launches() -> tuple[int, int]:
    return (channelize_fused.channelize_fused_raw3.launches,
            chain_tail.chain_tail_fir.launches)


class KernelsNotLaunched(RuntimeError):
    """A timed loop on the card that did not launch the kernels once a
    chunk: a fault of the harness, never a figure's failure, so it ends
    the run whichever tier or figure it hit."""


def _check_launched(device, before: tuple, calls: int, what: str) -> None:
    """On the card each timed chunk launches the channelizer and the FIR
    tail kernel once; a count that did not move means a plain version or
    another tier ran."""
    if device.type != "cuda":
        return
    grew = tuple(a - b for a, b in zip(_launches(), before))
    if grew != (calls, calls):
        raise KernelsNotLaunched(
            f"{what}: {calls} timed chunks launched the channelizer and "
            f"FIR-tail kernels {grew} times")


def _fetch_stat(audio: torch.Tensor) -> float:
    # a device-side reduction over the whole audio; reading the scalar
    # waits for everything it depends on
    return float(audio.float().abs().mean())


def timed_step(cfg, params, device) -> tuple:
    """The timed step and its input: `process_n` over N_SCAN copies of one
    chunk of 0.05·normal made on `device` from a generator seeded with 1
    (`process` when N_SCAN is 1). (step(state) → (state, last audio),
    the input [N_SCAN, chunk_in])."""
    gen = torch.Generator(device=device).manual_seed(1)
    shp = (N_SCAN, cfg.chunk_in)
    iq_dev = cx.CX(0.05 * torch.randn(shp, generator=gen, device=device),
                   0.05 * torch.randn(shp, generator=gen, device=device))
    iq_single = cx.CX(iq_dev.re[0], iq_dev.im[0])
    if N_SCAN == 1:
        def step(st_):
            st2, out = wideband.process(cfg, params, st_, iq_single)
            return st2, out.audio
    else:
        iq_tup = (iq_single,) * N_SCAN

        def step(st_):
            st2, outs = wideband.process_n(cfg, params, st_, iq_tup)
            return st2, outs[-1]
    return step, iq_dev


def measure(tuning: dict, device, headline: dict = HEADLINE,
            refs: dict | None = None) -> dict:
    """Gates, then fetch-forced timing of `headline` + tuning on
    `device`. `refs` caches the oracle outputs across calls."""
    device = torch.device(device)
    refs = {} if refs is None else refs
    checks = integrity_check(tuning, device, refs)
    if checks["integrity"] != "pass":
        return {"value": 0.0, **checks}

    cfg = wideband.WidebandConfig(**headline, **tuning)
    params = wideband.make_params(cfg, device=device)
    state = wideband.init_state(cfg, device=device)
    step, iq_dev = timed_step(cfg, params, device)

    st, audio = step(state)                          # warm-up
    stat0 = _fetch_stat(audio)
    if not (np.isfinite(stat0) and stat0 > 0):
        raise RuntimeError(f"warm-up audio bad: {stat0}")

    samples_per_step = N_SCAN * cfg.chunk_in
    iters = 8
    while True:
        before = _launches()
        t0 = time.perf_counter()
        st_t = st
        for _ in range(iters):
            st_t, audio = step(st_t)
        stat = _fetch_stat(audio)
        dt = time.perf_counter() - t0
        if dt >= MIN_MEASURE_S or iters >= 256:
            break
        iters *= 2
    _check_launched(device, before, iters * N_SCAN, "timed loop")
    if not (np.isfinite(stat) and stat > 0):
        raise RuntimeError(f"timed audio bad: {stat}")

    # the MID gate ran the same channel count and input distribution for
    # 512 frames from a fresh state, so the headline's first 512 frames
    # (the same ensemble, the same AGC transient) must match its level;
    # whole-run means are not comparable across chunk lengths
    _, audio0 = wideband.process_many(cfg, params, state, iq_dev)
    L = cfg.chain_cfg.upsample
    if tuning.get("time_major"):
        prefix = _fetch_stat(audio0[0, : 512 * L, :])
    else:
        prefix = _fetch_stat(audio0[0, :, : 512 * L])
    del audio0
    if not consistent(prefix, checks["audio_mean_abs_mid"]):
        return {"value": 0.0, **checks, "integrity": "fail",
                "audio_mean_abs_headline_prefix": round(prefix, 6),
                "consistency": "headline prefix level diverges from "
                               "oracle-checked mid config"}

    out = {
        "value": round(samples_per_step * iters / dt / 1e6, 2),
        "step_ms": round(dt / iters * 1e3, 2),
        "elapsed_s": round(dt, 3),
        "iters": iters,
        "audio_mean_abs_headline": round(stat, 6),
        "audio_mean_abs_headline_prefix": round(prefix, 6),
        **checks,
    }
    if tuning.get("time_major"):
        try:
            out["i16_ingest"] = _measure_i16(cfg, params, state, iters,
                                             device)
        except KernelsNotLaunched:
            raise
        except Exception as e:    # the secondary must not kill the artifact
            out["i16_ingest"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _measure_i16(cfg, params, state, iters: int, device) -> dict:
    """int16 ingest (the KiwiSDR wire format): validated against the
    dequantized float32 chunk, then timed."""
    gen = torch.Generator(device=device).manual_seed(1)
    iq16 = tuple((0.05 * torch.randn(cfg.chunk_in, generator=gen,
                                     device=device) * 32768.0
                  ).to(torch.int16) for _ in range(2))
    deq = cx.CX(iq16[0].float() / 32768.0, iq16[1].float() / 32768.0)
    _, o16 = wideband.process_i16(cfg, params, state, iq16)
    _, of = wideband.process(cfg, params, state, deq)
    a16, af = o16.audio.float(), of.audio.float()
    num = float(torch.linalg.norm(af))
    den = float(torch.linalg.norm(a16 - af))
    i16_snr = 20.0 * np.log10(max(num, 1e-30) / max(den, 1e-30))
    if not i16_snr > 80.0:
        raise RuntimeError(f"i16 path diverges: {i16_snr:.1f} dB")
    it16 = max(iters // 2, 8)
    n16 = max(N_SCAN, 1)
    iq16_tup = (iq16,) * n16
    s16, o16s = wideband.process_n(cfg, params, state, iq16_tup)
    _fetch_stat(o16s[-1])
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(it16):
        s16, o16s = wideband.process_n(cfg, params, s16, iq16_tup)
    stat16 = _fetch_stat(o16s[-1])
    dt16 = time.perf_counter() - t0
    _check_launched(device, before, it16 * n16, "int16 timed loop")
    if not (np.isfinite(stat16) and stat16 > 0):
        raise RuntimeError(f"int16 timed audio bad: {stat16}")
    return {"value": round(n16 * cfg.chunk_in * it16 / dt16 / 1e6, 2),
            "step_ms": round(dt16 / it16 / n16 * 1e3, 2),
            "vs_f32_snr_db": round(i16_snr, 1)}


def device_info(device) -> dict:
    """The card's name and power limit as nvidia-smi gives them (power
    null where nvidia-smi is missing); the CPU by its device name."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": str(device), "power_limit": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(index),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
        name, power = (s.strip() for s in line.rsplit(",", 1))
        return {"name": name, "power_limit": power}
    except (OSError, subprocess.SubprocessError, ValueError):
        return {"name": torch.cuda.get_device_name(index),
                "power_limit": None}


def results(device, headline: dict = HEADLINE) -> dict:
    """Both tiers' measurements as `bench.py` reports them, plus the
    oracle of each gate and the device."""
    refs: dict = {}
    res = measure(PROFILES[PROFILE], device, headline, refs)
    out = {
        "metric": "wideband_iq_to_audio_throughput",
        "unit": "Msamples/s/chip",
        "vs_baseline": round(res["value"] / 500.0, 4),
        "baseline_definition": "north-star 1 Gsps aggregate / 2 hosts = "
                               "500 Msps per-host share",
        "profile": PROFILE,
        "config": {"n_chan": headline["n_chan"], "fs_in": headline["fs_in"],
                   "chunk_in": headline["chunk_in"], "n_scan": N_SCAN,
                   **PROFILES[PROFILE]},
        **res,
        "oracle": ORACLE,
        "device": device_info(device),
    }
    other = "quality" if PROFILE == "fast" else "fast"
    try:
        ores = measure(PROFILES[other], device, headline, refs)
        out[other] = {"unit": "Msamples/s/chip",
                      "config": dict(PROFILES[other]), **ores}
    except KernelsNotLaunched:
        raise
    except Exception as e:      # the secondary tier must not kill the line
        out[other] = {"error": f"{type(e).__name__}: {e}"}
    return out


def main(device=None, headline: dict = HEADLINE) -> int:
    """Print the JSON line; 1 unless the headline tier's integrity is
    "pass" and its value positive. `device`: the current card unless
    given."""
    out = results(default_device(device), headline)
    print(json.dumps(out), flush=True)
    return 0 if out["integrity"] == "pass" and out["value"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
