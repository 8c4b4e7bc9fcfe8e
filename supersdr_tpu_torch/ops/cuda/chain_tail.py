"""Chain tails: [passband FIR →] RSSI → demod → DC → AGC (+hang) → ×L
resample, per channel.

Counterparts of `supersdr_tpu/ops/pallas/chain_tail.py`:

  chain_tail_fir  `_kernel_fir` (`chain_tail_am(fir=…)`): the passband FIR
                  in front, reading the channelizer's raw planar planes
                  (the planar wideband path);
  chain_tail_am   `_kernel` (`chain_tail_am` without `fir`): the tail on an
                  already filtered passband y [nf, C] given as two float32
                  planes by element strides, time-major audio [nf·L, C]
                  (the time-major wideband tier); on the CPU also
                  chain-major audio [C, nf·L];
  chain_tail_am_c the same tail on a complex64 passband [C, nf] handed
                  over as it lies, chain-major audio [C, nf·L] (the chain's
                  tail tier and the chan-major wideband tier).

The kernels are the entries of `csrc/chain_tail.cu`; `chain_tail_plain`
and `chain_tail_am_plain` are the same functions in plain PyTorch,
vectorised over channels, with the reference's tiles of `tile_t` samples
and its in-tile doubling scans, so they track the reference's rounding
closely. Each wrapper runs the plain version for CPU tensors and its
kernel for CUDA tensors.

Layouts on the card. The two time-major entries (`chain_tail_fir`,
`chain_tail_am`) run blocks of 8 channels and store the audio's rows 8
channels (32 bytes) at a time by element strides, any layout; their
resampler is register-blocked (a thread: one channel, 4 consecutive input
samples). `chain_tail_fir` keeps the raw planes' rows of 8 channels as
they lie (16 bytes of bf16 a time step; float32 rows split in place into
two bf16 pieces) in a ring that its tensor-core FIR reads with
`ldmatrix.trans`, and runs the FIR of the next tile beside the scans of
this one (two y buffers). `chain_tail_am` reads its planes by element strides and launches
clusters of 4 blocks, which keep step tile by tile so the four 32-byte
pieces of a 128-byte line are written close together. `chain_tail_am_c`
reads the complex rows in 16-byte pieces (`wide_rows_ok`), a warp a
channel, and writes chain-major audio in whole lines.

Parameter vector (9 float32 slots):
  0 AM DC pole r | NBFM scale fs/(2π·max_dev), 1 peak decay per sample (dB),
  2 thresh, 3 slope, 4 target, 5 manual gain, 6 agc on, 7 attack coeff,
  8 hang on (honoured by both tails when a hang window is given).
State rows [4 + per, C]: 0 dc_x | previous re, 1 dc_y | previous im,
  2 peak dB, 3 gain dB, 4 … 4+per−2 resample tail (oldest first),
  4+per−1 Σ|y|² of the chunk (output only; 0 when not accumulated).
AGC hang is the reference's tile-granular ring: the held peak is the max of
the tile's running raw peak and the previous `hang_tiles` tile maxima
(tiles of `tile_t` samples, the ring empty at each chunk's start); the
state peak at the chunk's end is the held value.
"""

from __future__ import annotations

import ctypes

import torch

from supersdr_tpu_torch import _build
from supersdr_tpu_torch.ops.agc import ENV_FLOOR
from supersdr_tpu_torch.ops.cuda import check_fp32_matmul
from supersdr_tpu_torch.ops.demod import NBFM_MUTE_FLOOR

DEMODS = {"am": 0, "ssb": 1, "nbfm": 2}
N_PARAMS = 9
_LOG10_E20 = 8.685889638065035      # 20/ln(10)
_LN10_D20 = 0.11512925464970229     # ln(10)/20
_NEG_BIG = -3.0e38


def hang_tiles_for(hang_window: int, tile_t: int) -> int:
    """Ring length of the tile-granular hang: ceil((W − 1)/T), 0 when the
    window is off (≤ 1)."""
    return -(-(hang_window - 1) // tile_t) if hang_window > 1 else 0


def _shift_down(w: torch.Tensor, s: int) -> torch.Tensor:
    return torch.cat([w.new_zeros((s,) + w.shape[1:]), w[:-s]], dim=0)


def _doubling_linear(w: torch.Tensor, pows: list) -> torch.Tensor:
    """y[n] = Σ_{k≤n} a^(n−k)·w[k] along dim 0 by log-depth doubling;
    pows[i] = a^(2^i) — the reference's in-tile scan."""
    s, i = 1, 0
    while s < w.shape[0]:
        w = w + pows[i] * _shift_down(w, s)
        s *= 2
        i += 1
    return w


def _squarings(a: torch.Tensor, T: int) -> list:
    out = []
    s = 1
    while s < T:
        out.append(a)
        a = a * a
        s *= 2
    return out


def _planar_time_major(x: torch.Tensor) -> torch.Tensor:
    """[n1, nf, n2] raw planes → [nf, C] float32, C = k1·n2 + col."""
    n1, nf, n2 = x.shape
    return x.permute(1, 0, 2).reshape(nf, n1 * n2).float()


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fir_plain(x_r, x_i, head_r, head_i, w2, *, n_taps: int, B: int,
               n_prev: int, fir_bf16: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocked-Toeplitz FIR over the whole chunk → y planes [nf, C]:
    window i covers ext[i·B, i·B + W) with ext = [zeros | history | x]."""
    check_fp32_matmul(x_r)
    xr, xi = _planar_time_major(x_r), _planar_time_major(x_i)
    nf, C = xr.shape
    ov = n_taps - 1
    PH, Wn = n_prev * B, (n_prev + 1) * B
    pad = xr.new_zeros(PH - ov, C)
    ext_r = torch.cat([pad, head_r, xr], dim=0)
    ext_i = torch.cat([pad, head_i, xi], dim=0)
    w = w2
    if fir_bf16:
        ext_r, ext_i, w = _bf16(ext_r), _bf16(ext_i), _bf16(w2)
    zr = ext_r.unfold(0, Wn, B)                  # [nb, C, W]
    zi = ext_i.unfold(0, Wn, B)
    if w2.shape[1] == B:                          # real taps
        yr = (zr @ w).permute(0, 2, 1).reshape(nf, C)
        yi = (zi @ w).permute(0, 2, 1).reshape(nf, C)
    else:
        o = torch.cat([zr, zi], dim=-1) @ w      # [nb, C, 2B]
        yr = o[..., :B].permute(0, 2, 1).reshape(nf, C)
        yi = o[..., B:].permute(0, 2, 1).reshape(nf, C)
    return yr, yi


def _tail_plain(yr: torch.Tensor, yi: torch.Tensor, st_rows, params, P, *,
                tile_t: int, demod: str, rs_bf16: bool, hang_tiles: int,
                accum_pow: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The tail per tile, as the reference's _tail_core, on y planes
    [nf, C] → (audio [nf·L, C], state rows out)."""
    nf, C = yr.shape
    T = tile_t
    PER, L = P.shape
    r_dc, d, thresh, slope, target, man_gain, agc_on, attack, hang_on = \
        params
    c0, c1, c2, c3 = (st_rows[i].clone() for i in range(4))
    tail = st_rows[4:4 + PER - 1]
    pw = torch.zeros(C, dtype=torch.float32, device=yr.device)
    ring = torch.full((hang_tiles, C), _NEG_BIG, dtype=torch.float32,
                      device=yr.device)
    ramp = torch.arange(T, dtype=torch.float32, device=yr.device)[:, None]
    pows_dc = _squarings(r_dc, T)
    pows_at = _squarings(attack, T)
    rn1 = torch.exp(torch.log(torch.clamp_min(r_dc, 1e-12)) * (ramp + 1.0))
    an1 = torch.exp(torch.log(torch.clamp_min(attack, 1e-12)) * (ramp + 1.0))
    jd = ramp * d
    Pm = _bf16(P) if rs_bf16 else P
    outs = []
    for t0 in range(0, nf, T):
        tr, ti = yr[t0:t0 + T], yi[t0:t0 + T]
        if accum_pow:
            pw = pw + torch.sum(tr * tr + ti * ti, dim=0)
        if demod == "ssb":
            a0 = tr
        elif demod == "nbfm":
            pr = torch.cat([c0[None], tr[:-1]], dim=0)
            pi = torch.cat([c1[None], ti[:-1]], dim=0)
            dotp = tr * pr + ti * pi
            cross = ti * pr - tr * pi
            mag = dotp.abs() + cross.abs()
            a0 = torch.where(mag > NBFM_MUTE_FLOOR,
                             torch.atan2(cross, dotp) * r_dc,
                             torch.zeros_like(mag))
            c0, c1 = tr[-1], ti[-1]
        else:
            env = torch.sqrt(tr * tr + ti * ti)
            diff = env - torch.cat([c0[None], env[:-1]], dim=0)
            a0 = _doubling_linear(diff, pows_dc) + rn1 * c1
            c0, c1 = env[-1], a0[-1]
        env_db = _LOG10_E20 * torch.log(torch.clamp_min(a0.abs(), ENV_FLOOR))
        cm = torch.cummax(env_db + jd, dim=0).values
        peak = torch.maximum(cm, c2 - d) - jd
        c2 = peak[-1]
        used = peak
        if hang_tiles:
            m1 = torch.cummax(peak, dim=0).values
            held = torch.maximum(m1, ring.max(dim=0).values)
            used = torch.where(hang_on > 0, held, peak)
            ring = torch.cat([ring[1:], m1[-1:]], dim=0)
        above = (target - used) + slope * ((used - thresh)
                                           / torch.clamp_min(-thresh, 1e-6))
        auto = torch.where(used <= thresh, target - thresh, above)
        gain_db = torch.where(agc_on > 0, auto, man_gain - 50.0)
        g = _doubling_linear((1.0 - attack) * gain_db, pows_at) + an1 * c3
        c3 = g[-1]
        audio1 = a0 * torch.exp(_LN10_D20 * g)
        seg = torch.cat([tail, audio1], dim=0)
        tail = seg[-(PER - 1):]
        if rs_bf16:
            seg = _bf16(seg)
        out = Pm[0][None, :, None] * seg[0:T, None, :]
        for m in range(1, PER):
            out = out + Pm[m][None, :, None] * seg[m:m + T, None, :]
        outs.append(out.reshape(T * L, C))
    if hang_tiles:
        c2 = torch.where(hang_on > 0, held[-1], c2)
    st_out = torch.cat([torch.stack([c0, c1, c2, c3]), tail, pw[None]], 0)
    return torch.cat(outs, dim=0), st_out


def chain_tail_plain(x_r, x_i, head_r, head_i, st_rows, params, w2, P, *,
                     n_taps: int, B: int, n_prev: int, tile_t: int,
                     demod: str, fir_bf16: bool, rs_bf16: bool,
                     hang_window: int = 0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch FIR tail (see `chain_tail_fir` for the arguments)."""
    yr, yi = _fir_plain(x_r, x_i, head_r, head_i, w2, n_taps=n_taps, B=B,
                        n_prev=n_prev, fir_bf16=fir_bf16)
    return _tail_plain(yr, yi, st_rows, params, P, tile_t=tile_t,
                       demod=demod, rs_bf16=rs_bf16,
                       hang_tiles=hang_tiles_for(hang_window, tile_t),
                       accum_pow=True)


def _check(dev, specs) -> None:
    """Raise unless each (name, tensor, dtypes, shape[, contiguous]) is on
    `dev` with one of the dtypes and the shape."""
    for name, t, dts, shape, *contig in specs:
        want_contig = contig[0] if contig else True
        if t.device != dev or t.dtype not in dts \
                or tuple(t.shape) != shape \
                or (want_contig and not t.is_contiguous()):
            raise ValueError(f"{name}: expected {dts} {shape} on {dev}"
                             f"{' (contiguous)' if want_contig else ''}, "
                             f"got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_fir(x_r, x_i, head_r, head_i, st_rows, params, w2, P, *,
                n_taps, B, n_prev, tile_t, demod, fir_bf16, rs_bf16,
                hang_window):
    lib = _build.load()
    n1, nf, n2 = x_r.shape
    C = n1 * n2
    if n2 % lib.chain_tail_channels_per_block():
        raise ValueError("n2 must be a multiple of the kernel's channel "
                         "block")
    PER, L = P.shape
    fir_complex = w2.shape[1] != B
    audio = torch.empty(nf * L, C, dtype=torch.float32, device=x_r.device)
    st_out = torch.empty_like(st_rows)
    p = ctypes.c_void_p
    # the kernel reads the taps out of the Toeplitz matrix, Wt[p − k, 0] =
    # h[k] (im at column B of the complex-folded one), and rounds them to
    # bf16 itself: no small launches in front of it
    err = lib.chain_tail_fir(
        p(x_r.data_ptr()), p(x_i.data_ptr()),
        int(x_r.dtype == torch.bfloat16), n1, nf, n2,
        p(head_r.data_ptr()), p(head_i.data_ptr()), p(w2.data_ptr()),
        w2.shape[1], n_prev * B, n_taps, int(fir_complex), int(fir_bf16),
        p(P.data_ptr()), PER, L, int(rs_bf16), p(params.data_ptr()),
        DEMODS[demod], tile_t, hang_tiles_for(hang_window, tile_t),
        p(st_rows.data_ptr()), p(st_out.data_ptr()), p(audio.data_ptr()),
        _stream(x_r))
    _build.check(err, "chain_tail_fir")
    chain_tail_fir.launches += 1
    return audio, st_out


def chain_tail_fir(x_r: torch.Tensor, x_i: torch.Tensor,
                   head_r: torch.Tensor, head_i: torch.Tensor,
                   st_rows: torch.Tensor, params: torch.Tensor,
                   w2: torch.Tensor, P: torch.Tensor, *, n_taps: int,
                   B: int, n_prev: int, tile_t: int, demod: str,
                   fir_bf16: bool, rs_bf16: bool, hang_window: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the FIR tail on one chunk.

    x_r/x_i: raw channelizer planes [n1, nf, n2] (float32 or bfloat16);
    head_r/head_i: [n_taps−1, C] float32 input history, planar order;
    st_rows: [4 + per, C] state rows; params: [9] (module docstring);
    w2: the passband Toeplitz matrix, real [W, B] or complex-folded
    [2W, 2B] (`fir_matmul.build_w_free[_real]`); P: [per, L] polyphase
    matrix. fir_bf16 / rs_bf16 round the FIR / resampler operands to bf16
    (the kernel runs the FIR on the tensor cores either way: one pass on
    bf16 operands, three on float32 operands split in two bf16 pieces).
    tile_t is the reference's tail tile: the plain version scans in tiles
    of it, and both apply the peak tracker's decay as one offset per tile
    and hang in tiles of it (the kernel scans in pieces of 256 samples, a
    warp a channel, whatever the tile); hang_window: the AGC hang window in
    samples (≤ 1 = none).
    Returns (audio [nf·L, C] float32, state rows out)."""
    n1, nf, n2 = x_r.shape
    C = n1 * n2
    PER, L = P.shape
    ov = n_taps - 1
    if demod not in DEMODS:
        raise ValueError(f"demod must be one of {sorted(DEMODS)}")
    if nf % B or nf % tile_t or n_prev * B < ov:
        raise ValueError("chunk must be a multiple of B and tile_t, and "
                         "n_prev·B must cover n_taps − 1")
    dev = x_r.device
    _check(dev, (
        ("x_r", x_r, (torch.float32, torch.bfloat16), (n1, nf, n2)),
        ("x_i", x_i, (x_r.dtype,), (n1, nf, n2)),
        ("head_r", head_r, (torch.float32,), (ov, C)),
        ("head_i", head_i, (torch.float32,), (ov, C)),
        ("st_rows", st_rows, (torch.float32,), (4 + PER, C)),
        ("params", params, (torch.float32,), (N_PARAMS,)),
        ("w2", w2, (torch.float32,), ((n_prev + 1) * B, B)
         if w2.shape[1] == B else (2 * (n_prev + 1) * B, 2 * B)),
        ("P", P, (torch.float32,), (PER, L))))
    kw = dict(n_taps=n_taps, B=B, n_prev=n_prev, tile_t=tile_t,
              demod=demod, fir_bf16=fir_bf16, rs_bf16=rs_bf16,
              hang_window=hang_window)
    if dev.type == "cpu":
        return chain_tail_plain(x_r, x_i, head_r, head_i, st_rows, params,
                                w2, P, **kw)
    if dev.type == "cuda":
        return _launch_fir(x_r, x_i, head_r, head_i, st_rows, params, w2, P,
                           **kw)
    raise ValueError(f"unsupported device {dev}")


chain_tail_fir.launches = 0


def _check_am(dev, C: int, nf: int, st_rows, params, P, tile_t: int,
              demod: str) -> None:
    """Raise unless the non-FIR tail's other arguments fit C channels and
    nf samples on `dev`."""
    PER, L = P.shape
    if demod not in DEMODS:
        raise ValueError(f"demod must be one of {sorted(DEMODS)}")
    if nf % tile_t:
        raise ValueError("chunk must be a multiple of tile_t")
    _check(dev, (
        ("st_rows", st_rows, (torch.float32,), (4 + PER, C)),
        ("params", params, (torch.float32,), (N_PARAMS,)),
        ("P", P, (torch.float32,), (PER, L))))


def chain_tail_am_plain(yT_r, yT_i, st_rows, params, P, *, tile_t: int,
                        demod: str, accum_pow: bool = False,
                        hang_window: int = 0, audio_layout: str = "time"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch non-FIR tail (see `chain_tail_am`)."""
    audio, st_out = _tail_plain(
        yT_r.float(), yT_i.float(), st_rows, params, P, tile_t=tile_t,
        demod=demod, rs_bf16=False,
        hang_tiles=hang_tiles_for(hang_window, tile_t), accum_pow=accum_pow)
    return (audio.T.contiguous() if audio_layout == "chan" else audio,
            st_out)


def _launch_am(yT_r, yT_i, st_rows, params, P, *, tile_t, demod, accum_pow,
               hang_window):
    lib = _build.load()
    nf, C = yT_r.shape
    PER, L = P.shape
    audio = torch.empty(nf * L, C, dtype=torch.float32, device=yT_r.device)
    a_st, a_sc = audio.stride()
    st_out = torch.empty_like(st_rows)
    p = ctypes.c_void_p
    err = lib.chain_tail_am(
        p(yT_r.data_ptr()), p(yT_i.data_ptr()), yT_r.stride(0),
        yT_r.stride(1), nf, C, p(P.data_ptr()), PER, L,
        p(params.data_ptr()), DEMODS[demod], tile_t,
        hang_tiles_for(hang_window, tile_t), int(accum_pow),
        p(st_rows.data_ptr()), p(st_out.data_ptr()), p(audio.data_ptr()),
        a_st, a_sc, _stream(yT_r))
    _build.check(err, "chain_tail_am")
    chain_tail_am.launches += 1
    return audio, st_out


def chain_tail_am(yT_r: torch.Tensor, yT_i: torch.Tensor,
                  st_rows: torch.Tensor, params: torch.Tensor,
                  P: torch.Tensor, *, tile_t: int, demod: str,
                  accum_pow: bool = False, hang_window: int = 0,
                  audio_layout: str = "time"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the non-FIR tail on one chunk of an already filtered passband.

    yT_r/yT_i: float32 [nf, C] planes of y's real and imaginary parts, any
    positive strides (the kernel reads 8 channels side by side, so
    time-major planes); st_rows: [4 + per, C] state rows; params: [9]; P:
    [per, L]. tile_t: the reference's tail tile (a divisor of nf: the peak
    segment and the hang tile); accum_pow: fill the power row with Σ|y|²;
    hang_window: the AGC hang window in samples (≤ 1 = none);
    audio_layout: "time" → audio [nf·L, C], "chan" → [C, nf·L], the latter
    on the CPU only (on the card chain-major audio comes from
    `chain_tail_am_c`, which reads the complex passband as it lies).
    Returns (audio, state rows out)."""
    nf, C = yT_r.shape
    if audio_layout not in ("time", "chan"):
        raise ValueError("audio_layout must be 'time' or 'chan'")
    dev = yT_r.device
    _check(dev, (("yT_r", yT_r, (torch.float32,), (nf, C), False),
                 ("yT_i", yT_i, (torch.float32,), (nf, C), False)))
    _check_am(dev, C, nf, st_rows, params, P, tile_t, demod)
    if min(yT_r.stride()) < 1 or yT_r.stride() != yT_i.stride():
        raise ValueError("yT_r and yT_i need the same positive strides")
    kw = dict(tile_t=tile_t, demod=demod, accum_pow=accum_pow,
              hang_window=hang_window)
    if dev.type == "cpu":
        return chain_tail_am_plain(yT_r, yT_i, st_rows, params, P,
                                   audio_layout=audio_layout, **kw)
    if dev.type == "cuda":
        if audio_layout != "time":
            raise ValueError("on the card chain-major audio comes from "
                             "chain_tail_am_c")
        return _launch_am(yT_r, yT_i, st_rows, params, P, **kw)
    raise ValueError(f"unsupported device {dev}")


chain_tail_am.launches = 0


def wide_rows_ok(y: torch.Tensor) -> bool:
    """Whether the chain-major kernel reads complex64 y [C, nf] in 16-byte
    pieces: contiguous in time, the first element and every row 16-byte
    aligned (an even row stride), rows not overlapping."""
    return (y.stride(1) == 1 and y.stride(0) % 2 == 0
            and y.stride(0) >= y.shape[1] and y.data_ptr() % 16 == 0)


def _launch_am_c(y, st_rows, params, P, *, tile_t, demod, accum_pow,
                 hang_window):
    lib = _build.load()
    C, nf = y.shape
    PER, L = P.shape
    audio = torch.empty(C, nf * L, dtype=torch.float32, device=y.device)
    st_out = torch.empty_like(st_rows)
    p = ctypes.c_void_p
    err = lib.chain_tail_am_c(
        p(y.data_ptr()), y.stride(0), nf, C, p(P.data_ptr()), PER, L,
        p(params.data_ptr()), DEMODS[demod], tile_t,
        hang_tiles_for(hang_window, tile_t), int(accum_pow),
        p(st_rows.data_ptr()), p(st_out.data_ptr()), p(audio.data_ptr()),
        audio.stride(0), _stream(y))
    _build.check(err, "chain_tail_am_c")
    chain_tail_am_c.launches += 1
    return audio, st_out


def chain_tail_am_c(y: torch.Tensor, st_rows: torch.Tensor,
                    params: torch.Tensor, P: torch.Tensor, *, tile_t: int,
                    demod: str, accum_pow: bool = False,
                    hang_window: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the non-FIR tail on one chunk of a chain-major passband.

    y: complex64 [C, nf], positive strides; audio comes out chain-major
    [C, nf·L]; the rest as `chain_tail_am`. On the card y's rows must pass
    `wide_rows_ok` (the kernel reads them in 16-byte pieces, a warp a
    channel), else this raises; the chain's passband always does. On the
    CPU any strides go to the plain version. Returns (audio, state rows
    out)."""
    if y.dtype != torch.complex64 or y.dim() != 2:
        raise ValueError(f"y: expected complex64 [C, nf], got {y.dtype} "
                         f"{tuple(y.shape)}")
    if min(y.stride()) < 1:
        raise ValueError("y needs positive strides")
    C, nf = y.shape
    kw = dict(tile_t=tile_t, demod=demod, accum_pow=accum_pow,
              hang_window=hang_window)
    if y.device.type != "cuda":
        return chain_tail_am(y.real.T, y.imag.T, st_rows, params, P,
                             audio_layout="chan", **kw)
    if not wide_rows_ok(y):
        raise ValueError("y: the card reads rows contiguous in time, "
                         "16-byte aligned, with an even row stride")
    _check_am(y.device, C, nf, st_rows, params, P, tile_t, demod)
    return _launch_am_c(y, st_rows, params, P, **kw)


chain_tail_am_c.launches = 0
