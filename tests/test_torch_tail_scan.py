"""The chain tail kernel's order of operations, modelled in float32 PyTorch
and held against the sample-by-sample recurrences in float64.

`csrc/chain_tail.cu` evaluates the DC block, the peak tracker, the hang and
the attack as scans: a warp owns a channel, a lane 8 consecutive samples of
a 256-sample piece; a lane scans its 8 serially, the 32 lane totals are
scanned in 5 doubling steps, and the prefix is applied. The peak tracker is
segmented (a running max of e + j·d restarted at each segment of `seg`
samples, p_prev − d chained from segment to segment by a sequential fold),
the hang ring is pushed once a segment. This file repeats that order with
float32 tensors — the kernel itself runs only on a CUDA device — and
checks that nothing drifts over a 16128-sample chunk: the decays below are
those with which a tracker that subtracted d once a sample lost 40 dB.
"""

import numpy as np
import pytest
import torch

LANES, RT = 32, 8
PIECE = LANES * RT
NEG = -3.0e38
F32 = torch.float32


def _powers(r):
    """r^1..r^8, r^16, r^32, r^64, r^128 as the kernel builds them."""
    r = torch.tensor(r, dtype=F32)
    out, v = [], r.clone()
    for _ in range(8):
        out.append(v.clone())
        v = v * r
    for _ in range(4):
        out.append(out[-1] * out[-1])
    return out


def _shift_up(v, s, fill):
    return torch.cat([torch.full((s,), fill, dtype=v.dtype), v[:-s]])


def scan_linear(x, init, pw):
    """x [32, 8] float32 → Σ_{k≤i} r^(i−k)·x[k] + r^(i+1)·init."""
    v = x.clone()
    acc = torch.zeros(LANES, dtype=F32)
    acc[0] = init
    for i in range(RT):
        acc = pw[0] * acc + v[:, i]
        v[:, i] = acc
    tot = acc.clone()
    lane = torch.arange(LANES)
    for k in range(5):
        up = _shift_up(tot, 1 << k, 0.0)
        tot = torch.where(lane >= (1 << k), tot + pw[7 + k] * up, tot)
    pre = _shift_up(tot, 1, 0.0)
    for i in range(RT):
        v[:, i] = v[:, i] + pw[i] * pre
    return v


def scan_segmax(x, init, j0, seg):
    """Running max of x [32, 8] restarted where the index within the
    segment is 0; j0 [32]: that index for each lane's first sample."""
    v = x.clone()
    run = torch.full((LANES,), NEG, dtype=F32)
    run[0] = init
    seen = torch.zeros(LANES, dtype=torch.bool)
    j = j0.clone()
    for i in range(RT):
        start = j == 0
        run = torch.where(start, torch.tensor(NEG, dtype=F32), run)
        seen = seen | start
        run = torch.maximum(run, v[:, i])
        v[:, i] = run
        j = torch.where(j + 1 == seg, 0, j + 1)
    tot, fl = run.clone(), seen.clone()
    lane = torch.arange(LANES)
    for k in range(5):
        s = 1 << k
        up = _shift_up(tot, s, NEG)
        fu = torch.cat([torch.zeros(s, dtype=torch.bool), fl[:-s]])
        act = lane >= s
        tot = torch.where(act & ~fl, torch.maximum(tot, up), tot)
        fl = torch.where(act, fl | fu, fl)
    pre = _shift_up(tot, 1, NEG)
    j = j0.clone()
    for i in range(RT):
        pre = torch.where(j == 0, torch.tensor(NEG, dtype=F32), pre)
        v[:, i] = torch.maximum(v[:, i], pre)
        j = torch.where(j + 1 == seg, 0, j + 1)
    return v


def kernel_order(env, *, r_dc, d, attack, seg, hang_tiles, thresh=-100.0,
                 slope=0.0, target=-12.0):
    """AM tail on an envelope [n] (float32 tensor), the kernel's way:
    pieces of 256, lanes of 8. Returns audio before the resampler."""
    n = env.shape[0]
    d32 = torch.tensor(d, dtype=F32)
    pw_dc, pw_at = _powers(r_dc), _powers(attack)
    one_m = torch.tensor(1.0, dtype=F32) - torch.tensor(attack, dtype=F32)
    s0 = torch.tensor(0.0, dtype=F32)
    s1 = torch.tensor(0.0, dtype=F32)
    peak = torch.tensor(-120.0, dtype=F32)
    g_prev = torch.tensor(0.0, dtype=F32)
    pbase = cm_c = m1_c = hist = torch.tensor(NEG, dtype=F32)
    ring = [torch.tensor(NEG, dtype=F32)] * hang_tiles
    head = 0
    out = []
    knee = max(-thresh, 1e-6)
    for n0 in range(0, n, PIECE):
        cnt = min(PIECE, n - n0)
        e = torch.zeros(PIECE, dtype=F32)
        e[:cnt] = env[n0:n0 + cnt]
        e = e.reshape(LANES, RT)
        idx = torch.arange(PIECE).reshape(LANES, RT)
        valid = idx < cnt
        j = (n0 + idx) % seg
        j0 = j[:, 0]
        q0 = n0 // seg
        k = (n0 + idx) // seg - q0
        fresh = n0 % seg == 0
        # DC block
        prev = torch.cat([s0[None], e.reshape(-1)[:-1]]).reshape(LANES, RT)
        u = scan_linear(e - prev, s1, pw_dc)
        s0, s1 = e.reshape(-1)[cnt - 1], u.reshape(-1)[cnt - 1]
        # peak tracker
        e_db = 8.685889638065035 * torch.log(torch.clamp_min(u.abs(), 1e-9))
        jd = j.to(F32) * d32
        cm = scan_segmax(torch.where(valid, e_db + jd,
                                     torch.tensor(NEG, dtype=F32)),
                         torch.tensor(NEG, dtype=F32) if fresh else cm_c,
                         j0, seg)
        cm_c = cm.reshape(-1)[cnt - 1]
        ends = [(q0 + i + 1) * seg - 1 - n0 for i in range(PIECE // seg + 2)]
        ends = [x for x in ends if x < cnt]
        pb = [peak - d32 if fresh else pbase]
        for x in ends:
            pb.append(torch.maximum(cm.reshape(-1)[x], pb[-1])
                      - torch.tensor(float(seg - 1), dtype=F32) * d32 - d32)
        pbt = torch.stack(pb)
        p = torch.maximum(cm, pbt[k.clamp_max(len(pb) - 1)]) - jd
        k_last = (n0 + cnt - 1) // seg - q0
        peak, pbase = p.reshape(-1)[cnt - 1], pbt[k_last]
        used = p
        if hang_tiles:
            m1 = scan_segmax(torch.where(valid, p,
                                         torch.tensor(NEG, dtype=F32)),
                             torch.tensor(NEG, dtype=F32) if fresh else m1_c,
                             j0, seg)
            m1_c = m1.reshape(-1)[cnt - 1]
            hb = [torch.stack(ring).max() if fresh else hist]
            for x in ends:
                ring[head] = m1.reshape(-1)[x]
                head = (head + 1) % hang_tiles
                hb.append(torch.stack(ring).max())
            hbt = torch.stack(hb)
            used = torch.maximum(m1, hbt[k.clamp_max(len(hb) - 1)])
            hist = hbt[k_last]
        above = (target - used) + slope * ((used - thresh) / knee)
        gain_db = torch.where(used <= thresh,
                              torch.tensor(target - thresh, dtype=F32),
                              above.to(F32))
        g = scan_linear(one_m * gain_db, g_prev, pw_at)
        g_prev = g.reshape(-1)[cnt - 1]
        audio = u * torch.exp(0.11512925464970229 * g)
        out.append(audio.reshape(-1)[:cnt])
    return torch.cat(out)


def sequential64(env, *, r_dc, d, attack, seg, hang_tiles, thresh=-100.0,
                 slope=0.0, target=-12.0):
    """The recurrences one sample at a time in float64; the peak tracker
    and the hang in their segmented definition (one j·d offset a segment,
    the ring pushed once a segment)."""
    env = np.asarray(env, np.float64)
    n = len(env)
    out = np.empty(n)
    s0 = s1 = g = 0.0
    peak = -120.0
    ring = [NEG] * hang_tiles
    head = 0
    knee = max(-thresh, 1e-6)
    pbase = cm = m1 = hist = NEG
    for t in range(n):
        a0 = (env[t] - s0) + r_dc * s1
        s0, s1 = env[t], a0
        e_db = 8.685889638065035 * np.log(max(abs(a0), 1e-9))
        j = t % seg
        if j == 0:
            pbase, cm = peak - d, NEG
            if hang_tiles:
                hist, m1 = max(ring), NEG
        cm = max(cm, e_db + j * d)
        peak = max(cm, pbase) - j * d
        pu = peak
        if hang_tiles:
            m1 = max(m1, peak)
            pu = max(m1, hist)
            if j + 1 == seg:
                ring[head] = m1
                head = (head + 1) % hang_tiles
        gain_db = (target - thresh) if pu <= thresh else \
            (target - pu) + slope * ((pu - thresh) / knee)
        g = attack * g + (1.0 - attack) * gain_db
        out[t] = a0 * np.exp(0.11512925464970229 * g)
    return out


def _envelope(n, seed):
    """An AM envelope with fades, bursts and a quiet stretch: the peak
    tracker both follows and decays."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 12_000.0
    env = 0.3 * (1 + 0.6 * np.sin(2 * np.pi * 700.0 * t))
    env *= 0.55 + 0.45 * np.sin(2 * np.pi * 1.3 * t + 0.4)
    env[n // 3:n // 3 + 900] *= 0.02
    env[2 * n // 3:2 * n // 3 + 40] *= 3.0
    return (env + 0.01 * np.abs(rng.normal(size=n))).astype(np.float32)


def _snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return 20 * np.log10(np.linalg.norm(ref)
                         / max(np.linalg.norm(got - ref), 1e-300))


# decay per sample in dB: 20 ms, 300 ms and 4 s to fall 60 dB at 12 kHz (a
# per-sample subtraction drifts by n·ulp(peak) against these)
DECAYS = {"fast": 60.0 / (0.020 * 12_000), "medium": 60.0 / (0.3 * 12_000),
          "slow": 60.0 / (4.0 * 12_000)}


@pytest.mark.parametrize("hang_tiles", [0, 3], ids=["hang-off", "hang-on"])
@pytest.mark.parametrize("decay", sorted(DECAYS))
@pytest.mark.parametrize("seg", [64, 256, 1008, 1024])
def test_scanned_tail_matches_the_recurrence_over_a_headline_chunk(
        seg, decay, hang_tiles):
    """16128 samples (16384 where seg = 1024 must divide the chunk):
    audio-domain agreement ≥ 100 dB, segments shorter than, equal to and
    longer than the 256-sample piece."""
    n = 16384 if seg == 1024 else 16128
    env = _envelope(n, seed=seg)
    kw = dict(r_dc=0.995, d=DECAYS[decay], attack=float(np.exp(-1 / 24.0)),
              seg=seg, hang_tiles=hang_tiles, thresh=-100.0, slope=0.0,
              target=-12.0)
    got = kernel_order(torch.from_numpy(env), **kw).numpy()
    ref = sequential64(env, **kw)
    assert np.isfinite(got).all()
    assert _snr_db(ref, got) >= 100.0


@pytest.mark.parametrize("n", [640, 13 * 8, 300])
def test_ragged_last_piece_carries_the_right_sample(n):
    """A chunk that ends inside a piece: the carries come from the last
    valid sample, so two chained chunks equal one long one."""
    seg = n // 4 if n % 4 == 0 else n
    env = _envelope(2 * n, seed=n)
    kw = dict(r_dc=0.995, d=DECAYS["medium"], attack=0.9, seg=seg,
              hang_tiles=2)
    got = kernel_order(torch.from_numpy(env[:n]), **kw).numpy()
    ref = sequential64(env[:n], **kw)
    assert _snr_db(ref, got) >= 100.0


@pytest.mark.parametrize("r", [0.995, 0.9592, 0.5])
def test_linear_scan_is_the_recurrence(r):
    rng = np.random.default_rng(3)
    x = rng.normal(size=PIECE).astype(np.float32)
    got = scan_linear(torch.from_numpy(x).reshape(LANES, RT), 0.7,
                      _powers(r)).reshape(-1).numpy()
    ref, acc = np.empty(PIECE), 0.7
    for i in range(PIECE):
        acc = r * acc + float(x[i])
        ref[i] = acc
    assert _snr_db(ref, got) >= 120.0


@pytest.mark.parametrize("seg", [1, 3, 8, 100, 256, 999])
def test_segmented_max_restarts_at_every_segment(seg):
    rng = np.random.default_rng(seg)
    x = rng.normal(size=PIECE).astype(np.float32)
    off = 5 % seg
    j0 = (off + torch.arange(LANES) * RT) % seg
    got = scan_segmax(torch.from_numpy(x).reshape(LANES, RT), 0.25, j0,
                      seg).reshape(-1).numpy()
    ref, run = np.empty(PIECE, np.float32), np.float32(0.25)
    for i in range(PIECE):
        if (off + i) % seg == 0:
            run = np.float32(NEG)
        run = max(run, x[i])
        ref[i] = run
    assert np.array_equal(got, ref)
