"""The FIR tail's window, modelled in numpy.

In `csrc/chain_tail.cu` (`chain_tail_fir_kernel`, `fir_tile`) the input
rows of 8 channels (16 bytes of bf16 each) sit in a ring of R slots, input
row τ at slot τ mod R, the history from `head` at τ < 0. A warp's FIR reads
its B fragments with `ldmatrix.x4.trans`, each lane naming one row: lane l
names plane l / 16 and row l % 16 of a 16-row k-block, so the ring's wrap is
an address and no row is moved. The tile at t0 is copied in after the FIR
of the tile before it, into the slots of the tile two before it. The A
fragments are 32-bit words of the two shifted, reversed tap copies.

This file repeats that index arithmetic and the kernel's order of copies
and FIRs (the kernel runs only on a CUDA device), and checks that every
output of every tile is the direct sum Σ_k h[k]·x[t − k] over the n_taps
taps and their inputs, for the headline's 257 taps, shorter and longer
passbands (histories shorter and longer than the 256-row tile) and a
ragged last tile; that the ldmatrix phases and the accumulator stores are
conflict-free; that the shared area fits three blocks an SM at the
headline, also with a long hang; and that it fits a block's opt-in limit
for every passband the in-tail FIR block planner accepts.
"""

import numpy as np
import pytest

KCB, KTILE, KGPAD = 8, 256, 16
SMEM_3_BLOCKS = 76800          # bytes a block when three share an SM
SMEM_OPT_IN = 232448           # the most shared bytes a block may have


def skew(t):
    return t + (t >> 5)


def fir_stride(n):
    return (n + 3) // 8 * 8 + 4


class Layout:
    """`FirLayout` of the kernel."""

    def __init__(self, ov, per=9, seg=896, split=False, x_bf16=True):
        self.T = KTILE
        self.OVP = -(-ov // 16) * 16
        self.glen = self.OVP + 64
        self.R = 256
        while self.R < self.OVP + self.T:
            self.R *= 2
        self.np = 2 if split else 1
        self.nr = 2 if split or not x_bf16 else 1
        self.H = max(32, -(-(per - 1) // 32) * 32)
        self.Sre = fir_stride(skew(self.H + self.T))
        self.Sim = fir_stride(skew(self.T))
        self.nsegs = KTILE // seg + 2

    def floats(self, per, L, hang_tiles):
        ybuf = KCB * (self.Sre + self.Sim)
        carry = 11                   # floats of a channel's Carry
        return (self.np * 4 * self.glen // 2 + 4 * self.nr * 2 * self.R
                + 2 * ybuf + per * L + 2 * 12 + 4 * KCB * self.nsegs
                + hang_tiles * KCB + KCB * carry)


def tap_copies(h, fl):
    """The two shifted copies of G (one piece, real taps): copy s, element
    pos holds h[OVP − (pos + s − kGPad)], zero outside the band."""
    ov = len(h) - 1
    out = np.zeros((2, fl.glen))
    for s in range(2):
        for pos in range(fl.glen):
            k = fl.OVP - (pos + s - KGPAD)
            if 0 <= k <= ov:
                out[s, pos] = h[k]
    return out


def a_block(G, D):
    """The 16×16 A block of k-step D as the lanes' words give it: row m =
    g + 8·half reads copy g & 1 at element 2·xw + 2·(D/2) − 8·half + kk −
    2·tig, i.e. kGPad − g − (g & 1) + D + kk − 8·half."""
    A = np.zeros((16, 16))
    for m in range(16):
        g, half = m % 8, m // 8
        for kk in range(16):
            tig = (kk % 8) // 2
            xw = (KGPAD + 2 * tig - g - (g & 1)) // 2
            word = xw + D // 2 + (4 if kk >= 8 else 0) - 4 * half
            A[m, kk] = G[g & 1, 2 * word + (kk & 1)]
    return A


def ldsm(ring, fl, s_lane0):
    """ldmatrix.x4.trans of the ring: lane l names slot (s + l % 16) mod R
    of plane l / 16; returns B [2 planes][16 k][8 channels]."""
    B = np.zeros((2, 16, KCB))
    for lane in range(32):
        B[lane >> 4, lane & 15] = ring[lane >> 4,
                                       (s_lane0 + (lane & 15)) % fl.R]
    return B


def fir_tile(ring, fl, G, t0):
    """y [2][T][8] of the tile at t0 as the 8 warps compute it."""
    T, tiles = fl.T, fl.T // 16 // KCB
    y = np.zeros((2, T, KCB))
    tau0 = t0 - fl.OVP
    for w in range(KCB):
        for rp in range(0, tiles, 2):
            m0 = (w * tiles + rp) * 16
            acc = np.zeros((2, 2, 16, KCB))      # [tile][plane]
            b = ldsm(ring, fl, tau0 + m0)
            for D in range(0, fl.OVP + 1, 16):
                c = ldsm(ring, fl, tau0 + m0 + D + 16)
                A = a_block(G, D)
                for pl in range(2):
                    acc[0, pl] += A @ b[pl]
                    acc[1, pl] += A @ c[pl]
                b = c
            for q in range(2):
                y[:, m0 + 16 * q:m0 + 16 * q + 16] = acc[q]
    return y


def run_chunk(h, head, x, fl):
    """Every tile's y, with the ring filled in the kernel's order: history,
    tile 0, FIR(0), tile 1; then per tile t0: FIR(t0 + T), copies of the
    tile at t0 + 2T."""
    nf, T, R = x.shape[1], fl.T, fl.R
    ov = len(h) - 1
    ring = np.full((2, R, KCB), np.nan)
    for tau in range(-fl.OVP, 0):
        ring[:, tau % R] = head[:, tau + ov] if tau >= -ov else 0.0

    def fetch(t0):
        for row in range(T):
            ring[:, (t0 + row) % R] = x[:, t0 + row] if t0 + row < nf else 0

    G = tap_copies(h, fl)
    fetch(0)
    ys = [fir_tile(ring, fl, G, 0)]
    if T < nf:
        fetch(T)
    for t0 in range(0, nf, T):
        if t0 + T < nf:
            ys.append(fir_tile(ring, fl, G, t0 + T))
        if t0 + 2 * T < nf:
            fetch(t0 + 2 * T)
    return np.concatenate(ys, axis=1)[:, :nf]


def direct(h, head, x):
    ov = len(h) - 1
    xx = np.concatenate([head, x], axis=1)
    nf = x.shape[1]
    return np.stack([np.array([[h @ xx[p, t + ov - np.arange(ov + 1), c]
                                for c in range(KCB)] for t in range(nf)])
                     for p in range(2)])


@pytest.mark.parametrize("n_taps,nf", [(257, 1100), (33, 700), (301, 1800),
                                       (513, 1600), (601, 1300),
                                       (1009, 1100)])
def test_every_output_is_the_direct_sum(n_taps, nf):
    """Each output reads exactly the n_taps taps against their inputs (the
    history before the chunk, zeros past it) across ring wraps, histories
    up to four tiles long and a ragged last tile."""
    rng = np.random.default_rng(n_taps)
    ov = n_taps - 1
    fl = Layout(ov)
    h = rng.standard_normal(n_taps)
    head = rng.standard_normal((2, ov, KCB))
    x = rng.standard_normal((2, nf, KCB))
    assert fl.R >= fl.OVP + fl.T and nf > 2 * fl.T
    got = run_chunk(h, head, x, fl)
    np.testing.assert_allclose(got, direct(h, head, x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("n_taps", [33, 257, 513])
def test_ldmatrix_phases_hit_32_banks(n_taps):
    """Each 8-lane phase of an x4.trans names 8 consecutive slots (mod R)
    of one plane: 128 bytes in 32 banks, also across the wrap."""
    fl = Layout(n_taps - 1)
    for s in range(-fl.OVP, fl.R):
        for j in range(4):
            banks = set()
            for r in range(8):
                lane = 8 * j + r
                addr = ((lane >> 4) * fl.R + (s + (lane & 15)) % fl.R) * 16
                banks.update((addr // 4 + i) % 32 for i in range(4))
            assert len(banks) == 32


@pytest.mark.parametrize("per", [9, 33])
def test_accumulator_stores_and_resampler_loads_hit_32_banks(per):
    """The FIR's stores (lane 4g + i: channels 2i and 2i + 1 of rows g and
    g + 8) and the resampler's window loads (lane 8g' + c: channel c,
    samples 32 apart) on the y buffers' strides."""
    fl = Layout(256, per=per)
    for S, off in ((fl.Sre, skew(fl.H)), (fl.Sim, 0)):
        for m0 in range(0, fl.T, 16):
            for half in (0, 8):
                for odd in (0, 1):
                    banks = {((2 * (lane & 3) + odd) * S + off
                              + skew(m0 + half + (lane >> 2))) % 32
                             for lane in range(32)}
                    assert len(banks) == 32
    hoff = fl.H - (per - 1)
    for w in range(KCB):
        for r in range(4 + per - 1):
            banks = {((lane & 7) * fl.Sre
                      + skew(hoff + 32 * (lane >> 3) + 4 * w + r)) % 32
                     for lane in range(32)}
            assert len(banks) == 32


@pytest.mark.parametrize("split,x_bf16", [(False, True), (True, False),
                                          (False, False), (True, True)])
def test_headline_fits_three_blocks_an_sm(split, x_bf16):
    """257 taps, per 9, ×4, seg 896, a 500 ms hang (7 slots): the shared
    area of every form stays under what three blocks an SM allow."""
    fl = Layout(256, split=split, x_bf16=x_bf16)
    assert 4 * fl.floats(per=9, L=4, hang_tiles=7) <= SMEM_3_BLOCKS


@pytest.mark.parametrize("n_taps,seg", [(129, 128), (257, 256), (257, 896)])
def test_a_long_hang_keeps_three_blocks_an_sm(n_taps, seg):
    """A 500 ms hang at 12 kHz (6000 samples) on the shortest peak segment
    the planner gives these passbands (its tile is at least n_taps − 1)
    still fits three blocks an SM in every form."""
    hang = -(-(6000 - 1) // seg)
    for split, x_bf16 in ((False, True), (True, False), (False, False)):
        fl = Layout(n_taps - 1, seg=seg, split=split, x_bf16=x_bf16)
        assert 4 * fl.floats(per=9, L=4, hang_tiles=hang) <= SMEM_3_BLOCKS


def test_every_planned_passband_fits_a_block():
    """Every passband `fir_matmul.tail_fir_block` plans for (n_taps − 1 from
    64 to the largest tail tile, 1008) fits the opt-in limit in every form,
    with a 500 ms hang on the shortest segment the planner allows: the tile
    stays 256 rows, so only the ring and the taps grow with the passband."""
    from supersdr_tpu_torch.ops import fir_matmul
    planned = [ov for ov in range(64, 1009)
               if fir_matmul.tail_fir_block(1008 * 16, ov + 1, 1008)]
    assert planned[0] == 64 and planned[-1] == 1008
    for ov in planned:
        for split, x_bf16 in ((False, True), (True, False), (False, False)):
            fl = Layout(ov, seg=64, split=split, x_bf16=x_bf16)
            assert 4 * fl.floats(per=9, L=4, hang_tiles=94) <= SMEM_OPT_IN
