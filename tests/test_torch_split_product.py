"""A float32 matrix product on tensor cores that take narrower operands:
each operand split into a high and a low piece, three products summed.

The quality tier holds its kernels to ≥ 100 dB against the float32 plain
version. A tensor core takes TF32 (10 mantissa bits) or bf16 (7) operands
and accumulates in float32, so one pass on rounded operands cannot meet
that; hi·hi + hi·lo + lo·hi, with lo the rounded remainder, can. This file
models the arithmetic with float32 tensors whose mantissas are rounded to
the piece's width (the products themselves exact, summed in float32, as the
tensor core does) on a product of the stage-B shape, 80 rows × 512 × 512,
against float64.
"""

import numpy as np
import pytest
import torch

MANTISSA_BITS = {"tf32": 10, "bf16": 7}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 → float32 with `bits` explicit mantissa bits, round to
    nearest even (what cvt.rna.tf32 and __float2bfloat16_rn keep)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    drop = 23 - bits
    u = u + ((1 << (drop - 1)) - 1) + ((u >> drop) & 1)
    u = (u >> drop) << drop
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return u.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor, bits: int):
    hi = round_mantissa(x, bits)
    return hi, round_mantissa(x - hi, bits)


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact products of the narrow operands, accumulated in float32."""
    return (a.double() @ b.double()).float()


def _operands(seed: int):
    """A: stage-A outputs (noise); B: [Cr | Ci] of a 256-point DFT, the
    real 512 × 512 form [[Cr, Ci], [−Ci, Cr]]."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(80, 512)).astype(np.float32) * 0.05)
    k = np.arange(256)
    w = np.exp(-2j * np.pi * np.outer(k, k) / 256)
    b = np.block([[w.real, w.imag], [-w.imag, w.real]]).astype(np.float32)
    return a, torch.from_numpy(b)


def _snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    return float(20 * torch.log10(torch.linalg.norm(ref)
                                  / torch.linalg.norm(got - ref)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("piece", sorted(MANTISSA_BITS))
def test_three_passes_reach_the_quality_gate_and_one_does_not(piece, seed):
    bits = MANTISSA_BITS[piece]
    a, b = _operands(seed)
    ref = a.double() @ b.double()
    a_hi, a_lo = split(a, bits)
    b_hi, b_lo = split(b, bits)
    one = product(a_hi, b_hi)
    three = one + (product(a_hi, b_lo) + product(a_lo, b_hi))
    assert _snr_db(ref, one) < 80.0
    assert _snr_db(ref, three) >= 100.0


@pytest.mark.parametrize("piece", sorted(MANTISSA_BITS))
def test_the_dropped_term_is_what_is_left(piece):
    """hi·hi + hi·lo + lo·hi misses lo·lo and what the two pieces do not
    hold of the operand: adding lo·lo back changes the result by less than
    the float32 product's own rounding."""
    bits = MANTISSA_BITS[piece]
    a, b = _operands(2)
    ref = a.double() @ b.double()
    a_hi, a_lo = split(a, bits)
    b_hi, b_lo = split(b, bits)
    three = product(a_hi, b_hi) + (product(a_hi, b_lo) + product(a_lo, b_hi))
    four = three + product(a_lo, b_lo)
    assert _snr_db(ref, four) >= _snr_db(ref, three) - 0.5
    assert _snr_db(three, four) >= 2 * 6.02 * bits - 10.0


@pytest.mark.parametrize("piece", sorted(MANTISSA_BITS))
def test_split_pieces_are_narrow_and_sum_back(piece):
    bits = MANTISSA_BITS[piece]
    a, _ = _operands(3)
    hi, lo = split(a, bits)
    for p in (hi, lo):
        low = p.view(torch.int32) & ((1 << (23 - bits)) - 1)
        assert int(low.abs().max()) == 0
    # two pieces hold 2·(bits + 1) significant bits of the operand
    rel = float(((hi + lo) - a).abs().max() / a.abs().max())
    assert rel <= 2.0 ** (-2 * bits - 1)
    if piece == "bf16":
        assert torch.equal(hi, a.to(torch.bfloat16).float())


def test_stage_b_table_pieces_hold_the_float32_table():
    """The table the kernel's split product reads: planes re, im high and
    re, im low, transposed; the high planes are the bf16 tier's table, and
    high + low give the float32 DFT back to 2^-16."""
    from supersdr_tpu_torch.ops import channelizer
    from supersdr_tpu_torch.ops.cuda import channelize_fused as cf
    M, n1, n2 = 512, 2, 256
    one = cf._stageb_table_bf16(M, n1, n2, False, "cpu")
    two = cf._stageb_table_bf16(M, n1, n2, True, "cpu")
    assert one.dtype == two.dtype == torch.bfloat16
    assert one.shape == (2, n2, n2) and two.shape == (4, n2, n2)
    assert torch.equal(one, two[:2])
    _, _, c2r, c2i = channelizer._dif_tables(M, n1, n2)
    ref = torch.from_numpy(np.stack([c2r.T, c2i.T]))
    assert float((two[:2].float() + two[2:].float() - ref).abs().max()) \
        <= 2.0 ** -16
    _, _, c2 = cf._tables(M, n1, n2, True, "cpu")
    assert torch.equal(one[0].float().T, c2[..., 0])
