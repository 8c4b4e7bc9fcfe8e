"""Fused channelizer: PFB fold + DIF stage A + stage-B DFT, one pass.

Counterpart of `supersdr_tpu/ops/pallas/channelize_fused.py`
(`channelize_fused_c` with `out_layout` "raw3" and "time"). The kernel is
`csrc/channelize_fused.cu`; `channelize_fused_plain` is the same function
in plain PyTorch. `channelize_fused_c` (and `channelize_fused_raw3`, its
"raw3" form) runs the plain version for CPU tensors and the kernel for
CUDA tensors; both count their launches in
`channelize_fused_raw3.launches` (one kernel, one count).

Output, "raw3": the raw planar planes [n1, nf, n2], planar channel
k1·n2 + k2 = PFB bin k2·n1 + k1 (`planar_order`). "time": float32 planes
[nf, M] in bin order m = k2·n1 + k1, written by the same kernel (a second
store path). The kernel runs stage B unsplit, so the column of a plane is
k2 (the reference's radix-2 stage-B split, which halves TPU MXU work and
reorders the columns, has no counterpart here).

The mesh form (`parallel/sharded_wideband.py`): a leading shard axis on x
and on the carry, D time shards each with its own history head, one launch
for all of them; and `n1_pad` (raw3 only), `n1_pad − n1` trailing planes
of exact zeros so that the all_to_all's split axis divides by D.

The kernel runs stage B on the tensor cores in both tiers: `bf16_b` in one
pass on operands rounded to bf16 (what the plain version rounds too); else
on float32 operands split in a high and a low bf16 piece, three passes
(≥ 100 dB against the float32 plain version, which
`tests/test_torch_split_product.py` models on the CPU).

The plain version takes stage A as the reference does, the folded matrix
At[j1·n1 + k1, j2] = W_n1^{j1·k1}·W_M^{j2·k1}. The kernel reads its two
factors instead (`_stagea_tables`): the n1-point DFT and the twiddle row,
each rounded once to float32 from `channelizer._dif_factors`' float64, and
multiplies by the twiddle after the sum over j1 (the same function; its
float32 rounding falls in another place).

The tables are made once and held: those of the shape by `lru_cache`, the
fold taps (`channelizer.fold_taps`) and the kernel's transposed taps by
`utils/held.FromTensors`, under the tensor they come from (a new or
rewritten weight tensor is read anew).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from supersdr_tpu_torch import _build
from supersdr_tpu_torch.ops import channelizer, cx
from supersdr_tpu_torch.ops.cuda import check_fp32_matmul
from supersdr_tpu_torch.utils import held

I16_SCALE = 1.0 / 32768.0
MAX_TAPS_PER = 8      # the kernel's kKMax: fold rows held in registers
MAX_SMEM = 227 * 1024  # shared bytes a block of the card can have
ROW_TILES = 5          # the kernel's kMG: 16-row tiles a warp accumulates
THREADS = 256          # the kernel's block
K1_GROUP = 10          # stage-A outputs a thread accumulates


def tile_frames(n1: int, n2: int, *, split: bool, time: bool) -> int:
    """Frames a block of the kernel holds (8, 4 or 2; 0: none fits), as
    its `mma_tile` picks them: the most whose stage-A output Y (bf16; the
    split tier's high and low pieces), two tiles of the input ring (or,
    larger, the time store's staging of T frames a warp) and the n1-point
    DFT (its outputs padded to groups of K1_GROUP) fit in a block's shared
    memory; the time store also wants every row tile in one pass of
    ROW_TILES."""
    for T in (8, 4, 2):
        y_rows = (n1 * T + 15) // 16 * 16
        if time and y_rows // 16 > ROW_TILES:
            continue
        y = (2 if split else 1) * y_rows * (2 * n2 + 8) * 2
        ring = 2 * 2 * (min(T, 4) + MAX_TAPS_PER - 1) * THREADS * 4
        stage = THREADS // 32 * T * (16 * n1 + 4) * 4
        dft = n1 * -(-n1 // K1_GROUP) * K1_GROUP * 8
        if y + max(ring, stage if time else 0) + dft <= MAX_SMEM:
            return T
    return 0


@lru_cache(maxsize=64)
def check_shape(n1: int, n2: int, K: int, *, bf16_b: bool,
                out_layout: str) -> int:
    """The kernel's tile for these arguments, or ValueError for a shape it
    cannot take (before anything is built or launched)."""
    if n1 < 1 or n2 < 1 or n2 % 128:
        raise ValueError(f"factoring ({n1}, {n2}): the kernel wants n2 a "
                         "multiple of 128")
    if not 1 <= K <= MAX_TAPS_PER:
        raise ValueError(f"the kernel folds 1 to {MAX_TAPS_PER} taps a "
                         f"branch, got taps_per={K}")
    T = tile_frames(n1, n2, split=not bf16_b, time=out_layout == "time")
    if T == 0:
        raise ValueError(f"factoring ({n1}, {n2}): the stage-A tile does "
                         "not fit in shared memory")
    return T


@lru_cache(maxsize=16)
def _tables(M: int, n1: int, n2: int, bf16_b: bool, device: str
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(At_r, At_i) [n1·n1, n2] with At[j1·n1 + k1, j2] = A[j2, k1, j1],
    and the stage-B DFT as interleaved complex [n2, n2, 2] — rounded to
    bf16 values for the bf16 tier."""
    Ar, Ai, c2r, c2i = channelizer._dif_tables(M, n1, n2)
    At_r = np.ascontiguousarray(Ar.transpose(2, 1, 0).reshape(n1 * n1, n2))
    At_i = np.ascontiguousarray(Ai.transpose(2, 1, 0).reshape(n1 * n1, n2))
    c2 = torch.from_numpy(np.stack([c2r, c2i], axis=-1))
    if bf16_b:
        c2 = c2.to(torch.bfloat16).float()
    return (torch.from_numpy(At_r).to(device),
            torch.from_numpy(At_i).to(device),
            c2.contiguous().to(device))


@lru_cache(maxsize=16)
def _stageb_table_bf16(M: int, n1: int, n2: int, split: bool, device: str
                       ) -> torch.Tensor:
    """The stage-B DFT as the kernel's tensor-core product reads it:
    transposed bf16 planes [re, im][n2 (k2), n2 (j2)], the values `_tables`
    rounds to. split (float32 operands in three bf16 passes): two more
    planes, what bf16 left of re and im, rounded to bf16 again."""
    _, _, c2r, c2i = channelizer._dif_tables(M, n1, n2)
    ct = torch.from_numpy(np.ascontiguousarray(
        np.stack([c2r.T, c2i.T]))).float()
    hi = ct.to(torch.bfloat16)
    if split:
        hi = torch.cat([hi, (ct - hi.float()).to(torch.bfloat16)])
    return hi.contiguous().to(device)


@lru_cache(maxsize=16)
def _stagea_tables(M: int, n1: int, n2: int, device: str
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's stage-A factors as complex64 pairs, each rounded once
    from float64: the n1-point DFT [n1 (j1), n1 (k1), 2] and the twiddle
    row [n1 (k1), n2 (j2), 2]."""
    d1, tw = channelizer._dif_factors(M, n1, n2)

    def pairs(z):
        return torch.from_numpy(np.ascontiguousarray(
            np.stack([z.real, z.imag], axis=-1).astype(np.float32)))
    return pairs(d1).to(device), pairs(tw.T).to(device)


def channelize_fused_plain(g2: torch.Tensor, At_r: torch.Tensor,
                           At_i: torch.Tensor, c2: torch.Tensor,
                           head_r: torch.Tensor, head_i: torch.Tensor,
                           x_r: torch.Tensor, x_i: torch.Tensor, *,
                           n1: int, n2: int, in_scale: float, bf16_b: bool,
                           out_dtype: torch.dtype, out_layout: str = "raw3",
                           n1_out: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch channelizer. x_*: [*D, nf, M] f32 (in_scale 0) or
    int16 (×in_scale); head_*: [*D, K−1, M] history rows (an optional
    leading shard axis D on both); g2: [K, M] fold taps. Returns raw
    planes [*D, n1_out, nf, n2] in out_dtype (planes n1 … n1_out − 1
    zero; n1_out defaults to n1), or for "time" the bin-ordered planes
    [*D, nf, M]."""
    check_fp32_matmul(x_r)
    *lead, nf, M = x_r.shape
    K = g2.shape[0]

    def seg(head, x):
        x = x.float() * in_scale if in_scale else x
        return torch.cat([head, x], dim=-2)

    sr, si = seg(head_r, x_r), seg(head_i, x_i)
    fr = g2[0] * sr[..., 0:nf, :]
    fi = g2[0] * si[..., 0:nf, :]
    for k in range(1, K):
        fr = fr + g2[k] * sr[..., k:k + nf, :]
        fi = fi + g2[k] * si[..., k:k + nf, :]
    f3r = fr.reshape(*lead, nf, n1, n2)
    f3i = fi.reshape(*lead, nf, n1, n2)
    Ar = At_r.reshape(n1, n1, n2)          # [j1, k1, j2]
    Ai = At_i.reshape(n1, n1, n2)
    yr = torch.zeros(*lead, n1, nf, n2, dtype=torch.float32,
                     device=x_r.device)
    yi = torch.zeros_like(yr)
    for j1 in range(n1):
        ar, ai = Ar[j1][:, None, :], Ai[j1][:, None, :]
        xr = f3r[..., None, :, j1, :]
        xi = f3i[..., None, :, j1, :]
        yr = yr + (ar * xr - ai * xi)
        yi = yi + (ar * xi + ai * xr)
    if bf16_b:
        yr = yr.to(torch.bfloat16).float()
        yi = yi.to(torch.bfloat16).float()
    c2r, c2i = c2[..., 0], c2[..., 1]
    out_r = yr @ c2r - yi @ c2i
    out_i = yr @ c2i + yi @ c2r
    if out_layout == "time":     # [n1, nf, n2] → [nf, n2, n1] → [nf, M]
        out_r = out_r.movedim(-3, -1).reshape(*lead, nf, M)
        out_i = out_i.movedim(-3, -1).reshape(*lead, nf, M)
    elif n1_out is not None and n1_out > n1:
        pad = out_r.new_zeros(*lead, n1_out - n1, nf, n2)
        out_r = torch.cat([out_r, pad], dim=-3)
        out_i = torch.cat([out_i, pad], dim=-3)
    return out_r.to(out_dtype), out_i.to(out_dtype)


def _transposed_taps(g2: torch.Tensor, K: int, M: int) -> torch.Tensor:
    gt = g2.new_zeros(M, MAX_TAPS_PER)
    gt[:, :K] = g2.T
    return gt


_TRANSPOSED_TAPS = held.FromTensors(_transposed_taps)


@lru_cache(maxsize=64)
def _tile_agrees(n1: int, n2: int, bf16_b: bool, time: bool) -> None:
    """Raise unless the built kernel's plan picks `tile_frames`' tile."""
    got = _build.load().channelize_fused_tile(n1, n2, int(bf16_b), int(time))
    want = tile_frames(n1, n2, split=not bf16_b, time=time)
    if got != want:
        raise RuntimeError(f"channelize_fused: the kernel tiles ({n1}, {n2}) "
                           f"by {got} frames, tile_frames by {want}")


def _launch(g2, At_r, At_i, c2, head_r, head_i, x_r, x_i, *, n1, n2,
            in_scale, bf16_b, out_dtype, out_layout="raw3", n1_out=None):
    """The kernel on the plain version's arguments; it reads the taps
    transposed ([M, 8], zeros past K), the factored stage-A tables and its
    own stage-B table in place of g2, At and c2."""
    *lead, nf, M = x_r.shape
    D = lead[0] if lead else 1
    n1o = n1 if n1_out is None else n1_out
    K = g2.shape[0]
    check_shape(n1, n2, K, bf16_b=bf16_b, out_layout=out_layout)
    lib = _build.load()
    _tile_agrees(n1, n2, bool(bf16_b), out_layout == "time")
    if x_r.data_ptr() % 16 or x_i.data_ptr() % 16:
        # the kernel copies rows in 16-byte pieces
        x_r, x_i = x_r.clone(), x_i.clone()
    gt = _TRANSPOSED_TAPS((g2,), K, M)
    dev = str(x_r.device)
    dft, tw = _stagea_tables(M, n1, n2, dev)
    # stage B on the tensor cores reads its own table layout, not c2
    ct = _stageb_table_bf16(M, n1, n2, not bf16_b, dev)
    shape = (*lead, nf, M) if out_layout == "time" else (*lead, n1o, nf, n2)
    out_r = torch.empty(shape, dtype=out_dtype, device=x_r.device)
    out_i = torch.empty_like(out_r)
    p = ctypes.c_void_p
    err = lib.channelize_fused_raw3(
        p(x_r.data_ptr()), p(x_i.data_ptr()), int(x_r.dtype == torch.int16),
        float(in_scale), p(head_r.data_ptr()), p(head_i.data_ptr()),
        p(gt.data_ptr()), p(dft.data_ptr()), p(tw.data_ptr()),
        p(ct.data_ptr()), p(out_r.data_ptr()), p(out_i.data_ptr()),
        int(out_dtype == torch.bfloat16), nf, M, K, n1, n2, int(bf16_b),
        int(out_layout == "time"), D, n1o,
        p(torch.cuda.current_stream(x_r.device).cuda_stream))
    _build.check(err, "channelize_fused_raw3")
    channelize_fused_raw3.launches += 1
    return out_r, out_i


def planar_order(n_chan: int, n1: int, n2: int) -> np.ndarray:
    """order[c] = the PFB bin of planar channel c of the "raw3" planes:
    channel c = k1·n2 + k2 (plane k1, column k2) holds bin k2·n1 + k1. On
    the mesh's padded planes the real channels are the first n_chan."""
    c = np.arange(n_chan)
    return c % n2 * n1 + c // n2


LAUNCH_KEYS = ("smem", "blocks", "threads", "per_sm", "regs", "local",
               "frames")


def l2_table_bytes(M: int, K: int, n1: int, n2: int, T: int,
                   bf16_b: bool) -> int:
    """Bytes of tables a block of T frames reads out of L2: the taps (8 a
    channel, zeros past K) once a pass over its columns (T/4 frame passes ×
    the passes over the stage-A output groups), the twiddle row once a
    frame pass, the n1-point DFT once, and the stage-B table."""
    frame_passes = T // min(T, 4)
    groups = -(-n1 // K1_GROUP)
    k1_passes = -(-groups // (THREADS // min(n2, THREADS)))
    return (frame_passes * (k1_passes * 4 * MAX_TAPS_PER * M + 8 * n1 * n2)
            + 8 * n1 * n1 + 2 * n2 * n2 * (2 if bf16_b else 4))


def launch_info(*, nf: int, M: int, K: int, n1: int, n2: int, bf16_b: bool,
                in_i16: bool = False, out_dtype: torch.dtype = torch.float32,
                out_layout: str = "raw3", n_shards: int = 1,
                n1_out: int | None = None) -> dict:
    """What the kernel launches for these arguments, from the card's
    runtime, without launching (`channelize_fused_launch`): LAUNCH_KEYS —
    shared bytes a block, blocks, threads a block, blocks an SM, registers
    and local bytes a thread, frames a block; plus the bytes of the tables
    it reads (`table_bytes`: taps, DFT, twiddle row, stage-B table) and
    what a block reads of them out of L2 (`l2_table_bytes`)."""
    check_shape(n1, n2, K, bf16_b=bf16_b, out_layout=out_layout)
    out = (ctypes.c_long * len(LAUNCH_KEYS))()
    _build.check(_build.load().channelize_fused_launch(
        int(in_i16), int(out_dtype == torch.bfloat16), nf, M, K, n1, n2,
        int(bf16_b), int(out_layout == "time"), n_shards,
        n1 if n1_out is None else n1_out, ctypes.cast(out, ctypes.c_void_p)),
        "channelize_fused_launch")
    info = dict(zip(LAUNCH_KEYS, out))
    T = info["frames"]
    info["table_bytes"] = (4 * MAX_TAPS_PER * M + 8 * n1 * n1 + 8 * n1 * n2
                           + 2 * n2 * n2 * (2 if bf16_b else 4))
    info["l2_table_bytes"] = l2_table_bytes(M, K, n1, n2, T, bf16_b)
    return info


def channelize_fused_c(plan: channelizer.PFBPlan, W: torch.Tensor,
                       carry: cx.CX, x, *, factors: tuple[int, int],
                       bf16_mxu: bool,
                       out_dtype: torch.dtype = torch.float32,
                       out_layout: str = "raw3", n1_pad: int | None = None
                       ) -> tuple[cx.CX, tuple[torch.Tensor, torch.Tensor]]:
    """One streaming channelizer step (critical sampling).

    W: [K, M] polyphase weights; carry: CX [(K−1)·M] history; x: CX of
    [n] float32 planes, or an (re, im) pair of int16 [n] planes
    (dequantized ×1/32768). bf16_mxu rounds stage B's operands to bf16
    (fast tier); out_dtype is float32 or bfloat16. Returns (new_carry,
    planes): for out_layout "raw3" (raw_r, raw_i) [n1, n/M, n2], for
    "time" the float32 bin-ordered (re, im) [n/M, M]. CPU tensors run the
    plain version, CUDA tensors the kernel.

    The mesh form: x [D, n] and carry [D, (K−1)·M] (shard s's own history)
    give planes with a leading D axis and the new carry [D, (K−1)·M] of
    each shard, in one launch; n1_pad > n1 (raw3 only) appends
    `n1_pad − n1` planes of zeros."""
    if out_layout not in ("raw3", "time"):
        raise ValueError("out_layout must be 'raw3' or 'time'")
    if out_layout == "time" and out_dtype != torch.float32:
        raise ValueError("out_layout='time' writes float32")
    M, K = plan.n_chan, plan.taps_per
    n1, n2 = factors
    if n1_pad is not None and (n1_pad < n1 or out_layout != "raw3"):
        raise ValueError("n1_pad must be >= n1, and is only for the raw3 "
                         "coupling")
    if plan.hop != M:
        raise ValueError("fused channelizer requires critical sampling")
    if n1 * n2 != M or n2 % 128:
        raise ValueError("factors must multiply to n_chan with n2 % 128 == 0")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("out_dtype must be float32 or bfloat16")
    if isinstance(x, cx.CX):
        x_r, x_i, in_scale, want = x.re, x.im, 0.0, torch.float32
    elif isinstance(x, tuple) and len(x) == 2:
        (x_r, x_i), in_scale, want = x, I16_SCALE, torch.int16
    else:
        raise TypeError("x must be a CX of float32 planes or an int16 pair")
    dev = W.device
    *lead, n = x_r.shape
    if len(lead) > 1:
        raise ValueError("x takes at most one leading (shard) axis")
    for name, t, dt, shape in (("W", W, torch.float32, (K, M)),
                               ("carry.re", carry.re, torch.float32,
                                (*lead, plan.history)),
                               ("carry.im", carry.im, torch.float32,
                                (*lead, plan.history)),
                               ("x re", x_r, want, (*lead, n)),
                               ("x im", x_i, want, (*lead, n))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if n % M:
        raise ValueError("block length must be a multiple of n_chan")
    h = plan.history
    if in_scale:
        new_carry = cx.CX(x_r[..., -h:].float() * in_scale,
                          x_i[..., -h:].float() * in_scale)
    else:
        new_carry = cx.CX(x_r[..., -h:].clone(), x_i[..., -h:].clone())
    args, kw = prepare(plan, W, carry, x_r, x_i, factors=factors,
                       bf16_mxu=bf16_mxu, out_dtype=out_dtype)
    kw["out_layout"] = out_layout
    if n1_pad is not None and n1_pad != n1:
        kw["n1_out"] = n1_pad
    if dev.type == "cpu":
        raw = channelize_fused_plain(*args, **kw)
    elif dev.type == "cuda":
        raw = _launch(*args, **kw)
    else:
        raise ValueError(f"unsupported device {dev}")
    return new_carry, raw


def channelize_fused_raw3(plan: channelizer.PFBPlan, W: torch.Tensor,
                          carry: cx.CX, x, *, factors: tuple[int, int],
                          bf16_mxu: bool, out_dtype: torch.dtype
                          ) -> tuple[cx.CX, tuple[torch.Tensor, torch.Tensor]]:
    """`channelize_fused_c` with the raw planar planes [n1, n/M, n2]."""
    return channelize_fused_c(plan, W, carry, x, factors=factors,
                              bf16_mxu=bf16_mxu, out_dtype=out_dtype)


def prepare(plan: channelizer.PFBPlan, W: torch.Tensor, carry: cx.CX,
            x_r: torch.Tensor, x_i: torch.Tensor, *,
            factors: tuple[int, int], bf16_mxu: bool,
            out_dtype: torch.dtype) -> tuple[tuple, dict]:
    """The (args, kwargs) that `channelize_fused_plain` and the kernel take
    for one step: fold taps, DIF tables, carry rows and [*D, nf, M] views
    (D: the optional leading shard axis)."""
    M, K = plan.n_chan, plan.taps_per
    n1, n2 = factors
    *lead, n = x_r.shape
    nf = n // M
    g2 = channelizer.fold_taps(W, K, M)
    At_r, At_i, c2 = _tables(M, n1, n2, bool(bf16_mxu), str(W.device))
    args = (g2, At_r, At_i, c2, carry.re.reshape(*lead, K - 1, M),
            carry.im.reshape(*lead, K - 1, M), x_r.reshape(*lead, nf, M),
            x_i.reshape(*lead, nf, M))
    kw = dict(n1=n1, n2=n2,
              in_scale=I16_SCALE if x_r.dtype == torch.int16 else 0.0,
              bf16_b=bool(bf16_mxu), out_dtype=out_dtype)
    return args, kw


channelize_fused_raw3.launches = 0
