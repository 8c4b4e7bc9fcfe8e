"""Halo exchange along a time-sharded axis.

Counterpart of `supersdr_tpu/ops/pallas/halo.py` (`left_halo_rdma`) and of
the `ppermute` halos of `supersdr_tpu/ops/scans.py` (`left_halo`, one hop
of `left_context`). A sharded tensor carries its time shards on an explicit
axis, `[*batch, D, n_local]`; shard s receives the last n samples of shard
s − hop, and the first `hop` shards, which have no such neighbour, receive
`fill` or, on one hop, `head0` (the carried stream state the sharded chain
selects in for shard 0).

The kernel is `csrc/halo.cu`; `left_halo_plain` is the same function in
plain PyTorch (a slice copy). `left_halo` runs the plain version for CPU
tensors and the kernel for CUDA tensors. The kernel takes its sources and
destinations as tables of per-shard base pointers; on one card they all
point into the one tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from supersdr_tpu_torch import _build

_DTYPES = (torch.float32, torch.int16, torch.complex64)


def _planes(t: torch.Tensor) -> list[torch.Tensor]:
    """A complex tensor as its (re, im) float32 views; others as they
    are."""
    return [t.real, t.imag] if t.is_complex() else [t]


def _fills(fill: float, n_planes: int, dtype: torch.dtype) -> list:
    """`fill` per plane: a complex fill is fill + 0j, an int16 one must be
    a finite integer in range."""
    if dtype == torch.int16:
        if not math.isfinite(fill) or int(fill) != fill \
                or not -32768 <= fill <= 32767:
            raise ValueError(f"int16 halos need an int16 fill, got {fill}")
    return [fill] + [0.0] * (n_planes - 1)


def _copy_plain(xs, heads, outs, n: int, hop: int, fills) -> None:
    """The exchange as slice copies, plane by plane."""
    D = xs[0].shape[-2]
    for xp, hp, op, f in zip(xs, heads, outs, fills):
        if hp is not None:
            op[..., 0, :] = hp
        else:
            op[..., :min(hop, D), :] = f
        if hop < D:
            op[..., hop:, :] = xp[..., :D - hop, xp.shape[-1] - n:]


def _exchange(x, n, fill, hop, head0, out, use_kernel):
    single = isinstance(x, torch.Tensor)
    xt = [x] if single else list(x)
    ot, ht = _check(xt, n, hop, head0, out, single)
    dev = xt[0].device
    if dev.type == "cuda" and use_kernel:
        _launch(xt, ht, ot, n, hop, fill)
    elif dev.type in ("cpu", "cuda"):
        xs = [p for t in xt for p in _planes(t)]
        heads = [None] * len(xs) if ht is None \
            else [p for t in ht for p in _planes(t)]
        _copy_plain(xs, heads, [p for t in ot for p in _planes(t)], n, hop,
                    _fills(fill, len(xs), xt[0].dtype))
    else:
        raise ValueError(f"unsupported device {dev}")
    if out is not None:
        return out
    return ot[0] if single else tuple(ot)


def left_halo_plain(x, n: int, fill: float = 0.0, *, hop: int = 1,
                    head0=None, out=None):
    """Plain PyTorch halo exchange (see `left_halo`): slice copies on
    whatever device x is on."""
    return _exchange(x, n, fill, hop, head0, out, use_kernel=False)


def _check(xt, n, hop, head0, out, single):
    """Validate one call; returns (destination tensors, head tensors or
    None). The destination is allocated unless `out` is given."""
    x0 = xt[0]
    if len(xt) == 2:
        x1 = xt[1]
        if x1.shape != x0.shape or x1.dtype != x0.dtype \
                or x1.device != x0.device or x0.is_complex():
            raise ValueError("a pair must be two float32 or int16 planes "
                             "of one shape, dtype and device")
    elif len(xt) != 1:
        raise ValueError("x must be one tensor or a pair of planes")
    if x0.dtype not in _DTYPES:
        raise ValueError(f"x must be float32, int16 or complex64, got "
                         f"{x0.dtype}")
    if x0.ndim < 2:
        raise ValueError("x must be [*batch, D, n_local]")
    if not 1 <= n <= x0.shape[-1]:
        raise ValueError("halo larger than local block; use left_context")
    if hop < 1:
        raise ValueError("hop must be at least 1")
    want = x0.shape[:-1] + (n,)
    if out is None:
        ot = [torch.empty(want, dtype=x0.dtype, device=x0.device)
              for _ in xt]
    else:
        ot = [out] if single else list(out)
        if len(ot) != len(xt):
            raise ValueError("out must match x")
        for o in ot:
            if o.shape != want or o.dtype != x0.dtype \
                    or o.device != x0.device:
                raise ValueError("out must match x with n samples a shard")
    if head0 is None:
        return ot, None
    if hop != 1:
        raise ValueError("head0 stands for shard 0's neighbour: one hop only")
    ht = [head0] if isinstance(head0, torch.Tensor) else list(head0)
    n_planes = len(xt) * (2 if x0.is_complex() else 1)
    plane_dtype = torch.float32 if x0.is_complex() else x0.dtype
    want = x0.shape[:-2] + (n,)
    got = 0
    for h in ht:
        ok_dtype = h.dtype == (x0.dtype if h.is_complex() else plane_dtype)
        if h.shape != want or not ok_dtype or h.device != x0.device:
            raise ValueError(f"head0 must give {n_planes} plane(s) "
                             f"{tuple(want)} like x")
        got += 2 if h.is_complex() else 1
    if got != n_planes:
        raise ValueError(f"head0 must give {n_planes} plane(s) "
                         f"{tuple(want)} like x")
    return ot, ht


def _descs(tensors, keep: int):
    """The float32 / int16 planes of `tensors` as (pointers, row count,
    element strides of the last `keep` + 1 axes with the batch axes
    flattened to one): a complex tensor is two planes 4 bytes apart with
    doubled strides. All planes of one call must share their strides."""
    ptrs, strides = [], None
    for t in tensors:
        if t.is_complex():
            r = torch.view_as_real(t)
            st, base = r.stride()[:-1], r.data_ptr()
            ptrs += [base, base + 4]
        else:
            st = t.stride()
            ptrs.append(t.data_ptr())
        if strides is None:
            strides = st
        elif st != strides:
            raise ValueError("the planes of one call need equal strides")
    shape = tensors[0].shape
    nb = len(shape) - keep
    rows, row_stride = 1, 0
    for i in range(nb - 1, -1, -1):       # innermost batch axis first
        if shape[i] == 1:
            continue
        if rows == 1:
            row_stride = strides[i]
        elif strides[i] != row_stride * rows:
            raise ValueError("the batch axes must flatten to one stride; "
                             "reshape the input first")
        rows *= shape[i]
    return ptrs, rows, (row_stride,) + tuple(strides[nb:])


def _launch(xt, ht, ot, n, hop, fill):
    lib = _build.load()
    x0 = xt[0]
    D, n_local = x0.shape[-2], x0.shape[-1]
    if D > lib.halo_max_shards():
        raise ValueError(f"the kernel's pointer table holds at most "
                         f"{lib.halo_max_shards()} shards, got {D}")
    if x0.numel() == 0:
        return
    xp, R, (x_rs, x_ds, x_es) = _descs(xt, 2)
    op, R_o, (o_rs, o_ds, o_es) = _descs(ot, 2)
    if R_o != R:
        raise ValueError("out must match x")
    fills = _fills(fill, len(xp), x0.dtype)
    esz = 2 if x0.dtype == torch.int16 else 4
    n_planes = len(xp)
    Tab = ctypes.c_void_p * (n_planes * D)
    src = Tab(*[b + s * x_ds * esz for b in xp for s in range(D)])
    dst = Tab(*[b + s * o_ds * esz for b in op for s in range(D)])
    head, h_rs, h_es = None, 0, 0
    if ht is not None:
        hp, _, (h_rs, h_es) = _descs(ht, 1)
        head = (ctypes.c_void_p * n_planes)(*hp)
    err = lib.halo_push(
        src, dst, head, n_planes, D, int(esz == 2), R, n, hop, x_rs, x_es,
        n_local - n, o_rs, o_es, h_rs, h_es, float(fills[0]),
        float(fills[-1]),
        ctypes.c_void_p(torch.cuda.current_stream(x0.device).cuda_stream))
    _build.check(err, "halo_push")
    left_halo.launches += 1


def left_halo(x, n: int, fill: float = 0.0, *, hop: int = 1, head0=None,
              out=None):
    """The last `n` samples of the shard `hop` places to the left.

    x: float32, int16 or complex64 `[*batch, D, n_local]` with any element
    strides (the batch axes flattening to one), or a pair of float32 or
    int16 planes of that shape (re, im: one launch moves both). Returns
    `[*batch, D, n]` like x (a pair for a pair): shard s holds
    x[..., s − hop, −n:], and shards s < hop hold `fill` (a complex fill
    is fill + 0j) or, with `head0` `[*batch, n]` (one hop only; a complex
    tensor or an (re, im) pair for complex x), shard 0 holds head0. `out`
    is written in place when given (any strides, e.g. a slice of a longer
    context). CPU tensors run the plain version, CUDA tensors the
    kernel."""
    return _exchange(x, n, fill, hop, head0, out, use_kernel=True)


left_halo.launches = 0


def empty_launch(device) -> None:
    """Launch the library's empty kernel on `device`'s current stream: the
    floor under the halo kernel's time (it is launch-bound)."""
    lib = _build.load()
    _build.check(lib.halo_empty_launch(ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream)), "halo_empty_launch")
