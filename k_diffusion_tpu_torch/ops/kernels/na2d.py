"""2-D neighborhood attention and its backward (counterpart of
k_diffusion_tpu/ops/pallas/na2d.py: ``na2d_packed``, ``na2d``,
``na2d_packed_proj`` and ``na2d_reference``).

Each query attends to exactly kernel_size x kernel_size keys, its window
clamped inward at the edges (NATTEN's contract). CUDA tensors go to the
hand-written kernels through autograd Functions (``na2d_packed`` and
``na2d`` through ``residuals``' node, which saves q, k, v, the output and
the logsumexp, as the JAX custom_vjp does, and under a remat policy keeps
them); CPU tensors go to the plain versions, which autograd
differentiates.

- ``na2d_packed`` on channel-packed (b, h, w, heads * 64) maps: the
  forward K2 (``csrc/na_fwd.cuh``, launched from ``csrc/na2d.cu``: the
  wgmma forward of ``csrc/attn_fwd.cuh`` over a query tile's key halo,
  which also writes the per-head logsumexp when a backward follows) and
  the backward K7 (``csrc/na_bwd.cuh``: a dq kernel per query tile and a
  dk/dv kernel per key tile, one counted launch, dq, dk and dv written once
  in bf16).
- ``overlap_add``: K8 (``csrc/na2d.cu``), the overlap-add of per-tile dk/dv
  halo partials, the second half of the Pallas backward's design, writing
  bf16 or float32 dk and dv. No model path runs it since K7 writes dk and
  dv itself; its plain version and ``packed_backward_partials_reference``
  hold it on its own op path.
- ``na2d`` on (b, h, w, heads, e) maps, e 32, 64 or 128, read through their
  strides (``csrc/na2d_heads.cu``): the forward K11 (K2's forward, v read
  through its own strides) and the backward K12 (K7's two kernels, q, k
  and v each read through its own strides: a dq kernel per query tile,
  which forms delta = rowsum(out * dout), and a dk/dv kernel per key tile,
  one counted launch), at e 128 on ``csrc/wgmma.cuh``'s tiles of two
  128-byte-swizzled column halves.
- ``na2d_packed_proj``: K15 (``csrc/na_proj.cuh``, launched from
  ``csrc/na2d_heads.cu``), ``na2d_packed`` with the out-projection and the
  residual fused into the forward, at head dims 32 and 64: a thread block
  cluster per query tile and image, a rank per 64 channels. Its backward
  recomputes the attention with K2 and runs K7 (head dim 64), or K11 and
  K12 on the per-head views (head dim 32), as the JAX op's backward is the
  VJP of its plain version.

bfloat16 operands go to those kernels, float32 operands (a model built with
``dtype=torch.float32``, ``--mixed-precision no``) to their float32 forms:
K2, K7, K11 and K12 in ``csrc/na_tf32.cuh`` (``csrc/attn_tf32.cuh``'s TF32
bodies over the same neighborhood geometry; ``kdt_na2d_packed_f32``,
``kdt_na2d_packed_bwd_f32`` in ``csrc/na2d.cu``, ``kdt_na2d_heads_f32``,
``kdt_na2d_heads_bwd_f32`` in ``csrc/na2d_heads.cu``; K11's and K12's at
every head dim of ``HEAD_DIMS``), K15 in ``csrc/na_proj_tf32.cuh``
(``kdt_na2d_proj_f32``) and K8 writing float32 (``kdt_na2d_overlap_add_f32``,
``overlap_add(..., dtype=torch.float32)``). Each dtype's launches are
counted apart. Only CPU tensors reach the plain versions.
"""

import ctypes
import functools

import torch

from ..attention import neighborhood_attention
from . import _build, residuals

launches = 0            # K2 launches since the last reset
bwd_launches = 0        # K7 launches (its two kernels count as one)
overlap_launches = 0    # K8 launches
heads_launches = 0      # K11 launches
heads_bwd_launches = 0  # K12 launches (its two kernels count as one)
proj_launches = 0       # K15 launches
launches_f32 = 0            # K2 launches on float32 operands
bwd_launches_f32 = 0        # K7 launches on float32 operands
overlap_launches_f32 = 0    # K8 launches writing float32
heads_launches_f32 = 0      # K11 launches on float32 operands
heads_bwd_launches_f32 = 0  # K12 launches on float32 operands
proj_launches_f32 = 0       # K15 launches on float32 operands

DTYPES = (torch.bfloat16, torch.float32)  # operand dtypes the kernels take

TILE = 8          # query tile edge of the kernels
MAX_KERNEL = 7    # the kernels' halo holds windows up to 7 x 7
HALO_KEYS = 208   # rows of a tile's halo partial (14 x 14, rounded up to 16)
HEAD_DIMS = (32, 64, 128)  # head dims of K11 and K12, in either dtype
# head dims of K15: a rank's 64 channels hold whole heads
PROJ_HEAD_DIMS = (32, 64)

_P = ctypes.c_void_p
# q, k, v, out, lse, batch, h, w, heads, kernel_size, scale, stream
_SIGNATURE = [_P] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
# q, k, v, out, dout, lse, delta, dq, dk, dv, batch, h, w, heads,
# kernel_size, scale, stream
_BWD_SIGNATURE = [_P] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, _P]
# dk_part, dv_part, dk, dv, batch, h, w, heads, kernel_size, stream
_OVERLAP_SIGNATURE = [_P] * 4 + [ctypes.c_int] * 5 + [_P]
# q, k, v, out, lse, batch, h, w, heads, e, kernel_size, scale, strides,
# stream
_HEADS_SIGNATURE = [_P] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, _P, _P]
# q, k, v, out, dout, lse, delta, dq, dk, dv, batch, h, w, heads, e,
# kernel_size, scale, strides, stream
_HEADS_BWD_SIGNATURE = [_P] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float, _P,
                                                          _P]
# q, k, v, skip, w_out, out, batch, h, w, heads, e, kernel_size, scale,
# stream
_PROJ_SIGNATURE = [_P] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, _P]


def na2d_reference(q, k, v, kernel_size, scale=1.0):
    """Plain version: masked dense attention, q/k/v (b, h, w, heads, e)."""
    return neighborhood_attention(q, k, v, kernel_size, scale=scale)


def reference(q, k, v, n_heads, kernel_size, scale=1.0):
    """Plain version on channel-packed maps (b, h, w, heads * e)."""
    b, h, w, c = q.shape
    split = (b, h, w, n_heads, c // n_heads)
    out = na2d_reference(q.reshape(split), k.reshape(split), v.reshape(split),
                         kernel_size, scale)
    return out.reshape(b, h, w, c)


def reference_backward(q, k, v, dout, n_heads, kernel_size, scale=1.0):
    """Plain version of the backward: autograd through ``reference``.
    Returns (dq, dk, dv)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = reference(*inputs, n_heads, kernel_size, scale)
        return torch.autograd.grad(out, inputs, dout)


def heads_reference_backward(q, k, v, dout, kernel_size, scale=1.0):
    """Plain version of K12: autograd through ``na2d_reference`` on (b, h,
    w, heads, e) maps. Returns (dq, dk, dv)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = na2d_reference(*inputs, kernel_size, scale)
        return torch.autograd.grad(out, inputs, dout)


def proj_reference(q, k, v, skip, w_out, n_heads, kernel_size, scale=1.0):
    """Plain version of K15: ``reference(q, k, v) @ w_out + skip`` on
    channel-packed maps (b, h, w, c), w_out (c, c) cast to q's dtype."""
    out = reference(q, k, v, n_heads, kernel_size, scale)
    return out @ w_out.to(out.dtype) + skip


def packed_takes(c, e):
    """Whether the HDiT sends an NA level of width c = heads * e to K2 rather
    than to the per-head K11: the JAX dispatcher's test (c <= 512, c a
    multiple of 128, whole heads per 128-lane block, which e == 64 always
    meets) restricted to e == 64, the only head dim K2 takes."""
    return e == 64 and c <= 512 and c % 128 == 0


def _dtype(q, what):
    """Raises unless q is bfloat16 or float32. Returns its dtype, which
    every operand of the launch must share."""
    if q.dtype not in DTYPES:
        raise ValueError(f"{what}: q is {q.dtype}; the kernels take "
                         f"bfloat16 or float32")
    return q.dtype


def _check(q, n_heads, kernel_size, what, head_dims=(64,)):
    """Raises unless q (b, h, w, c) is as the packed kernels take it: a CUDA
    tensor, bfloat16 or float32, c = heads * e with e in ``head_dims``, h
    and w multiples of 8, kernel_size <= min(7, h, w). Returns e."""
    _build.require_cuda(q, what)
    _dtype(q, what)
    b, h, w, c = q.shape
    e = c // n_heads
    if c != e * n_heads or e not in head_dims or h % TILE or w % TILE or \
            not 1 <= kernel_size <= min(MAX_KERNEL, h, w):
        dims = " or ".join(map(str, head_dims))
        raise ValueError(
            f"{what}: kernel takes head dim {dims}, h and w multiples of "
            f"{TILE} and kernel_size <= min({MAX_KERNEL}, h, w); got "
            f"{tuple(q.shape)} with {n_heads} heads, kernel_size "
            f"{kernel_size}")
    return e


def _check_heads(q, k, v, kernel_size, what):
    """Raises unless q, k, v are as K11 and K12 take them: CUDA tensors of
    one dtype, bfloat16 or float32, and one shape (b, h, w, heads, e), e in
    HEAD_DIMS, h and w multiples of 8, the head
    axis packed at e and the head dim contiguous, the other strides
    multiples of 16 bytes (8 bfloat16 or 4 float32 elements), 16-byte
    aligned. Returns the nine strides (q's, k's, v's batch, row and column)
    as a ctypes array."""
    _build.require_cuda(q, what)
    dtype = _dtype(q, what)
    b, h, w, heads, e = q.shape
    if e not in HEAD_DIMS or h % TILE or w % TILE or not (
            1 <= kernel_size <= min(MAX_KERNEL, h, w)):
        raise ValueError(
            f"{what}: kernel takes head dim in {HEAD_DIMS}, h and w multiples "
            f"of {TILE} and kernel_size <= min({MAX_KERNEL}, h, w); got "
            f"{tuple(q.shape)}, kernel_size {kernel_size}")
    per_row = 16 // q.element_size()  # elements in 16 bytes
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != dtype or t.shape != q.shape:
            raise ValueError(
                f"{what}: {name} is {t.dtype} {tuple(t.shape)} on {t.device}; "
                f"the kernel takes q's dtype, shape and device: {dtype} "
                f"{tuple(q.shape)} on {q.device}")
        if not (t.stride()[3:] == (e, 1)
                and all(st % per_row == 0 for st in t.stride()[:3])
                and t.data_ptr() % 16 == 0):
            raise ValueError(
                f"{what}: {name} has strides {t.stride()} at offset "
                f"{t.data_ptr() % 16} mod 16 bytes; the kernel takes strides "
                f"(x, y, z, {e}, 1), x, y and z multiples of {per_row} "
                f"({dtype}), 16-byte aligned")
    return (ctypes.c_long * 9)(*(st for t in (q, k, v)
                                 for st in t.stride()[:3]))


def packed_forward(q, k, v, n_heads, kernel_size, scale=1.0, save_lse=False):
    """Launches K2 (its float32 form on float32 operands) on CUDA tensors.
    Returns (out, lse): out in q's dtype, lse (b, heads, h, w) float32, the
    logsumexp of each query's logits, or None unless ``save_lse``."""
    _check(q, n_heads, kernel_size, "na2d_packed")
    dtype = q.dtype
    b, h, w, c = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.device, dtype, (b, h, w, c))
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_heads, h, w), device=q.device,
                       dtype=torch.float32) if save_lse else None)
    lib = _build.load("na2d", kdt_na2d_packed=_SIGNATURE,
                      kdt_na2d_packed_f32=_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out)),
            None if lse is None else _build.ptr(lse), b, h, w, n_heads,
            kernel_size, scale, _build.stream_ptr(q.device))
    global launches, launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_na2d_packed_f32", "na2d_packed", q.device,
                      *args)
        launches_f32 += 1
    else:
        _build.launch(lib, "kdt_na2d_packed", "na2d_packed", q.device, *args)
        launches += 1
    return out, lse


def overlap_add_targets(h, w, kernel_size, device):
    """Where the overlap-add sends each halo row: (tiles * 196,) flat key
    positions y * w + x, tile by tile, and h * w (a row past the map) where
    the halo runs past the map's edge. Tile (ty, tx)'s halo is the 14 x 14
    block of keys from its clamped window origin (the window start of its
    first query), row-major."""
    halo, r = TILE + MAX_KERNEL - 1, (kernel_size - 1) // 2
    starts = lambda n: torch.clamp(
        torch.arange(0, n, TILE, device=device) - r, 0, n - kernel_size)
    ky = starts(h)[:, None] + torch.arange(halo, device=device)  # (th, 14)
    kx = starts(w)[:, None] + torch.arange(halo, device=device)  # (tw, 14)
    ky, kx = ky[:, None, :, None], kx[None, :, None, :]
    inside = (ky < h) & (kx < w)                    # (th, tw, 14, 14)
    return torch.where(inside, ky * w + kx, h * w).reshape(-1)


def overlap_add_reference(dk_part, dv_part, h, w, kernel_size,
                          dtype=torch.bfloat16):
    """Plain version of K8 (of its float32 form with ``dtype`` float32):
    sums the per-tile halo partials (b, heads, tiles, HALO_KEYS, 64) into
    dk, dv (b, h, w, heads * 64) of ``dtype``; a tile's halo fills the
    first 196 of its HALO_KEYS rows (``overlap_add_targets``)."""
    b, n_heads, _, _, e = dk_part.shape
    halo = TILE + MAX_KERNEL - 1
    dev = dk_part.device
    target = overlap_add_targets(h, w, kernel_size, dev)
    sums = []
    for part in (dk_part, dv_part):
        keys = part[:, :, :, :halo * halo].reshape(b, n_heads, -1, e).float()
        out = torch.zeros((b, n_heads, h * w + 1, e), device=dev)
        out.index_add_(2, target, keys)
        sums.append(out[:, :, :-1].permute(0, 2, 1, 3).reshape(
            b, h, w, n_heads * e).to(dtype))
    return tuple(sums)


def packed_backward_partials_reference(q, k, v, dout, n_heads, kernel_size,
                                       scale=1.0):
    """Plain per-tile halo partials, laid out as K8 takes them: for each
    8 x 8 query tile, the plain backward's dk and dv from that tile's
    queries alone (dout zeroed elsewhere), which lie inside the tile's
    14 x 14 halo (``overlap_add_targets``), as (b, heads, tiles, HALO_KEYS,
    64) float32; rows past the halo's 196 keys, and halo keys past the map,
    are zero. ``overlap_add_reference`` of them is the full dk, dv."""
    b, h, w, c = q.shape
    halo, r = TILE + MAX_KERNEL - 1, (kernel_size - 1) // 2
    tiles_w = w // TILE
    n_tiles = (h // TILE) * tiles_w
    parts = [torch.zeros((b, n_heads, n_tiles, HALO_KEYS, c // n_heads),
                         device=q.device) for _ in range(2)]
    for t in range(n_tiles):
        y, x = t // tiles_w * TILE, t % tiles_w * TILE
        d_tile = torch.zeros_like(dout)
        d_tile[:, y:y + TILE, x:x + TILE] = dout[:, y:y + TILE, x:x + TILE]
        _, dk, dv = reference_backward(q, k, v, d_tile, n_heads, kernel_size,
                                       scale)
        y0 = min(max(y - r, 0), h - kernel_size)
        x0 = min(max(x - r, 0), w - kernel_size)
        for part, grad in zip(parts, (dk, dv)):
            inside = grad[:, y0:y0 + halo, x0:x0 + halo].float()
            block = torch.zeros((b, halo, halo, c), device=q.device)
            block[:, :inside.shape[1], :inside.shape[2]] = inside
            part[:, :, t, :halo * halo] = block.reshape(
                b, halo * halo, n_heads, -1).transpose(1, 2)
    return tuple(parts)


def overlap_add(dk_part, dv_part, h, w, kernel_size, dtype=torch.bfloat16):
    """Launches K8 (its float32 form where ``dtype`` is float32) on CUDA
    tensors: per-tile halo partials (b, heads, tiles, HALO_KEYS, 64)
    float32 -> (dk, dv) (b, h, w, heads * 64) of ``dtype``, bfloat16 or
    float32, as the JAX kernel writes its partials' dtype."""
    _build.require_cuda(dk_part, "na2d overlap-add")
    if dtype not in DTYPES:
        raise ValueError(f"na2d overlap-add: writes bfloat16 or float32, "
                         f"not {dtype}")
    b, n_heads = dk_part.shape[:2]
    part = (b, n_heads, (h // TILE) * (w // TILE), HALO_KEYS, 64)
    for name, t in (("dk_part", dk_part), ("dv_part", dv_part)):
        _build.require(t, name, dk_part.device, torch.float32, part)
    dk, dv = (torch.empty((b, h, w, n_heads * 64), device=dk_part.device,
                          dtype=dtype) for _ in range(2))
    lib = _build.load("na2d", kdt_na2d_overlap_add=_OVERLAP_SIGNATURE,
                      kdt_na2d_overlap_add_f32=_OVERLAP_SIGNATURE)
    args = (*map(_build.ptr, (dk_part, dv_part, dk, dv)), b, h, w, n_heads,
            kernel_size, _build.stream_ptr(dk_part.device))
    global overlap_launches, overlap_launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_na2d_overlap_add_f32", "na2d overlap-add",
                      dk_part.device, *args)
        overlap_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_na2d_overlap_add", "na2d overlap-add",
                      dk_part.device, *args)
        overlap_launches += 1
    return dk, dv


def packed_backward(q, k, v, out, lse, dout, n_heads, kernel_size,
                    scale=1.0):
    """Launches K7 (its float32 form on float32 operands; its dq kernel,
    then its dk/dv kernel: one counted launch) on CUDA tensors: returns
    (dq, dk, dv) in q's dtype, each (b, h, w, heads * 64). delta =
    rowsum(out * dout) is formed by the dq kernel."""
    _check(q, n_heads, kernel_size, "na2d_packed backward")
    dtype = q.dtype
    b, h, w, c = q.shape
    dev = q.device
    dout = dout.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout)):
        _build.require(t, name, dev, dtype, (b, h, w, c))
    _build.require(lse, "lse", dev, torch.float32, (b, n_heads, h, w))
    delta = torch.empty((b, n_heads, h, w), device=dev, dtype=torch.float32)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _build.load("na2d", kdt_na2d_packed_bwd=_BWD_SIGNATURE,
                      kdt_na2d_packed_bwd_f32=_BWD_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            b, h, w, n_heads, kernel_size, scale, _build.stream_ptr(dev))
    global bwd_launches, bwd_launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_na2d_packed_bwd_f32", "na2d_packed backward",
                      dev, *args)
        bwd_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_na2d_packed_bwd", "na2d_packed backward", dev,
                      *args)
        bwd_launches += 1
    return dq, dk, dv


def heads_forward(q, k, v, kernel_size, scale=1.0, save_lse=False):
    """Launches K11 (its float32 form on float32 operands) on CUDA tensors
    (b, h, w, heads, e). Returns (out, lse): out (b, h, w, heads, e) in q's
    dtype, contiguous, lse (b, heads, h, w) float32, or None unless
    ``save_lse``."""
    strides = _check_heads(q, k, v, kernel_size, "na2d")
    b, h, w, heads, e = q.shape
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = (torch.empty((b, heads, h, w), device=q.device,
                       dtype=torch.float32) if save_lse else None)
    lib = _build.load("na2d_heads", kdt_na2d_heads=_HEADS_SIGNATURE,
                      kdt_na2d_heads_f32=_HEADS_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out)),
            None if lse is None else _build.ptr(lse), b, h, w, heads, e,
            kernel_size, scale, strides, _build.stream_ptr(q.device))
    global heads_launches, heads_launches_f32
    if q.dtype == torch.float32:
        _build.launch(lib, "kdt_na2d_heads_f32", "na2d", q.device, *args)
        heads_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_na2d_heads", "na2d", q.device, *args)
        heads_launches += 1
    return out, lse


def heads_backward(q, k, v, out, lse, dout, kernel_size, scale=1.0):
    """Launches K12 (its float32 form on float32 operands) on CUDA tensors:
    returns (dq, dk, dv) in q's dtype, each (b, h, w, heads, e)
    contiguous. delta = rowsum(out * dout) is formed by the dq kernel in
    either dtype at every head dim (the JAX package forms it outside its
    kernels); here it is only allocated."""
    strides = _check_heads(q, k, v, kernel_size, "na2d backward")
    b, h, w, heads, e = q.shape
    dev = q.device
    dout = dout.contiguous()
    for name, t in (("out", out), ("dout", dout)):
        _build.require(t, name, dev, q.dtype, q.shape)
    _build.require(lse, "lse", dev, torch.float32, (b, heads, h, w))
    delta = torch.empty((b, heads, h, w), device=dev, dtype=torch.float32)
    dq, dk, dv = (torch.empty(q.shape, device=dev, dtype=q.dtype)
                  for _ in range(3))
    lib = _build.load("na2d_heads", kdt_na2d_heads_bwd=_HEADS_BWD_SIGNATURE,
                      kdt_na2d_heads_bwd_f32=_HEADS_BWD_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, out, dout, lse, delta, dq, dk, dv)), b,
            h, w, heads, e, kernel_size, scale, strides,
            _build.stream_ptr(dev))
    global heads_bwd_launches, heads_bwd_launches_f32
    if q.dtype == torch.float32:
        _build.launch(lib, "kdt_na2d_heads_bwd_f32", "na2d backward", dev,
                      *args)
        heads_bwd_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_na2d_heads_bwd", "na2d backward", dev, *args)
        heads_bwd_launches += 1
    return dq, dk, dv


def na2d(q, k, v, kernel_size, scale=1.0):
    """Neighborhood attention per head: q, k, v (b, h, w, heads, e) ->
    (b, h, w, heads, e); differentiable. The kernels take bfloat16 or
    float32 with e in ``HEAD_DIMS``, h and w multiples of 8, kernel_size
    <= min(7, h, w), and q, k, v of any strides whose last two are (e, 1)
    and whose others are multiples of 16 bytes."""
    static = {"kernel_size": kernel_size, "scale": scale}
    if q.device.type == "cpu":
        return residuals.plain(
            q, k, v, functools.partial(na2d_reference, **static),
            functools.partial(heads_reference_backward, **static))
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return heads_forward(q, k, v, kernel_size, scale)[0]
    return residuals.attention(
        q, k, v, functools.partial(heads_forward, **static, save_lse=True),
        functools.partial(heads_backward, **static))


def proj_forward(q, k, v, skip, w_out, n_heads, kernel_size, scale=1.0):
    """Launches K15 (its float32 form on float32 operands) on CUDA tensors:
    returns NA(q, k, v) @ w_out + skip, (b, h, w, c) in q's dtype; w_out is
    cast to q's dtype, as the JAX dispatcher casts it. Head dim 128 and
    above raises before any launch: a softmax is not split over the
    cluster's ranks of 64 channels."""
    e = _check(q, n_heads, kernel_size, "na2d_packed_proj", PROJ_HEAD_DIMS)
    dtype = q.dtype
    b, h, w, c = q.shape
    if c > 512 or c % 128:
        raise ValueError(f"na2d_packed_proj kernel takes c <= 512, a "
                         f"multiple of 128; got {tuple(q.shape)}")
    w_cast = w_out.to(dtype)
    for name, t in (("q", q), ("k", k), ("v", v), ("skip", skip)):
        _build.require(t, name, q.device, dtype, (b, h, w, c))
    _build.require(w_cast, "w_out", q.device, dtype, (c, c))
    out = torch.empty_like(q)
    lib = _build.load("na2d_heads", kdt_na2d_proj=_PROJ_SIGNATURE,
                      kdt_na2d_proj_f32=_PROJ_SIGNATURE)
    args = (*map(_build.ptr, (q, k, v, skip, w_cast, out)), b, h, w, n_heads,
            e, kernel_size, scale, _build.stream_ptr(q.device))
    global proj_launches, proj_launches_f32
    if dtype == torch.float32:
        _build.launch(lib, "kdt_na2d_proj_f32", "na2d_packed_proj", q.device,
                      *args)
        proj_launches_f32 += 1
    else:
        _build.launch(lib, "kdt_na2d_proj", "na2d_packed_proj", q.device,
                      *args)
        proj_launches += 1
    return out


def _attention_vjp(q, k, v, d_att, n_heads, kernel_size, scale):
    """The attention output and (dq, dk, dv) of packed maps (b, h, w, c)
    for the cotangent d_att: K2 (with lse) and K7 at head dim 64; K11 and
    K12 on the (b, h, w, heads, e) views at head dim 32, which K2 and K7 do
    not take (each in its float32 form on float32 maps)."""
    if q.shape[-1] == 64 * n_heads:
        att, lse = packed_forward(q, k, v, n_heads, kernel_size, scale,
                                  save_lse=True)
        return att, packed_backward(q, k, v, att, lse, d_att, n_heads,
                                    kernel_size, scale)
    split = [t.reshape(*t.shape[:3], n_heads, -1) for t in (q, k, v, d_att)]
    att, lse = heads_forward(*split[:3], kernel_size, scale, save_lse=True)
    grads = heads_backward(*split[:3], att, lse, split[3], kernel_size, scale)
    return att.reshape(q.shape), tuple(g.reshape(q.shape) for g in grads)


class _NA2DProj(torch.autograd.Function):
    """K15 forward; the backward recomputes the attention (saving the lse),
    takes its gradients for d(attention) = dout @ w_out^T
    (``_attention_vjp``), and the projection's with torch.matmul: the JAX
    op's backward is the VJP of its plain version, with no Pallas kernel of
    its own."""

    @staticmethod
    def forward(ctx, q, k, v, skip, w_out, n_heads, kernel_size, scale):
        ctx.save_for_backward(q, k, v, w_out)
        ctx.static = (n_heads, kernel_size, scale)
        return proj_forward(q, k, v, skip, w_out, n_heads, kernel_size, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, w_out = ctx.saved_tensors
        d_att = dout @ w_out.to(q.dtype).T
        att, (dq, dk, dv) = _attention_vjp(q, k, v, d_att, *ctx.static)
        c = q.shape[-1]
        dw = (att.reshape(-1, c).T @ dout.reshape(-1, c)).to(w_out.dtype)
        return dq, dk, dv, dout, dw, None, None, None


def na2d_packed_proj(q, k, v, skip, w_out, n_heads, kernel_size, scale=1.0):
    """``na2d_packed`` with a fused epilogue: NA(q, k, v) @ w_out + skip on
    channel-packed maps (b, h, w, c), w_out (c, c); differentiable. No model
    path calls it, as in the JAX package. The kernels take bfloat16 or
    float32, head dim 32 or 64, c <= 512 and a multiple of 128, h and w
    multiples of 8 and kernel_size <= min(7, h, w)."""
    if q.device.type == "cpu":
        return proj_reference(q, k, v, skip, w_out, n_heads, kernel_size,
                              scale)
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, skip, w_out))):
        return proj_forward(q, k, v, skip, w_out, n_heads, kernel_size, scale)
    return _NA2DProj.apply(q, k, v, skip, w_out, n_heads, kernel_size, scale)


def na2d_packed(q, k, v, n_heads, kernel_size, scale=1.0):
    """Neighborhood attention on channel-packed maps: q, k, v
    (b, h, w, heads * e) -> (b, h, w, heads * e); differentiable. The
    kernels take bfloat16 or float32, e == 64, h and w multiples of 8 and
    kernel_size <= min(7, h, w)."""
    static = {"n_heads": n_heads, "kernel_size": kernel_size, "scale": scale}
    if q.device.type == "cpu":
        return residuals.plain(q, k, v, functools.partial(reference, **static),
                               functools.partial(reference_backward, **static))
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return packed_forward(q, k, v, n_heads, kernel_size, scale)[0]
    return residuals.attention(
        q, k, v, functools.partial(packed_forward, **static, save_lse=True),
        functools.partial(packed_backward, **static))
