"""K5: the whole mapping network in one kernel (counterpart of
k_diffusion_tpu/ops/pallas/fused_mapping.py).

RMSNorm -> n x (RMSNorm -> GEGLU FF -> residual) -> RMSNorm on a (batch,
width) activation. CUDA tensors go to the hand-written kernel in
``csrc/geglu.cu`` (``mapping_kernel``): one launch, a thread block cluster
per 16 batch rows whose blocks split the hidden units in panels of 16
(``rank_panels``) and sum their split-K partials of the down projection in
rank order in distributed shared memory. Where a rank's share of a layer's
weights fits one block's shared memory (the HDiT's 256 / 768), every share
is resident; where it does not (the ViT's 512 / 1408 and 768 / 2048, about
305 and 604 KB a layer at 16 ranks), the share streams through a ring of
(16, 256) weight tiles, each rank's down-product partial added up in a
fixed order before the ranks' sum (``layout``). The weights go to the kernel as
they are, one pointer each, float32 (the model's params) or bfloat16: the
kernel rounds them to bfloat16 where it loads them, as the plain version's
``.to(bfloat16)`` does, so the wrapper launches nothing but the kernel. The
backward recomputes through the plain version under autograd, as the JAX
custom_vjp does (there is no Pallas backward). CPU tensors go to
``reference``, the plain version.

A float32 emb with the float32 compute dtype (a model built with
``dtype=torch.float32``, ``--mixed-precision no``) goes to the float32
form in ``csrc/geglu_f32.cu`` (``kdt_mapping_f32``, ``mapping_f32_kernel``
on the TF32 ``wgmma`` core ``csrc/gemm_tf32_wg.cuh``): one launch on the
bf16 form's plan, a cluster of up to 16 ranks per strip of 8, 16, 32 or
64 batch rows (``f32_plan``), each rank owning pairs of 32-unit hidden
panels, the products swapped so that the model's f32 weights, read by TMA
as they lie, are wgmma's 64-row side (the batch is N), the partials summed
over the ranks in rank order in distributed shared memory. Products on the
TF32 tensor cores with f32 accumulation, every operand rounded to TF32;
norms, GELU and the residual stream in f32. It takes d and d_ff multiples
of 64 as long as a strip of 8 rows and two weight stages fit a block
(``f32_stages``; up to d 4 480 at d_ff 8 192), and raises by name past
that before any launch. Its launches are counted apart, one a call.
"""

import ctypes
import functools

import torch

from ..geglu import linear_geglu
from ..norms import rms_norm
from . import _build

launches = 0  # kernel launches since the last reset, bfloat16
launches_f32 = 0  # calls of the float32 form

MAX_DEPTH = 8   # blocks of the network the kernel takes (its MapLayers)
UNIT = 16       # hidden units of a panel, the split's grain
ROWS = 16       # batch rows of a cluster
# the cluster sizes the wrapper tries, most first: more ranks read fewer
# weight bytes an SM; past 8 a cluster is not portable (an H100 takes 16)
CLUSTER_SIZES = (16, 12, 8, 6, 4, 3, 2, 1)

_P = ctypes.c_void_p
# emb, in_scale, out_scale, weights (3 n pointers), out, batch, d, d_ff,
# n_blocks, f32_weights, ranks, eps, stream, clusters (int *: the
# occupancy query)
_SIGNATURE = [_P] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, _P, _P]
# the float32 form: emb, in_scale, out_scale, weights (3 n pointers), out,
# batch, d, d_ff, n_blocks, strip rows, ranks, eps, stream, stamps (int64
# clock counts a block, or None), clusters (int *: the occupancy query)
_F32_SIGNATURE = [_P] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float] + [_P] * 3
# the float32 form's strip widths (wgmma's N), hidden units of a rank's
# pair of panels (its split's grain), ring stages (csrc/geglu_f32.cu:
# MAP_STAGE bytes each, at most MAP_MAX_S) and the clock counts a block
# writes with stamps (MAP_TIMES)
F32_STRIPS = (8, 16, 32, 64)
F32_PAIR = 64
F32_STAGE, F32_MAX_STAGES = 16384, 16
F32_TIMES = 4


def reference(emb, in_scale, out_scale, blocks, eps=1e-6,
              dtype=torch.bfloat16):
    """Plain version: the MappingNetwork chain. emb (b, d); scales (d,);
    blocks: list of (norm_scale (d,), w_up (d, 2 d_ff), w_down (d_ff, d));
    ``dtype`` is the matmul compute dtype."""
    x = rms_norm(emb, in_scale, eps)
    for ns, w_up, w_down in blocks:
        h = linear_geglu(rms_norm(x, ns, eps).to(dtype), w_up.to(dtype))
        x = x + h.to(dtype) @ w_down.to(dtype)
    return rms_norm(x, out_scale, eps)


def rank_panels(d_ff, ranks, rank):
    """The hidden panels [first, end) that rank ``rank`` of a cluster of
    ``ranks`` owns, as the kernel splits them: d_ff / 16 panels of 16
    units, in ranges as even as they come."""
    panels = d_ff // UNIT
    return panels * rank // ranks, panels * (rank + 1) // ranks


# the kernel's shared memory (csrc/geglu.cu, MapLayout): an H100 block's
# 232448 bytes less static room; a streamed tile's rows, columns and
# padding; the ring's most stages
SMEM_MAX = 232448 - 1024
TILE, TILE_PAD, MAX_STAGES = 256, 8, 8


def layout(d, d_ff, n, ranks, f32):
    """K5's path at one shape and cluster size, as ``MapLayout`` in
    csrc/geglu.cu sizes it: ("resident", the layer shares that fit at
    once) where one layer's share fits a block's shared memory, else
    ("stream", ring stages); ("none", 0) where not two stages fit either."""
    ur = -(-(d_ff // UNIT) // ranks) * UNIT
    ldp = (max(d, ur) if d > 256 else max(ur, 256)) + 4
    fixed = (ROWS * (d + 4 + ldp) + (n + 2) * d) * 4 + ROWS * (d + 8 + ur + 8) * 2
    layer = d * (2 * ur + 8) * 2 + ur * (d + 8) * 2
    buffers = min(max(SMEM_MAX - fixed, 0) // layer, n)
    if buffers:
        return "resident", buffers
    stage = ROWS * TILE * 4 if f32 else ROWS * (TILE + TILE_PAD) * 2
    operand = ROWS * (TILE + TILE_PAD) * 2 if f32 else 0
    stages = min(max(SMEM_MAX - fixed - operand, 0) // stage, MAX_STAGES)
    return ("stream", stages) if stages >= 2 else ("none", 0)


def _query(index, d, d_ff, n, f32, ranks):
    """How many K5 clusters of ``ranks`` blocks fit on CUDA device
    ``index`` at once; 0 where the device or the shared memory refuses the
    size."""
    lib = _build.load("geglu", kdt_mapping=_SIGNATURE)
    clusters = ctypes.c_int(0)
    with torch.cuda.device(index):
        status = lib.kdt_mapping(None, None, None, None, None, ROWS, d, d_ff,
                                 n, int(f32), ranks, 0.0, None,
                                 ctypes.byref(clusters))
    return clusters.value if status == 0 else 0


@functools.lru_cache(maxsize=None)
def cluster_size(index, d, d_ff, n, f32):
    """K5's ranks a cluster on CUDA device ``index``: the first of
    ``CLUSTER_SIZES`` that does not exceed the panels and of which the
    device can place a cluster with its shared memory. Raises ValueError
    where none fits."""
    for ranks in CLUSTER_SIZES:
        if ranks <= d_ff // UNIT and _query(index, d, d_ff, n, f32, ranks):
            return ranks
    raise ValueError(f"fused_mapping kernel: no cluster of up to 16 blocks "
                     f"takes a layer's weight share, resident or streamed, "
                     f"at d={d}, d_ff={d_ff}")


def f32_rank_pairs(d_ff, ranks, rank):
    """The pairs of 32-unit hidden panels [first, end), 64 units each, that
    rank ``rank`` of a float32 cluster of ``ranks`` owns, as
    ``mapping_f32_kernel`` splits them."""
    pairs = d_ff // F32_PAIR
    return pairs * rank // ranks, pairs * (rank + 1) // ranks


def f32_stages(d, d_ff, rows, ranks):
    """The ring stages of the float32 kernel's shared memory at a strip of
    ``rows`` batch rows over ``ranks`` ranks, as ``MapLayout`` in
    csrc/geglu_f32.cu sizes it: what is left beside the strip's xn (its f32
    partial in the same place, rows of d + 4 floats), the rank's h tiles
    and its owned rows' x and xn; fewer than 2 do not run."""
    def up(n):
        return -(-n // 1024) * 1024
    xs = up(rows * (d + 4) * 4)
    hs = 2 * -(-(d_ff // F32_PAIR) // ranks) * rows * 128
    own = up(2 * -(-rows // ranks) * d * 4)
    return min(F32_MAX_STAGES, (SMEM_MAX - 1024 - xs - hs - own) // F32_STAGE)


def f32_check_width(d, d_ff):
    """Raises ValueError, naming the limit, where no strip fits one block:
    the narrowest strip (8 rows) at the most ranks leaves fewer than two
    ring stages."""
    ranks = min(CLUSTER_SIZES[0], d_ff // F32_PAIR)
    if f32_stages(d, d_ff, F32_STRIPS[0], ranks) < 2:
        raise ValueError(
            f"fused_mapping float32 kernel: at d={d}, d_ff={d_ff} a strip of "
            f"{F32_STRIPS[0]} batch rows and two weight stages do not fit "
            f"one block's shared memory (the kernel takes up to d 4 480 at "
            f"d_ff 8 192)")


def _query_f32(index, d, d_ff, n, rows, ranks):
    """How many float32 K5 clusters of ``ranks`` blocks at a strip of
    ``rows`` rows fit on CUDA device ``index`` at once; 0 where the device
    or the shared memory refuses the size."""
    lib = _build.load("geglu_f32", kdt_mapping_f32=_F32_SIGNATURE)
    clusters = ctypes.c_int(0)
    with torch.cuda.device(index):
        status = lib.kdt_mapping_f32(None, None, None, None, None, rows, d,
                                     d_ff, n, rows, ranks, 0.0, None, None,
                                     ctypes.byref(clusters))
    return clusters.value if status == 0 else 0


@functools.lru_cache(maxsize=None)
def f32_plan(index, b, d, d_ff, n):
    """The float32 kernel's (strip rows, ranks) on CUDA device ``index``:
    the narrowest strip width that holds the batch (64 at most), narrowed
    while its shared memory leaves fewer than two ring stages; the first of
    ``CLUSTER_SIZES`` that does not exceed the pairs of panels and of which
    the device can place a cluster. Raises ValueError where none fits."""
    widest = next(r for r in F32_STRIPS if r >= min(b, F32_STRIPS[-1]))
    for rows in reversed([r for r in F32_STRIPS if r <= widest]):
        for ranks in CLUSTER_SIZES:
            if (ranks <= d_ff // F32_PAIR
                    and f32_stages(d, d_ff, rows, ranks) >= 2
                    and _query_f32(index, d, d_ff, n, rows, ranks)):
                return rows, ranks
    raise ValueError(f"fused_mapping float32 kernel: no cluster of up to 16 "
                     f"blocks fits at d={d}, d_ff={d_ff}")


def mapping_forward(emb, in_scale, out_scale, blocks, eps=1e-6,
                    dtype=torch.bfloat16):
    """Launches K5 (its float32 form on a float32 emb and compute dtype) on
    CUDA tensors: one launch, nothing else. Any batch: one cluster per 16
    rows."""
    _build.require_cuda(emb, "fused_mapping")
    b, d = emb.shape
    d_ff = blocks[0][2].shape[0]
    if dtype not in (torch.bfloat16, torch.float32) or emb.dtype != dtype \
            or d % 64 or d_ff % 64:
        raise ValueError(
            f"fused_mapping kernel takes a bfloat16 or float32 emb of the "
            f"compute dtype and d, d_ff multiples of 64; got emb "
            f"{emb.dtype} {tuple(emb.shape)}, d_ff={d_ff}, compute dtype "
            f"{dtype}")
    n = len(blocks)
    if not 1 <= n <= MAX_DEPTH:
        raise ValueError(f"fused_mapping kernel takes 1 to {MAX_DEPTH} "
                         f"blocks; got {n}")
    if dtype == torch.float32:
        return _forward_f32(emb, in_scale, out_scale, blocks, eps)
    dev, f32 = emb.device, torch.float32
    w_dtype = blocks[0][1].dtype
    if w_dtype not in (f32, torch.bfloat16):
        raise ValueError(f"fused_mapping kernel takes float32 or bfloat16 "
                         f"weights; got {w_dtype}")
    in_scale, out_scale = in_scale.float(), out_scale.float()
    _build.require(emb, "emb", dev, torch.bfloat16, (b, d))
    _build.require(in_scale, "in_scale", dev, f32, (d,))
    _build.require(out_scale, "out_scale", dev, f32, (d,))
    weights = []
    for i, (ns, w_up, w_down) in enumerate(blocks):
        ns = ns.float()
        _build.require(ns, f"norm scale {i}", dev, f32, (d,))
        _build.require(w_up, f"w_up {i}", dev, w_dtype, (d, 2 * d_ff))
        _build.require(w_down, f"w_down {i}", dev, w_dtype, (d_ff, d))
        weights += [ns, w_up, w_down]
    index = torch.cuda.current_device() if dev.index is None else dev.index
    ranks = cluster_size(index, d, d_ff, n, w_dtype == f32)
    out = torch.empty_like(emb)
    lib = _build.load("geglu", kdt_mapping=_SIGNATURE)
    _build.launch(
        lib, "kdt_mapping", "fused_mapping", dev,
        *map(_build.ptr, (emb, in_scale, out_scale)),
        (_P * len(weights))(*(t.data_ptr() for t in weights)),
        _build.ptr(out), b, d, d_ff, n, int(w_dtype == f32), ranks, eps,
        _build.stream_ptr(dev), None)
    global launches
    launches += 1
    return out


def _forward_f32(emb, in_scale, out_scale, blocks, eps, stamps=None):
    """K5's float32 form on a checked float32 emb: every weight float32.
    ``stamps``, where given, is an int64 CUDA tensor of (strips * ranks,
    F32_TIMES) that takes each block's clock counts (csrc/geglu_f32.cu,
    kdt_mapping_f32)."""
    b, d = emb.shape
    d_ff = blocks[0][2].shape[0]
    f32_check_width(d, d_ff)
    dev, f32 = emb.device, torch.float32
    _build.require(emb, "emb", dev, f32, (b, d))
    _build.require(in_scale, "in_scale", dev, f32, (d,))
    _build.require(out_scale, "out_scale", dev, f32, (d,))
    weights = []
    for i, (ns, w_up, w_down) in enumerate(blocks):
        _build.require(ns, f"norm scale {i}", dev, f32, (d,))
        _build.require(w_up, f"w_up {i}", dev, f32, (d, 2 * d_ff))
        _build.require(w_down, f"w_down {i}", dev, f32, (d_ff, d))
        weights += [ns, w_up, w_down]
    index = torch.cuda.current_device() if dev.index is None else dev.index
    rows, ranks = f32_plan(index, b, d, d_ff, len(blocks))
    out = torch.empty_like(emb)
    lib = _build.load("geglu_f32", kdt_mapping_f32=_F32_SIGNATURE)
    _build.launch(
        lib, "kdt_mapping_f32", "fused_mapping", dev,
        *map(_build.ptr, (emb, in_scale, out_scale)),
        (_P * len(weights))(*(t.data_ptr() for t in weights)),
        _build.ptr(out), b, d, d_ff, len(blocks), rows, ranks, eps,
        _build.stream_ptr(dev), None if stamps is None else _build.ptr(stamps),
        None)
    global launches_f32
    launches_f32 += 1
    return out


def _unflatten(flat):
    return flat[0], flat[1], flat[2], [tuple(flat[i:i + 3])
                                       for i in range(3, len(flat), 3)]


class _Mapping(torch.autograd.Function):
    """K5 forward; the backward differentiates the plain version,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, eps, dtype, *flat):
        ctx.save_for_backward(*flat)
        ctx.static = (eps, dtype)
        emb, in_scale, out_scale, blocks = _unflatten(flat)
        return mapping_forward(emb, in_scale, out_scale, blocks, eps, dtype)

    @staticmethod
    def backward(ctx, g):
        eps, dtype = ctx.static
        with torch.enable_grad():
            flat = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            emb, in_scale, out_scale, blocks = _unflatten(flat)
            out = reference(emb, in_scale, out_scale, blocks, eps, dtype)
            grads = torch.autograd.grad(out, flat, g)
        return (None, None, *grads)


def fused_mapping(emb, in_scale, out_scale, blocks, eps=1e-6,
                  dtype=torch.bfloat16):
    """Returns the mapping-network output (b, d) in emb's dtype;
    differentiable. The kernel takes a bfloat16 emb and compute dtype, d
    and d_ff multiples of 64, 1 to ``MAX_DEPTH`` blocks whose weights are
    all float32 or all bfloat16, any batch; its residual stream stays
    float32, as the Pallas kernel's does. Its float32 form takes a float32
    emb and compute dtype and float32 weights."""
    if emb.device.type == "cpu":
        return reference(emb, in_scale, out_scale, blocks, eps, dtype)
    if not torch.is_grad_enabled():  # sampling: no autograd node to build
        return mapping_forward(emb, in_scale, out_scale, blocks, eps, dtype)
    flat = [emb, in_scale, out_scale, *(t for blk in blocks for t in blk)]
    return _Mapping.apply(eps, dtype, *flat)
