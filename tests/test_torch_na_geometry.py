"""The neighborhood geometry of the port's wgmma NA kernels on the CPU.

The forward (csrc/na_fwd.cuh, K2 and K11) and the dq kernel of the backward
(csrc/na_bwd.cuh, K7 and K12) run attention bodies over ``NaQueries``
(csrc/na2d.cuh): a block owns an 8 x 8 query tile, and the tile's key halo
streams past as 64-row tiles of 4 halo rows x 16 key slots, each pair
masked to the query's window. CUDA does not run here, so ``NaQueries``
below is its Python mirror, line for line, held against the JAX package's
NATTEN mask (k_diffusion_tpu/ops/attention.py): every key of every query's
clamped window lands in exactly one (tile, slot) of the query's block, and
no slot past the halo or the map attends. Then the forward's streamed
online softmax, run over that geometry in numpy with the kernel's guard for
rows whose running max is still -inf, is held against the JAX package's
``na2d_reference`` and the masked logsumexp; without the guard those rows
turn to NaN, which shows which rows the guard is for.

The dk/dv kernel of the backward runs over ``NaKeys``: a block owns an 8 x
8 key tile, and the slab of queries whose clamped windows reach it streams
past as 64-row tiles of 4 slab rows x 16 query slots. ``NaKeys`` and
``Reach`` below mirror it; the two-kernel streamed backward (dq over query
tiles, dk and dv over key tiles, delta = rowsum(out * dout)), run over both
geometries in numpy float32, is held against ``jax.vjp`` of the JAX
package's ``na2d_reference``.

Both mirrors also run with each product's operands rounded as a kernel
rounds them: to TF32 by ``cvt.rna`` (csrc/attn_tf32.cuh, the float32 forms
of K2, K7, K11 and K12 in csrc/na_tf32.cuh; mirrored on the float32 bits:
10 mantissa bits, ties away from zero) and to bfloat16 (the bf16 kernels,
round to nearest even; out and dout in bf16, as those kernels read them),
the softmax, lse and delta in float32. The TF32
mirror stays within 5e-3 x max|ref| of JAX, and its error against the
unrounded mirror in float64 (relative L2) is at most 1/4 of the bf16
mirror's, output by output: TF32 keeps 3 mantissa bits more than bf16.

K15 (csrc/na_proj.cuh) runs the forward over ``NaQueries`` in a thread
block cluster per query tile, one rank per 64 channels, then sums the
ranks' attention tiles times blocks of w_out in a rotating order;
``proj_schedule`` mirrors that schedule and is held against the JAX
package's ``na2d_packed_proj``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

j_attn = importlib.import_module("k_diffusion_tpu.ops.attention")
j_na = importlib.import_module("k_diffusion_tpu.ops.pallas.na2d")

TQ = 8               # query tile edge (na2d.cuh)
SLOTS = 16           # key slots of a halo row
BANDS = 64 // SLOTS  # halo rows of a streamed 64-row tile
# float32 on both sides, the same operations summed in another order
F32_TOL = 2e-5
# the TF32 mirror against JAX in float32, x max|ref| (the bound chip_smoke.py
# states for the float32 kernels against their plain versions), and its
# error against float64 at most this share of the bf16 mirror's
TF32_TOL, TF32_SHARE = 5e-3, 0.25
# the bf16 mirror against JAX, x max|ref| (the bf16 kernels' bound)
BF16_TOL = 3e-2
ROUNDINGS = ("none", "tf32", "bf16")


def rounded(x, rounding):
    """x with each element rounded as a kernel rounds a product's operand:
    "tf32" as cvt.rna.tf32.f32 (the float32 bits plus half of the 13
    dropped bits' place, then truncated: nearest, ties away from zero),
    "bf16" to nearest even bfloat16, "none" unchanged; in x's dtype."""
    if rounding == "none":
        return x
    bits = np.asarray(x, np.float32).view(np.uint32)
    if rounding == "tf32":
        bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    else:
        bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
    return bits.view(np.float32).astype(np.asarray(x).dtype)


def rel_errors(got, want, scale=None):
    """max|got - want| over max|want| for each pair (over ``scale``'s max
    where want is all zero)."""
    errs = []
    for a, b_ in zip(got, want):
        top = np.abs(b_).max() or np.abs(scale).max()
        errs.append(np.abs(np.asarray(a, np.float64) - b_).max() / top)
    return errs


def l2_errors(got, want):
    """Relative L2 error of each pair: the share tests' statistic, as the
    max over the few thousand elements of the smallest maps swings by 2x
    between seeds."""
    return [np.linalg.norm(np.asarray(a, np.float64) - b_) / np.linalg.norm(b_)
            for a, b_ in zip(got, want)]


class NaQueries:
    """Mirror of csrc/na2d.cuh's NaQueries over numpy index arrays: the
    block of 8 x 8 query tile ``tile`` (row-major over the map's tiles)."""

    def __init__(self, tile, h, w, ks):
        self.h, self.w, self.ks = h, w, ks
        tiles_w = w // TQ
        self.y0, self.x0 = tile // tiles_w * TQ, tile % tiles_w * TQ
        self.r = (ks - 1) // 2
        self.hr0 = np.clip(self.y0 - self.r, 0, h - ks)
        self.hc0 = np.clip(self.x0 - self.r, 0, w - ks)
        self.he = TQ + ks - 1
        self.tiles = (self.he + BANDS - 1) // BANDS

    def own(self, i):
        return self.y0 + i // TQ, self.x0 + i % TQ

    def stream(self, j, i):
        hy, hx = BANDS * j + i // SLOTS, i % SLOTS
        y, x = self.hr0 + hy, self.hc0 + hx
        return y, x, (hy < self.he) & (hx < self.he) & (y < self.h) & (
            x < self.w)

    def own_info(self, i):
        return (np.clip(self.y0 + i // TQ - self.r, 0, self.h - self.ks),
                np.clip(self.x0 + i % TQ - self.r, 0, self.w - self.ks))

    def mask(self, j, col, info):
        wy, wx = info
        ky = self.hr0 + BANDS * j + col // SLOTS
        kx = self.hc0 + col % SLOTS
        # the kernel's unsigned compares: 0 <= ky - wy < ks
        return (0 <= ky - wy) & (ky - wy < self.ks) & (0 <= kx - wx) & (
            kx - wx < self.ks)


def block_layout(geo):
    """For each own row i, streamed tile j and slot col of ``geo``'s block:
    the key's flat map position (y * w + x), whether the slot holds a key,
    and whether the pair attends; arrays (64, tiles, 64)."""
    i = np.arange(64)[:, None, None]
    j = np.arange(geo.tiles)[None, :, None]
    col = np.arange(64)[None, None, :]
    y, x, ok = geo.stream(j, col)
    attends = geo.mask(j, col, geo.own_info(i))
    shape = (64, geo.tiles, 64)
    return (np.broadcast_to(y * geo.w + x, shape), np.broadcast_to(ok, shape),
            attends)


def jax_mask(h, w, ks):
    """The JAX package's NATTEN mask over the h * w row-major positions,
    (query, key) bool."""
    mh = j_attn.neighborhood_mask_1d(h, ks)
    mw = j_attn.neighborhood_mask_1d(w, ks)
    return (mh[:, None, :, None] & mw[None, :, None, :]).reshape(h * w, h * w)


@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (64, 64)])
@pytest.mark.parametrize("ks", range(1, 8))
def test_every_window_key_streams_once(h, w, ks):
    want = jax_mask(h, w, ks)
    for tile in range(h // TQ * (w // TQ)):
        geo = NaQueries(tile, h, w, ks)
        assert geo.tiles == -(-(TQ + ks - 1) // BANDS)
        pos, ok, attends = block_layout(geo)
        # no slot past the halo or the map attends for any row
        assert not (attends & ~ok).any()
        qy, qx = geo.own(np.arange(64))
        for i, query in enumerate(qy * w + qx):
            counts = np.bincount(pos[i][attends[i]], minlength=h * w)
            # each key of the query's window exactly once, nothing else
            np.testing.assert_array_equal(counts, want[query].astype(int))


def rows_without_key(h, w, ks, j):
    """(tile, own row) pairs whose window has no key in streamed tile j
    (-1: the last tile)."""
    found = []
    for tile in range(h // TQ * (w // TQ)):
        geo = NaQueries(tile, h, w, ks)
        attends = block_layout(geo)[2]
        found += [(tile, i) for i in np.flatnonzero(
            ~attends[:, j % geo.tiles].any(-1))]
    return found


def test_interior_tiles_have_rows_without_a_key_in_a_tile():
    """At ks = 7 the window of row t of an interior query tile spans halo
    rows t to t + 6: the first streamed tile (halo rows 0-3) holds no key
    of its rows 4-7 (own rows 32-63), the last (halo rows 12-13 of the 14)
    none of its rows 0-5 (own rows 0-47); an 8 x 8 map (one tile, its halo
    cut by the map) has no such row."""
    tiles_w = 32 // TQ
    interior = [t for t in range(16)
                if 0 < t // tiles_w < 3 and 0 < t % tiles_w < 3]
    first = rows_without_key(32, 32, 7, 0)
    last = rows_without_key(32, 32, 7, -1)
    for t in interior:
        assert [i for tt, i in first if tt == t] == list(range(32, 64))
        assert [i for tt, i in last if tt == t] == list(range(48))
    assert not rows_without_key(8, 8, 7, 0)


def streamed_forward(q, k, v, ks, scale, guard=True, rounding="none"):
    """The forward's online softmax (csrc/attn_fwd.cuh, csrc/attn_tf32.cuh)
    over the NaQueries geometry, in numpy float64: per block, per streamed
    tile, logits of the attending pairs (others -inf), the running max m
    and sum l, p = exp(s - m) and the output rescaled by exp(m_old - m).
    With ``guard`` a row whose max is still -inf takes 0 as its reference,
    as the kernels do. ``rounding`` rounds the operands of q k^T and p v
    (``rounded``); l sums p unrounded, as the kernels do. q, k, v (b, h, w,
    heads, e); returns out and lse (b, heads, h, w)."""
    rnd = lambda x: rounded(x, rounding)
    b, h, w, heads, e = q.shape
    flat = [t.reshape(b, h * w, heads, e).astype(np.float64)
            for t in (q, k, v)]
    out = np.zeros((b, h * w, heads, e))
    lse = np.zeros((b, heads, h * w))
    with np.errstate(invalid="ignore"):
        for tile in range(h // TQ * (w // TQ)):
            geo = NaQueries(tile, h, w, ks)
            pos, ok, attends = block_layout(geo)
            qy, qx = geo.own(np.arange(64))
            rows = qy * w + qx
            m = np.full((b, heads, 64), -np.inf)
            l = np.zeros((b, heads, 64))
            acc = np.zeros((b, heads, 64, e))
            for j in range(geo.tiles):
                keys = np.where(ok[0, j], pos[0, j], 0)
                # zero-filled slots past the halo or the map
                kt = flat[1][:, keys] * ok[0, j][None, :, None, None]
                vt = flat[2][:, keys] * ok[0, j][None, :, None, None]
                s = np.einsum("bqne,bkne->bnqk", rnd(flat[0][:, rows]),
                              rnd(kt)) * scale
                s = np.where(attends[:, j][None, None], s, -np.inf)
                mx = np.maximum(m, s.max(-1))
                ref = np.where(mx == -np.inf, 0.0, mx) if guard else mx
                alpha = np.exp(m - ref)
                p = np.exp(s - ref[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + np.einsum("bnqk,bkne->bnqe",
                                                         rnd(p), rnd(vt))
                m = mx
            out[:, rows] = (acc / l[..., None]).transpose(0, 2, 1, 3)
            lse[:, :, rows] = m + np.log(l)
    return out.reshape(b, h, w, heads, e), lse.reshape(b, heads, h, w)


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (32, 32)])
@pytest.mark.parametrize("ks", [1, 3, 5, 7])
def test_streamed_forward_matches_jax(h, w, ks, rounding):
    """The streamed forward against JAX's na2d_reference and masked
    logsumexp: unrounded within F32_TOL; with TF32 operands within
    TF32_TOL, its error against the unrounded float64 mirror at most
    TF32_SHARE of the bf16 mirror's (out and lse); with bf16 operands
    within BF16_TOL (relative L2 for the shares)."""
    rng = np.random.default_rng(ks)
    b, heads, e = 1, 2, 16
    q, k, v = (rng.standard_normal((b, h, w, heads, e)).astype(np.float32)
               for _ in range(3))
    check_streamed_forward(q, k, v, ks, rounding)
    if (h, w) == (32, 32) and ks == 7 and rounding == "none":
        # without the guard, the rows with no key in the first tile are NaN
        bad, _ = streamed_forward(q, k, v, ks, 0.25, guard=False)
        nan_rows = np.isnan(bad).any((0, 3, 4)).reshape(-1)
        rows = {NaQueries(t, h, w, ks).own(i)[0] * w
                + NaQueries(t, h, w, ks).own(i)[1]
                for t, i in rows_without_key(h, w, ks, 0)}
        assert set(np.flatnonzero(nan_rows)) == rows and rows


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("h,w", [(8, 8), (16, 24)])
@pytest.mark.parametrize("ks", [1, 3, 7])
def test_streamed_forward_head_dim_128_matches_jax(h, w, ks, rounding):
    """The streamed forward at head dim 128 (K11-f32 at 128, whose two
    warpgroups each form their rows' logits over all 128 columns and
    accumulate 64 of the output's: the same products, in the same order,
    for every output element) against JAX as above, q and k cosine-sim
    (norm sqrt(10) per head, as the prologue leaves them)."""
    rng = np.random.default_rng(128 + ks)
    b, heads, e = 1, 1, 128
    q, k, v = (rng.standard_normal((b, h, w, heads, e)).astype(np.float32)
               for _ in range(3))
    q, k = ((t / np.linalg.norm(t, axis=-1, keepdims=True) * np.sqrt(10.0))
            .astype(np.float32) for t in (q, k))
    check_streamed_forward(q, k, v, ks, rounding)


def check_streamed_forward(q, k, v, ks, rounding):
    """``streamed_forward`` at scale 0.25 with ``rounding`` against JAX's
    na2d_reference and masked logsumexp, and with TF32 operands its error
    against float64 at most TF32_SHARE of the bf16 mirror's."""
    b, h, w, heads, e = q.shape
    out, lse = streamed_forward(q, k, v, ks, 0.25, rounding=rounding)
    want = j_na.na2d_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), ks, scale=0.25)
    tol = {"none": F32_TOL, "tf32": TF32_TOL, "bf16": BF16_TOL}[rounding]
    np.testing.assert_allclose(out, np.asarray(want), rtol=0,
                               atol=tol * np.abs(want).max())
    logits = jnp.einsum("bqne,bkne->bnqk", q.reshape(b, h * w, heads, e),
                        k.reshape(b, h * w, heads, e)) * 0.25
    want_lse = jax.nn.logsumexp(
        jnp.where(jax_mask(h, w, ks), logits, -jnp.inf), -1)
    np.testing.assert_allclose(lse, np.asarray(want_lse).reshape(lse.shape),
                               rtol=0, atol=tol * np.abs(want_lse).max())
    if rounding == "tf32":
        exact = streamed_forward(q, k, v, ks, 0.25)
        bf16 = streamed_forward(q, k, v, ks, 0.25, rounding="bf16")
        for name, a, c in zip(("out", "lse"), l2_errors((out, lse), exact),
                              l2_errors(bf16, exact)):
            assert a <= TF32_SHARE * c, (name, a, c)


# ---- the backward: NaKeys and the two-kernel streamed backward ------------

class Reach:
    """Mirror of csrc/na2d.cuh's Reach: the query rows (or columns) [lo, hi]
    whose clamped windows reach keys [k0, k0 + 8) on an axis of n."""

    def __init__(self, k0, n, ks):
        r = (ks - 1) // 2
        lo = max(0, k0 - (ks - 1))
        hi = min(n - 1, k0 + TQ - 1 + ks - 1)
        while np.clip(lo - r, 0, n - ks) + ks - 1 < k0:
            lo += 1
        while np.clip(hi - r, 0, n - ks) > k0 + TQ - 1:
            hi -= 1
        self.lo, self.hi = lo, hi


class NaKeys:
    """Mirror of csrc/na2d.cuh's NaKeys: the block of 8 x 8 key tile
    ``tile`` and the slab of queries that reach it, streamed as tiles of 4
    slab rows x 16 query slots. ``reject`` False drops the mask's slab-edge
    rejection (sy < ny and sx < nx)."""

    def __init__(self, tile, h, w, ks, reject=True):
        self.h, self.w, self.ks, self.reject = h, w, ks, reject
        tiles_w = w // TQ
        self.ky0, self.kx0 = tile // tiles_w * TQ, tile % tiles_w * TQ
        rows, cols = Reach(self.ky0, h, ks), Reach(self.kx0, w, ks)
        self.qy0, self.qx0 = rows.lo, cols.lo
        self.ny, self.nx = rows.hi - rows.lo + 1, cols.hi - cols.lo + 1
        self.r = (ks - 1) // 2
        self.tiles = (self.ny + BANDS - 1) // BANDS

    def own(self, i):
        return self.ky0 + i // TQ, self.kx0 + i % TQ

    def stream(self, j, i):
        sy, sx = BANDS * j + i // SLOTS, i % SLOTS
        return self.qy0 + sy, self.qx0 + sx, (sy < self.ny) & (sx < self.nx)

    def own_info(self, i):
        return self.own(i)

    def mask(self, j, col, info):
        ky, kx = info
        sy, sx = BANDS * j + col // SLOTS, col % SLOTS
        wy = np.clip(self.qy0 + sy - self.r, 0, self.h - self.ks)
        wx = np.clip(self.qx0 + sx - self.r, 0, self.w - self.ks)
        inside = (0 <= ky - wy) & (ky - wy < self.ks) & (0 <= kx - wx) & (
            kx - wx < self.ks)
        if not self.reject:
            return inside
        return (sy < self.ny) & (sx < self.nx) & inside


def slab_rows(t, pos, ok, zero_fill):
    """Rows pos of (b, positions, ...) t as a streamed tile: slots that are
    not ok zero-filled (the kernels' copies), or with ``zero_fill`` False
    the data of the position clamped into the map."""
    rows = t[:, pos]
    if zero_fill:
        rows = rows * ok.reshape((1, -1) + (1,) * (t.ndim - 2))
    return rows


def streamed_backward(q, k, v, out, lse, dout, ks, scale, reject=True,
                      zero_fill=True, rounding="none", dtype=np.float32):
    """The backward's two kernels (csrc/attn_bwd.cuh, csrc/attn_tf32.cuh
    over csrc/na2d.cuh's geometries) in numpy ``dtype`` (float32, as the
    kernels accumulate), each product's operands rounded by ``rounding``
    (``rounded``); with bf16 operands out and dout are bf16 for delta too,
    as the bf16 kernels read them. dq kernel, per query tile (NaQueries):
    per streamed key tile, s = q k^T scale, p = exp(s - lse) where the pair
    attends, ds = p (dout v^T - delta), dq += ds k; dq scaled once. Its
    first step forms delta = rowsum(out * dout). dk/dv kernel, per key tile
    (NaKeys): per streamed query tile, with the queries' lse and delta,
    p^T and ds^T as above, dv += p^T dout, dk += ds^T q; dk scaled once.
    q, k, v, out, dout (b, h, w, heads, e); lse (b, heads, h, w). Returns
    dq, dk, dv (b, h, w, heads, e)."""
    b, h, w, heads, e = q.shape
    hw = h * w
    rnd = lambda x: rounded(x, rounding)
    qf, kf, vf, of, gf = (np.asarray(t, dtype).reshape(b, hw, heads, e)
                          for t in (q, k, v, out, dout))
    # statistics as (b, positions, heads)
    lse_p = np.asarray(lse, dtype).reshape(b, heads, hw).transpose(0, 2, 1)
    if rounding == "bf16":
        of, gf = rnd(of), rnd(gf)
    delta = np.einsum("bpne,bpne->bpn", of, gf)
    scale = dtype(scale)
    dq, dk, dv = (np.zeros((b, hw, heads, e), dtype) for _ in range(3))
    n_tiles = h // TQ * (w // TQ)
    for tile in range(n_tiles):
        geo = NaQueries(tile, h, w, ks)
        pos, ok, attends = block_layout(geo)
        qy, qx = geo.own(np.arange(64))
        rows = qy * w + qx
        acc = np.zeros((b, heads, 64, e), dtype)
        for j in range(geo.tiles):
            keys = np.where(ok[0, j], pos[0, j], 0)
            kt = slab_rows(kf, keys, ok[0, j], True)
            vt = slab_rows(vf, keys, ok[0, j], True)
            s = np.einsum("bqne,bkne->bnqk", rnd(qf[:, rows]), rnd(kt)) * scale
            lse_r = lse_p[:, rows].transpose(0, 2, 1)[..., None]
            p = np.where(attends[:, j][None, None], np.exp(s - lse_r),
                         dtype(0))
            dp = np.einsum("bqne,bkne->bnqk", rnd(gf[:, rows]), rnd(vt))
            ds = p * (dp - delta[:, rows].transpose(0, 2, 1)[..., None])
            acc += np.einsum("bnqk,bkne->bnqe", rnd(ds), rnd(kt))
        dq[:, rows] = (acc * scale).transpose(0, 2, 1, 3)
    i = np.arange(64)
    for tile in range(n_tiles):
        geo = NaKeys(tile, h, w, ks, reject)
        ky, kx = geo.own(i)
        own = ky * w + kx
        acc_k, acc_v = (np.zeros((b, heads, 64, e), dtype)
                        for _ in range(2))
        for j in range(geo.tiles):
            y, x, ok = geo.stream(j, i)
            slot = np.clip(y, 0, h - 1) * w + np.clip(x, 0, w - 1)
            qt = slab_rows(qf, slot, ok, zero_fill)
            gt = slab_rows(gf, slot, ok, zero_fill)
            lt = slab_rows(lse_p, slot, ok, zero_fill).transpose(0, 2, 1)
            dt = slab_rows(delta, slot, ok, zero_fill).transpose(0, 2, 1)
            attends = geo.mask(j, i[None, :], geo.own_info(i[:, None]))
            st = np.einsum("bkne,bqne->bnkq", rnd(kf[:, own]), rnd(qt)) * scale
            pt = np.where(attends[None, None], np.exp(st - lt[:, :, None]),
                          dtype(0))
            dpt = np.einsum("bkne,bqne->bnkq", rnd(vf[:, own]),
                            rnd(gt)) - dt[:, :, None]
            acc_v += np.einsum("bnkq,bqne->bnke", rnd(pt), rnd(gt))
            acc_k += np.einsum("bnkq,bqne->bnke", rnd(pt * dpt), rnd(qt))
        dk[:, own] = (acc_k * scale).transpose(0, 2, 1, 3)
        dv[:, own] = acc_v.transpose(0, 2, 1, 3)
    shape = (b, h, w, heads, e)
    return dq.reshape(shape), dk.reshape(shape), dv.reshape(shape)


@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (64, 64)])
@pytest.mark.parametrize("ks", range(1, 8))
def test_every_slab_query_streams_once(h, w, ks):
    """NaKeys: for every key of every key tile, each query whose clamped
    window holds the key lands in exactly one (tile, slot) of the block's
    slab, and no slot past the slab or the map attends."""
    want = jax_mask(h, w, ks)
    i = np.arange(64)
    for tile in range(h // TQ * (w // TQ)):
        geo = NaKeys(tile, h, w, ks)
        assert geo.ny <= TQ + ks - 1 and geo.nx <= TQ + ks - 1 < SLOTS
        ky, kx = geo.own(i)
        counts = np.zeros((64, h * w), int)
        for j in range(geo.tiles):
            y, x, ok = geo.stream(j, i)
            attends = geo.mask(j, i[None, :], geo.own_info(i[:, None]))
            assert not (attends & ~ok[None]).any()
            for key in range(64):
                np.add.at(counts[key], (y * w + x)[attends[key]], 1)
        np.testing.assert_array_equal(counts,
                                      want[:, ky * w + kx].T.astype(int))


def backward_case(h, w, ks, e, seed):
    """q, k, v (v a strided third of one (b, h, w, 3, heads, e) projection,
    as the unfused prologue leaves it) and dout, float32."""
    rng = np.random.default_rng(seed)
    b, heads = 1, 2 if h * w < 64 * 64 else 1
    proj = rng.standard_normal((b, h, w, 3, heads, e)).astype(np.float32)
    q, k, v = proj[:, :, :, 0], proj[:, :, :, 1], proj[:, :, :, 2]
    assert not v.flags.c_contiguous
    dout = rng.standard_normal((b, h, w, heads, e)).astype(np.float32)
    return q, k, v, dout


def jax_backward(q, k, v, dout, ks, scale):
    """jax.vjp of the JAX package's na2d_reference."""
    _, vjp = jax.vjp(lambda *t: j_na.na2d_reference(*t, ks, scale=scale),
                     *map(jnp.asarray, (q, k, v)))
    return vjp(jnp.asarray(dout))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("e", [32, 64, 128])
@pytest.mark.parametrize("h,w", [(8, 8), (16, 24), (64, 64)])
@pytest.mark.parametrize("ks", range(1, 8))
def test_streamed_backward_matches_jax_vjp(h, w, ks, e, rounding):
    """The streamed backward against jax.vjp of na2d_reference: unrounded
    within F32_TOL; with TF32 operands within TF32_TOL, its error against
    the unrounded mirror in float64 (relative L2) at most TF32_SHARE of
    the bf16 mirror's, dq, dk and dv each; with bf16 operands within
    BF16_TOL. At ks = 1 dq and dk are exactly 0 (a window of one key) and a
    rounded mirror's hold the rounding of dP - delta: they are held to the
    tolerance on dv's scale, and only dv to the share (the bf16 mirror's
    dP and delta read the same bf16 dout and v = out, and cancel
    exactly)."""
    q, k, v, dout = backward_case(h, w, ks, e, 10 * ks + e)
    out, lse = streamed_forward(q, k, v, ks, 0.25)
    got = streamed_backward(q, k, v, out, lse, dout, ks, 0.25,
                            rounding=rounding)
    want = [np.asarray(t) for t in jax_backward(q, k, v, dout, ks, 0.25)]
    tol = {"none": F32_TOL, "tf32": TF32_TOL, "bf16": BF16_TOL}[rounding]
    for name, err in zip(("dq", "dk", "dv"),
                         rel_errors(got, want, scale=want[2])):
        assert err <= tol, (name, err)
    if rounding == "tf32":
        exact = streamed_backward(q, k, v, out, lse, dout, ks, 0.25,
                                  dtype=np.float64)
        bf16 = streamed_backward(q, k, v, out, lse, dout, ks, 0.25,
                                 rounding="bf16")
        n = 3 if ks > 1 else 1  # dq, dk, dv; or dv alone
        for name, a, c in zip(("dq", "dk", "dv")[-n:],
                              l2_errors(got[-n:], exact[-n:]),
                              l2_errors(bf16[-n:], exact[-n:])):
            assert a <= TF32_SHARE * c, (name, a, c)


def test_slab_edge_rejection_guards_dk_dv():
    """Without its slab-edge rejection, NaKeys' mask lets slots past the
    map attend at the edge tiles: their clamped windows hold the tile's
    keys, and their logit and lse are those of the slot's data. With the
    copies' zero fill those slots hold q = dout = 0, so p = 1 there adds
    nothing to dk and dv; where a slot carries data (the clamped position's,
    as a copy that clamps its addresses instead of zero-filling would), the
    rejection is what keeps dk and dv right."""
    h, w, ks, e = 16, 24, 7, 32
    q, k, v, dout = backward_case(h, w, ks, e, 5)
    out, lse = streamed_forward(q, k, v, ks, 0.25)
    want = [np.asarray(t) for t in jax_backward(q, k, v, dout, ks, 0.25)]
    i = np.arange(64)
    spurious = 0
    for tile in range(h // TQ * (w // TQ)):
        kept, dropped = NaKeys(tile, h, w, ks), NaKeys(tile, h, w, ks, False)
        for j in range(kept.tiles):
            info = kept.own_info(i[:, None])
            spurious += (dropped.mask(j, i[None, :], info)
                         & ~kept.mask(j, i[None, :], info)).sum()
    assert spurious > 0

    def error(reject, zero_fill):
        got = streamed_backward(q, k, v, out, lse, dout, ks, 0.25, reject,
                                zero_fill)
        return [np.abs(a - b_).max() / np.abs(b_).max()
                for a, b_ in zip(got, want)]

    for reject, zero_fill in ((True, True), (False, True), (True, False)):
        assert max(error(reject, zero_fill)) <= F32_TOL
    err_dq, err_dk, err_dv = error(False, False)
    assert err_dq <= F32_TOL and err_dk > 1e-2 and err_dv > 1e-2


# ---- K15: the cluster schedule of csrc/na_proj.cuh ------------------------

def proj_schedule(q, k, v, skip, w_out, e, ks, scale):
    """Mirror of K15's cluster in numpy float64. Rank r of a query tile's
    cluster runs the streamed forward over NaQueries for the head (e = 64)
    or heads (e = 32) of channels [64 r, 64 r + 64): its A tile. Its output
    columns [64 r, 64 r + 64) of the tile's rows are the sum over steps s
    of A_r' w_out[64 r' : 64 r' + 64, 64 r : 64 r + 64), r' = (r + s) mod
    R, in that order, plus skip. q, k, v, skip (b, h, w, c); w_out (c,
    c)."""
    b, h, w, c = q.shape
    ranks = c // 64
    att = [streamed_forward(*(t[..., 64 * r:64 * r + 64].reshape(
        b, h, w, 64 // e, e) for t in (q, k, v)), ks, scale)[0].reshape(
            b, h * w, 64) for r in range(ranks)]
    res = skip.reshape(b, h * w, c).astype(np.float64)
    out = np.zeros((b, h * w, c))
    for tile in range(h // TQ * (w // TQ)):
        qy, qx = NaQueries(tile, h, w, ks).own(np.arange(64))
        rows = qy * w + qx
        for r in range(ranks):
            cols = slice(64 * r, 64 * r + 64)
            order = [(r + step) % ranks for step in range(ranks)]
            assert sorted(order) == list(range(ranks))
            acc = np.zeros((b, 64, 64))
            for rp in order:
                acc += att[rp][:, rows] @ w_out[64 * rp:64 * rp + 64, cols]
            out[:, rows, cols] = acc + res[:, rows, cols]
    return out.reshape(b, h, w, c)


@pytest.mark.parametrize("c,e", [(128, 64), (128, 32), (256, 64), (384, 64),
                                 (512, 64)])
@pytest.mark.parametrize("ks", [3, 7])
@pytest.mark.parametrize("h,w", [(8, 8), (16, 24)])
def test_proj_schedule_matches_jax(h, w, ks, c, e):
    rng = np.random.default_rng(c + e + ks)
    q, k, v, skip = (rng.standard_normal((1, h, w, c)).astype(np.float32)
                     for _ in range(4))
    w_out = (rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32)
    got = proj_schedule(q, k, v, skip, w_out, e, ks, 0.25)
    want = np.asarray(j_na.na2d_packed_proj(
        *map(jnp.asarray, (q, k, v, skip, w_out)), c // e, ks, scale=0.25))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_TOL * np.abs(want).max())
