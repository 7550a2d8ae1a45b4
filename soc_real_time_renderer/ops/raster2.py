"""Rasterizer v2: sort-binned pair streams + a Pallas resolve.

Replaces the reference's hardware raster passes (depth prepass
``depth_prepass.inl``, shadow ``sun_shadow_draw.inl``, G-buffer
``g_buffer_generation.inl`` — the latter's fragment work lives in
ops/gbuffer.py) with a static-shape software raster:

1. **Setup** (XLA, triangle_setup_planar): homogeneous adjugate
   coverage — no clipping, static shapes.
2. **Binning** (XLA): each triangle emits (bin, tri) pairs for the
   screen bins its bbox covers — 4 inline slots for the common case and
   a compacted "medium" expansion for larger triangles — then ONE
   `lax.sort` by bin id groups pairs into per-bin contiguous ranges
   (`searchsorted` boundaries).  No atomics, no per-bin caps.
3. **Record gather** (XLA): one gather packs each sorted pair's full
   resolve record into a (16, PAIR_CAP) stream:
   rows = [adjugate 3x3 | z0..z2 | w0..w2 | tri_id].
4. **Resolve** (Pallas, Triton route): one program per strip of pixel
   rows of one bin; it reads its bin's record range from the starts
   table and evaluates (pixels × triangles) coverage/depth in K-record
   chunks, carrying per-pixel (min z, winner id), so work is
   proportional to actual pairs.  `resolve_xla` is the plain-jnp
   version of the same step.

Very large triangles (bbox covering more than ``med_slots`` bins) are
truncated to their first ``med_slots`` bins — scenes should pre-split
giant world-space triangles (models/scene_batch.py does; glTF content
rarely needs it).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

W_EPS = 1e-6

# Pair-stream z ordering: the sort key is bin_id * ZQ + quantized
# conservative min NDC z of the triangle, so each bin's records arrive
# NEAR-TO-FAR and the resolve kernel can stop as soon as the next
# chunk's min z is provably behind every pixel's current winner — the
# in-pass, single-frame form of the HiZ coarse reject (VERDICT r2 item
# 3; the reference builds HiZ pyramids and never uses them,
# generate_hiz.glsl:17-99 — a current-frame HiZ reject would be
# circular here since HiZ is derived from this very pass's output).
ZQ = 16384


def _cdiv(a, b):
    return -(-a // b)


@dataclass(frozen=True)
class VisibilityBuffer:
    """Per-pixel raster output (visibility-buffer style): attribute
    interpolation is deferred to ops/gbuffer.py, keeping the raster
    inner loop at 5 linear functionals per triangle."""
    depth: jax.Array    # (H, W) float32 in [0, 1]; 1.0 where no hit
    tri_id: jax.Array | None   # (H, W) int32 triangle index; -1 where
    #                       no hit; None for depth-only views (shadow)
    overflow: jax.Array  # () int32 bitmask: OVERFLOW_* bits set when any
    #                       static cap truncated fragments this frame.
    #                       The reference (hardware raster) never drops
    #                       fragments; this flag makes our cap-based
    #                       binning loud instead of silently holey.


# overflow bitmask bits (VisibilityBuffer.overflow)
OVERFLOW_PAIRS = 1       # sorted pair stream exceeded BinGrid.pair_cap
OVERFLOW_MED_CAP = 2     # more medium triangles than BinGrid.med_cap
OVERFLOW_MED_SLOTS = 4   # a medium triangle covered > med_slots bins


jax.tree_util.register_dataclass(
    VisibilityBuffer, data_fields=["depth", "tri_id", "overflow"],
    meta_fields=[])


@dataclass(frozen=True)
class PlanarSetup:
    """Planar per-triangle raster data — everything (rows, T), so the
    per-triangle math is elementwise over the last axis."""
    adj: jax.Array     # (9, T) adjugate rows * facing sign
    zs: jax.Array      # (3, T) per-vertex clip z
    ws: jax.Array      # (3, T) per-vertex clip w
    bbox: jax.Array    # (4, T): x0, y0, x1, y1 (px, x1/y1 exclusive)
    valid: jax.Array   # (T,)


jax.tree_util.register_dataclass(
    PlanarSetup, data_fields=["adj", "zs", "ws", "bbox", "valid"],
    meta_fields=[])


def triangle_setup_planar(clip, width, height, cull: str = "front"
                          ) -> PlanarSetup:
    """clip: (3 verts, 4 comps, T) planar clip positions.

    Same math as ops/raster.triangle_setup (homogeneous adjugate
    coverage; docstring there) in the lane-friendly layout.
    """
    w = clip[:, 3]                                     # (3, T)
    X = (clip[:, 0] * 0.5 + 0.5 * w) * width
    Y = (clip[:, 1] * 0.5 + 0.5 * w) * height
    z = clip[:, 2]
    a, b, c = X[0], X[1], X[2]
    d, e, f = Y[0], Y[1], Y[2]
    g, h, i = w[0], w[1], w[2]
    r0 = (e * i - f * h, c * h - b * i, b * f - c * e)
    r1 = (f * g - d * i, a * i - c * g, c * d - a * f)
    r2 = (d * h - e * g, b * g - a * h, a * e - b * d)
    det = a * r0[0] + b * r1[0] + c * r2[0]

    if cull == "front":
        keep = det < 0
        s = jnp.where(keep, -1.0, 0.0)
    elif cull == "back":
        keep = det > 0
        s = jnp.where(keep, 1.0, 0.0)
    else:
        keep = det != 0
        s = jnp.sign(det)
    adj = jnp.stack(r0 + r1 + r2) * s[None, :]         # (9, T)

    # Exact screen bbox even across the near plane: candidates are the
    # projected vertices with w > eps plus the projections of edge
    # intersections with the w = eps plane (a full-screen fallback here
    # explodes pair counts — one camera-plane-crossing floor can emit
    # hundreds of bins per triangle).
    big = jnp.float32(1e9)
    cand_x, cand_y, cand_ok = [], [], []
    for i in range(3):
        ok = w[i] > W_EPS
        wi = jnp.where(ok, w[i], 1.0)
        cand_x.append(X[i] / wi)
        cand_y.append(Y[i] / wi)
        cand_ok.append(ok)
    for i, j in ((0, 1), (1, 2), (2, 0)):
        crosses = (w[i] > W_EPS) != (w[j] > W_EPS)
        dw = jnp.where(jnp.abs(w[j] - w[i]) > 1e-12, w[j] - w[i], 1.0)
        t = (W_EPS - w[i]) / dw
        xc = X[i] + t * (X[j] - X[i])
        yc = Y[i] + t * (Y[j] - Y[i])
        cand_x.append(xc / W_EPS)
        cand_y.append(yc / W_EPS)
        cand_ok.append(crosses)
    cx = jnp.stack(cand_x)                              # (6, T)
    cy = jnp.stack(cand_y)
    ok6 = jnp.stack(cand_ok)
    x0 = jnp.min(jnp.where(ok6, cx, big), axis=0)
    x1 = jnp.max(jnp.where(ok6, cx, -big), axis=0)
    y0 = jnp.min(jnp.where(ok6, cy, big), axis=0)
    y1 = jnp.max(jnp.where(ok6, cy, -big), axis=0)
    any_ok = jnp.any(ok6, axis=0)
    x0 = jnp.clip(jnp.floor(jnp.where(any_ok, x0, 0.0)), 0, width)
    y0 = jnp.clip(jnp.floor(jnp.where(any_ok, y0, 0.0)), 0, height)
    x1 = jnp.clip(jnp.ceil(jnp.where(any_ok, x1, 0.0)) + 1.0, 0, width)
    y1 = jnp.clip(jnp.ceil(jnp.where(any_ok, y1, 0.0)) + 1.0, 0, height)
    bbox = jnp.stack([x0, y0, x1, y1])
    w_ok = jnp.all(w > W_EPS, axis=0)
    wsafe = jnp.where(jnp.abs(w) > W_EPS, w, W_EPS)

    zndc = z / wsafe
    z_ok = jnp.where(w_ok,
                     ~(jnp.all(zndc < 0.0, 0) | jnp.all(zndc > 1.0, 0)),
                     True)
    valid = keep & (x1 > x0) & (y1 > y0) & z_ok & (det != 0)
    return PlanarSetup(adj=adj, zs=z, ws=w, bbox=bbox, valid=valid)


@dataclass(frozen=True)
class BinGrid:
    """Static binning configuration for one render-target size.

    Bins may be rectangular (bin_w x bin_h); both must be powers of two
    (the resolve kernel's pixel strips are Triton blocks).  The resolve
    pays pixels_per_bin evaluations PER PAIR, so smaller bins cut
    resolve work at the price of more (bin, tri) pairs per triangle
    (n_small bounds the inline small path)."""
    width: int
    height: int
    bin_size: int = 64          # square default; bin_w/bin_h override
    chunk: int = 32             # records per resolve chunk (power of two)
    pair_cap: int = 262144      # gathered record columns (sorted prefix)
    med_cap: int = 8192         # max "medium" triangles (bbox > n_small bins)
    med_slots: int = 64         # bins covered per medium triangle
    bin_w: int | None = None    # bin width in px (default bin_size)
    bin_h: int | None = None    # bin height in px (default bin_size)
    n_small: int = 4            # inline small-path slots per triangle

    def __post_init__(self):
        assert self.pair_cap >= self.chunk
        assert self.pair_cap % self.chunk == 0

    @property
    def bw(self):
        return self.bin_w or self.bin_size

    @property
    def bh(self):
        return self.bin_h or self.bin_size

    @property
    def bx(self):
        return _cdiv(self.width, self.bw)

    @property
    def by(self):
        return _cdiv(self.height, self.bh)

    @property
    def num_bins(self):
        return self.bx * self.by

    @property
    def pixels_per_bin(self):
        return self.bw * self.bh


def default_grid(width, height, scale="scene", kind="main"):
    """Presets: 'scene' for main/shadow views of full scenes, 'small'
    for tests/tiny models.

    Chosen on an H100 (tools/resolve_sweep.py; PERF.md has the table):
    the main view keeps 64x32 bins, the smallest shape whose medium-
    triangle slots hold the atrium's close walls (32x16 resolved the
    terrain ~25% faster but overflowed med_slots there); the shadow
    view uses 64x64 bins with 16-record chunks (half the 128-px bins'
    resolve time on a 4096² soup)."""
    if scale == "small":
        return BinGrid(width=width, height=height, pair_cap=16384,
                       med_cap=512)
    if kind == "shadow":
        return BinGrid(width=width, height=height, bin_size=64, chunk=16)
    return BinGrid(width=width, height=height, bin_w=64, bin_h=32)


# ---------------------------------------------------------------------------
# Binning (XLA)
# ---------------------------------------------------------------------------


def build_records(setup: PlanarSetup) -> jax.Array:
    """Resolve records (16, T+1) f32 [adj 9 | z 3 | w 3 | id], ids stored
    as exact float values (< 2^24); column T is an always-miss
    sentinel."""
    T = setup.adj.shape[1]
    vals = jnp.concatenate([setup.adj, setup.zs, setup.ws], axis=0)
    ids = jnp.arange(T, dtype=jnp.float32)[None, :]
    rec = jnp.concatenate([vals, ids], axis=0)
    return jnp.pad(rec, ((0, 0), (0, 1)))


def build_pairs(setup: PlanarSetup, grid: BinGrid):
    """Returns (starts (B+1,) i32 clamped to pair_cap, sorted_tids
    (S,) i32, overflow () i32 bitmask) where S = 4T + med_cap*med_slots.

    overflow reports every silent-truncation hazard of the static caps
    (OVERFLOW_PAIRS / OVERFLOW_MED_CAP / OVERFLOW_MED_SLOTS)."""
    T = setup.adj.shape[1]
    bw, bh = grid.bw, grid.bh
    BX, BY, B = grid.bx, grid.by, grid.num_bins

    x0, y0, x1, y1 = (setup.bbox[i] for i in range(4))
    bx0 = jnp.clip((x0 // bw).astype(jnp.int32), 0, BX - 1)
    by0 = jnp.clip((y0 // bh).astype(jnp.int32), 0, BY - 1)
    bx1 = jnp.clip(((x1 - 1.0) // bw).astype(jnp.int32), 0, BX - 1)
    by1 = jnp.clip(((y1 - 1.0) // bh).astype(jnp.int32), 0, BY - 1)
    w = bx1 - bx0 + 1
    h = by1 - by0 + 1
    nb = w * h
    valid = setup.valid

    def slot_keys(bx0g, by0g, wg, hg, n_slots):
        """emits (n_slots, N) bin keys (B = invalid)."""
        s = jnp.arange(n_slots, dtype=jnp.int32)[:, None]
        dx = s % wg[None, :]
        dy = s // wg[None, :]
        ok = dy < hg[None, :]
        key = (by0g[None, :] + dy) * BX + bx0g[None, :] + dx
        return jnp.where(ok, key, B)

    assert B <= (2 ** 31 - 1) // ZQ, "bin count overflows the z-sort key"
    # conservative per-triangle min NDC z (0 when any w is clipped —
    # such triangles never allow an early stop)
    wsafe = jnp.where(jnp.abs(setup.ws) > W_EPS, setup.ws, W_EPS)
    zndc = setup.zs / wsafe
    w_ok = jnp.all(setup.ws > W_EPS, axis=0)
    zmin = jnp.where(w_ok, jnp.clip(jnp.min(zndc, axis=0), 0.0, 1.0), 0.0)
    zq = (zmin * (ZQ - 1)).astype(jnp.int32)

    ns = grid.n_small
    tri_ids = jnp.arange(T, dtype=jnp.int32)
    small = valid & (nb <= ns)
    k_small = jnp.where(small[None, :],
                        slot_keys(bx0, by0, w, h, ns) * ZQ + zq[None, :],
                        B * ZQ)

    med = valid & (nb > ns)
    med_ids = jnp.nonzero(med, size=grid.med_cap, fill_value=T)[0]
    mi = jnp.minimum(med_ids, T - 1)
    m_ok = (med_ids < T)[None, :]
    k_med = slot_keys(bx0[mi], by0[mi], w[mi], h[mi], grid.med_slots)
    k_med = jnp.where(m_ok, k_med * ZQ + zq[mi][None, :], B * ZQ)

    keys = jnp.concatenate([k_small.reshape(-1), k_med.reshape(-1)])
    tids = jnp.concatenate([
        jnp.broadcast_to(tri_ids[None, :], (ns, T)).reshape(-1),
        jnp.broadcast_to(med_ids[None, :],
                         (grid.med_slots, grid.med_cap)).reshape(-1)])
    sk, st = jax.lax.sort((keys, tids), num_keys=1)
    starts = jnp.searchsorted(
        sk, jnp.arange(B + 1, dtype=jnp.int32) * ZQ)
    total_pairs = starts[B]
    starts = jnp.minimum(starts, grid.pair_cap).astype(jnp.int32)

    med_count = jnp.sum(med.astype(jnp.int32))
    overflow = (
        jnp.where(total_pairs > grid.pair_cap, OVERFLOW_PAIRS, 0)
        | jnp.where(med_count > grid.med_cap, OVERFLOW_MED_CAP, 0)
        | jnp.where(jnp.any(med & (nb > grid.med_slots)),
                    OVERFLOW_MED_SLOTS, 0)).astype(jnp.int32)
    return starts, st, overflow


# ---------------------------------------------------------------------------
# Resolve: Pallas kernel (Triton route) and the plain-jnp reference
# ---------------------------------------------------------------------------

# Launch shape per kernel, keyed by depth_only: (pixels per program,
# warps).  A program resolves a strip of pixels // bin_w full pixel rows
# of one bin; the per-pixel (z, id) carry and the (pixels, chunk)
# evaluation tile stay in registers.  Chosen on an H100
# (tools/resolve_sweep.py --defaults; PERF.md): the full kernel is
# fastest at 64 px x 8 warps on the terrain and atrium views, the
# depth-only kernel at 128 px x 4 warps on the 4096² soup.
LAUNCH = {False: (64, 8), True: (128, 4)}
_NO_ID = 2 ** 30          # id sentinel of the min-id tie reduction


def _chunk_zmin(a, ok):
    """Conservative min NDC z over the chunk's valid records (0 where a
    vertex w is clipped — such records never allow an early stop)."""
    wmin = jnp.minimum(jnp.minimum(a[12], a[13]), a[14])
    zv = [a[9 + i] / jnp.where(a[12 + i] > 0, a[12 + i], 1.0)
          for i in range(3)]
    zmin = jnp.minimum(jnp.minimum(zv[0], zv[1]), zv[2])
    rec_zmin = jnp.where(wmin > W_EPS,
                         jnp.minimum(jnp.maximum(zmin, 0.0), 1.0), 0.0)
    return jnp.min(jnp.where(ok, rec_zmin, jnp.inf))


def _resolve_kernel(grid: BinGrid, rows: int, depth_only: bool,
                    starts_ref, row0_ref, recs_ref, depth_ref, *id_ref):
    """One program = `rows` pixel rows of one bin.

    The program loads its own bin range starts[b], starts[b+1] (b is
    offset by row0, the global bin row of this call's first bin row:
    0 on one device, band_index * rows_per_band under
    resolve_row_sharded) and walks the bin's records in K-column chunks
    from the true start, masking columns past the end.  Per pixel it
    keeps (min z, winner id); exact z ties go to the smallest id, so
    the result does not depend on chunk boundaries.  Records arrive
    near-to-far (build_pairs ZQ key), so once the next chunk's
    conservative min z is behind every pixel's current winner by more
    than one z quantum, nothing later can win and the loop stops."""
    bw, bh, K, BX = grid.bw, grid.bh, grid.chunk, grid.bx
    P = rows * bw
    gy = pl.program_id(0) + row0_ref[0]
    gx = pl.program_id(1)
    sub = pl.program_id(2)
    b = gy * BX + gx
    start = starts_ref[b]
    end = starts_ref[b + 1]
    pix = jax.lax.iota(jnp.int32, P)
    px = (pix % bw + gx * bw).astype(jnp.float32)[:, None] + 0.5
    py = (pix // bw + sub * rows + gy * bh).astype(jnp.float32)[:, None] + 0.5
    lane = jax.lax.iota(jnp.int32, K)
    nch = (end - start + K - 1) // K         # 0 for an empty bin
    n_rows = 15 if depth_only else 16

    def body(carry):
        ci, zb, ib, _ = carry
        col = start + ci * K
        ok = col + lane < end
        a = [recs_ref[r, pl.ds(col, K)] for r in range(n_rows)]
        v = [x[None, :] for x in a]
        e0 = v[0] * px + v[1] * py + v[2]
        e1 = v[3] * px + v[4] * py + v[5]
        e2 = v[6] * px + v[7] * py + v[8]
        ez = e0 * v[9] + e1 * v[10] + e2 * v[11]
        ew = e0 * v[12] + e1 * v[13] + e2 * v[14]
        z = ez / jnp.where(ew != 0, ew, 1.0)
        cov = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (ew > 0)
               & (z >= 0.0) & (z <= 1.0) & ok[None, :])
        z = jnp.where(cov, z, jnp.inf)
        zc = jnp.min(z, axis=1)
        if depth_only:
            zb = jnp.minimum(zb, zc)
        else:
            ids = a[15].astype(jnp.int32)[None, :]
            idc = jnp.min(jnp.where(z == zc[:, None], ids, _NO_ID), axis=1)
            better = (zc < zb) | ((zc == zb) & (idc < ib))
            zb = jnp.where(better, zc, zb)
            ib = jnp.where(better, idc, ib)
        zworst = jnp.max(jnp.where(zb < jnp.inf, zb, 1.0))
        stop = _chunk_zmin(a, ok) - 1.0 / (ZQ - 1) > zworst
        return ci + 1, zb, ib, stop

    def cond(carry):
        return (carry[0] < nch) & jnp.logical_not(carry[3])

    z0 = jnp.full((P,), jnp.inf, jnp.float32)
    # depth-only views carry a 1-element placeholder instead of ids
    i0 = jnp.full((1,) if depth_only else (P,), -1, jnp.int32)
    _, zb, ib, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), z0, i0, jnp.bool_(False)))
    depth_ref[...] = jnp.where(zb < jnp.inf, zb, 1.0).reshape(rows, bw)
    if not depth_only:
        id_ref[0][...] = ib.reshape(rows, bw)


def _block_rows(grid: BinGrid, block_px: int) -> int:
    rows = max(1, min(grid.bh, block_px // grid.bw))
    assert grid.bh % rows == 0, (grid.bw, grid.bh, block_px)
    return rows


def _pad_records(recs, grid: BinGrid):
    """Every chunk load reads K columns from its start; starts are
    clamped to pair_cap, so pair_cap + K columns keep each load in
    bounds (rasterize already gathers that many)."""
    need = grid.pair_cap + grid.chunk
    if recs.shape[1] < need:
        recs = jnp.pad(recs, ((0, 0), (0, need - recs.shape[1])))
    return recs


def _pallas_resolve(starts, recs, grid: BinGrid, interpret: bool, row0,
                    depth_only: bool, block_px: int, num_warps: int):
    from jax.experimental.pallas import triton as plgpu
    bw, bh = grid.bw, grid.bh
    rows = _block_rows(grid, block_px)
    nsub = bh // rows
    shape = (grid.by * bh, grid.bx * bw)
    out_shape = [jax.ShapeDtypeStruct(shape, jnp.float32)]
    if not depth_only:
        out_shape.append(jax.ShapeDtypeStruct(shape, jnp.int32))
    block = pl.BlockSpec((rows, bw), lambda y, x, s: (y * nsub + s, x))
    outs = pl.pallas_call(
        functools.partial(_resolve_kernel, grid, rows, depth_only),
        out_shape=tuple(out_shape),
        grid=(grid.by, grid.bx, nsub),
        in_specs=[pl.no_block_spec] * 3,
        out_specs=tuple([block] * len(out_shape)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="raster_resolve_depth" if depth_only else "raster_resolve",
    )(starts, row0, _pad_records(recs, grid))
    return outs[0], (None if depth_only else outs[1])


def resolve(starts, recs, grid: BinGrid, interpret: bool | None = None,
            row0=None, depth_only: bool = False):
    """Bin resolve -> (depth (H', W'), tri_id (H', W') or None), padded
    to the bin grid (the caller crops to the viewport).

    Pallas kernel, Triton route: compiled on the GPU, interpreted on the
    CPU (ops/backend.py).  `row0` (optional (1,) i32): global bin row of
    this call's first bin row — resolve_row_sharded passes a band's
    offset while `grid` describes the band and `starts` stays global.

    depth_only: no winner-id tracking (shadow views; the sun shadow
    pass writes D32 only, sun_shadow_draw.inl:116-133) — returns
    (depth, None)."""
    from .backend import interpret_mode
    if row0 is None:
        row0 = jnp.zeros((1,), jnp.int32)
    return _pallas_resolve(starts, recs, grid, interpret_mode(interpret),
                           row0, depth_only, *LAUNCH[depth_only])


def resolve_xla(starts, recs, grid: BinGrid, row0=None,
                depth_only: bool = False, chunk: int = 8):
    """Plain-jnp resolve over the same sorted pair stream: every bin at
    once (batched over bins), a fori_loop over `chunk`-record steps up
    to the largest bin's count, no early stop.  Same outputs and tie
    rule as `resolve`; the reference it is checked against and the
    plain version it is timed against."""
    bw, bh, BY, BX = grid.bw, grid.bh, grid.by, grid.bx
    r0 = 0 if row0 is None else row0[0]
    cap = recs.shape[1]
    gy = jnp.arange(BY, dtype=jnp.int32)[:, None] + r0
    gx = jnp.arange(BX, dtype=jnp.int32)[None, :]
    b = (gy * BX + gx).reshape(-1)                      # (NB,)
    start, end = starts[b], starts[b + 1]
    nmax = jnp.max((end - start + chunk - 1) // chunk)
    pix = jnp.arange(bw * bh, dtype=jnp.int32)
    px = ((jnp.broadcast_to(gx, (BY, BX)).reshape(-1) * bw)[:, None]
          + pix % bw).astype(jnp.float32)[..., None] + 0.5   # (NB, P, 1)
    py = ((jnp.broadcast_to(gy, (BY, BX)).reshape(-1) * bh)[:, None]
          + pix // bw).astype(jnp.float32)[..., None] + 0.5
    lane = jnp.arange(chunk, dtype=jnp.int32)

    def body(ci, carry):
        zb, ib = carry
        cols = start[:, None] + ci * chunk + lane            # (NB, K)
        ok = (cols < end[:, None])[:, None, :]
        r = recs[:, jnp.minimum(cols, cap - 1)][:, :, None, :]  # (16,NB,1,K)
        e0 = r[0] * px + r[1] * py + r[2]
        e1 = r[3] * px + r[4] * py + r[5]
        e2 = r[6] * px + r[7] * py + r[8]
        ez = e0 * r[9] + e1 * r[10] + e2 * r[11]
        ew = e0 * r[12] + e1 * r[13] + e2 * r[14]
        z = ez / jnp.where(ew != 0, ew, 1.0)
        cov = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (ew > 0)
               & (z >= 0.0) & (z <= 1.0) & ok)
        z = jnp.where(cov, z, jnp.inf)
        zc = jnp.min(z, axis=-1)                             # (NB, P)
        if depth_only:
            return jnp.minimum(zb, zc), ib
        idc = jnp.min(jnp.where(z == zc[..., None],
                                r[15].astype(jnp.int32), _NO_ID), axis=-1)
        better = (zc < zb) | ((zc == zb) & (idc < ib))
        return jnp.where(better, zc, zb), jnp.where(better, idc, ib)

    NB, P = BY * BX, bw * bh
    zb, ib = jax.lax.fori_loop(
        0, nmax, body, (jnp.full((NB, P), jnp.inf, jnp.float32),
                        jnp.full((NB, P), -1, jnp.int32)))

    def image(x):
        return x.reshape(BY, BX, bh, bw).transpose(0, 2, 1, 3).reshape(
            BY * bh, BX * bw)

    depth = image(jnp.where(jnp.isfinite(zb), zb, 1.0))
    return depth, (None if depth_only else image(ib))


def resolve_row_sharded(starts, recs, grid: BinGrid, mesh, axis: str,
                        interpret: bool | None = None,
                        depth_only: bool = False):
    """Resolve with bin ROWS split over a device mesh axis (SURVEY §2.6
    P6): each device evaluates only its band's record chunks, so raster
    latency scales with devices instead of replicating.  The pair
    stream + starts table stay replicated — they are small next to the
    pixel×triangle coverage work (the resolve cost), like the geometry
    "weights".  Outputs land row-band-sharded, the layout shade_stage
    pins anyway, so no resharding collective follows on the band
    boundaries.  `grid.by` must be a multiple of the axis size
    (rasterize pads the bin grid)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]
    assert grid.by % n == 0, (grid.by, n)
    BYs = grid.by // n
    band_grid = dataclasses.replace(grid, height=BYs * grid.bh)

    def per_shard(starts_l, recs_l):
        row0 = jnp.reshape(jax.lax.axis_index(axis) * BYs,
                           (1,)).astype(jnp.int32)
        out = resolve(starts_l, recs_l, band_grid, interpret=interpret,
                      row0=row0, depth_only=depth_only)
        return out[0] if depth_only else out

    spec = P(axis, None)
    if depth_only:
        depth = shard_map(per_shard, mesh=mesh, in_specs=(P(), P()),
                          out_specs=spec, check_vma=False)(starts, recs)
        return depth, None
    return shard_map(per_shard, mesh=mesh, in_specs=(P(), P()),
                     out_specs=(spec, spec),
                     check_vma=False)(starts, recs)


def stub_vis(vh, vw, T, keep=0.0, depth_only=False, overflow=None):
    """Fabricated visibility buffer for the attribution stubs
    (tools/bench_toggle.py): 4x4-pixel blocks of one tri_id (gather
    coherence downstream), smooth in-range depth, no misses.  `keep` is
    an epsilon term added to depth so upstream ops the stub is meant to
    keep live cannot be folded away.  NOT a rendering mode."""
    yy = jax.lax.broadcasted_iota(jnp.int32, (vh, vw), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (vh, vw), 1)
    tid = ((yy // 4) * (vw // 4) + xx // 4) % max(T, 1)
    sdepth = (0.3 + 0.4 * xx.astype(jnp.float32) / vw
              + 0.2 * yy.astype(jnp.float32) / vh + keep)
    if overflow is None:
        overflow = jnp.int32(0)
    return VisibilityBuffer(depth=sdepth,
                            tri_id=None if depth_only else tid,
                            overflow=overflow)


def stream_grid(grid: BinGrid, T: int) -> BinGrid:
    """`grid` with pair_cap cut to the sorted pair stream's length
    (chunk-rounded): tiny scenes emit fewer keys than pair_cap."""
    S = grid.n_small * T + grid.med_cap * grid.med_slots
    cap = min(grid.pair_cap, _cdiv(S, grid.chunk) * grid.chunk)
    return dataclasses.replace(grid, pair_cap=cap)


def pair_stream(setup: PlanarSetup, grid: BinGrid):
    """Binning + record gather -> (starts, recs, overflow), the resolve's
    inputs for stream_grid(grid, T).  The gather spans pair_cap + chunk
    columns (sentinel past the stream), so every chunk load from a
    start <= pair_cap stays in bounds."""
    T = setup.adj.shape[1]
    cap = stream_grid(grid, T).pair_cap
    starts, sorted_tids, overflow = build_pairs(setup, grid)
    records = build_records(setup)
    idx = jnp.minimum(sorted_tids[:cap], T)
    idx = jnp.pad(idx, (0, cap + grid.chunk - idx.shape[0]),
                  constant_values=T)
    return starts, records[:, idx], overflow


def rasterize(clip, grid: BinGrid, cull: str = "front",
              interpret: bool | None = None, shard=None,
              stub: bool = False, depth_only: bool = False
              ) -> tuple[VisibilityBuffer, PlanarSetup]:
    """Full raster: clip (3 verts, 4 comps, T) planar clip positions
    (models/scene_batch.py layout) -> visibility buffer.

    shard: optional (mesh, axis_name) — resolve bin rows split over the
    mesh axis (resolve_row_sharded); setup/binning stay replicated.

    stub: attribution probe (tools/bench_toggle.py stub_resolve) — skip
    ONLY the resolve kernel; setup/binning/record-gather stay
    live (consumed through an epsilon term that cannot be folded).
    Outputs mimic the real distribution coarsely: 4x4-pixel blocks of
    one tri_id (gather coherence downstream) and a smooth in-range
    depth with no misses.  NOT a rendering mode.
    """
    T = clip.shape[2]
    vh, vw = grid.height, grid.width
    setup = triangle_setup_planar(clip, grid.width, grid.height, cull)
    if shard is not None:
        # pad the bin grid to a shard multiple of bin rows; bboxes were
        # clamped to the true viewport above, so padded rows get no
        # pairs (their bins resolve to the 1.0/-1 clear and are cropped)
        mesh, axis = shard
        n_sh = mesh.shape[axis]
        BYp = _cdiv(grid.by, n_sh) * n_sh
        grid = dataclasses.replace(grid, height=BYp * grid.bh)
    starts, recs, overflow = pair_stream(setup, grid)
    rgrid = stream_grid(grid, T)
    if stub:
        keep = (starts.astype(jnp.float32).sum() + recs.sum()) * 1e-30
        vis = stub_vis(vh, vw, T, keep=keep, depth_only=depth_only,
                       overflow=overflow)
        return vis, setup
    if shard is None:
        depth, tid = resolve(starts, recs, rgrid, interpret=interpret,
                             depth_only=depth_only)
    else:
        depth, tid = resolve_row_sharded(starts, recs, rgrid, mesh, axis,
                                         interpret=interpret,
                                         depth_only=depth_only)
    vis = VisibilityBuffer(depth=depth[:vh, :vw],
                           tri_id=None if tid is None else tid[:vh, :vw],
                           overflow=overflow)
    return vis, setup


rasterize_jit = jax.jit(rasterize, static_argnames=(
    "grid", "cull", "interpret", "shard", "stub", "depth_only"))
