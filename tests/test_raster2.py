"""Rasterizer (sort-binned + Pallas resolve) tests vs the numpy oracle.

Runs the resolve kernel in Pallas interpret mode on the CPU test mesh
(conftest pins JAX_PLATFORMS=cpu); chip_smoke.py runs the same checks
with the kernel compiled for the GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from soc_real_time_renderer.ops import raster2
from raster_oracle import make_clip, naive_raster

GRID = raster2.BinGrid(width=64, height=64, bin_size=32, chunk=32,
                       pair_cap=2048, med_cap=128, med_slots=16)


def rasterize(clip, n, cull="none", grid=GRID):
    # planar (3 verts, 4 comps, T) layout
    tri_clip = jnp.asarray(clip.reshape(n, 3, 4).transpose(1, 2, 0))
    return raster2.rasterize_jit(tri_clip, grid, cull, True)


def test_soup_matches_naive():
    rng = np.random.default_rng(0)
    n = 40
    centers = rng.uniform([-1, -1, -4], [1, 1, -2], (n, 3))
    offs = rng.uniform(-0.5, 0.5, (n, 3, 3))
    verts = (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)
    clip = make_clip(verts)
    vis, _ = rasterize(clip, n)
    idx = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    nd, nt = naive_raster(clip, idx, 64, 64, cull="none")
    got = np.asarray(vis.tri_id) >= 0
    exp = nt >= 0
    assert (got != exp).mean() < 0.01
    agree = got & exp & (np.asarray(vis.tri_id) == nt)
    assert agree.sum() >= 0.95 * (got & exp).sum()
    np.testing.assert_allclose(np.asarray(vis.depth)[agree], nd[agree],
                               atol=1e-3)


def test_single_triangle_matches_naive():
    # CCW (y-up view space) triangle at z=-1: visible under cull='front'.
    verts = [[0.0, 0.5, -1.0], [-0.5, -0.5, -1.0], [0.5, -0.5, -1.0]]
    clip = make_clip(verts)
    vis, _ = rasterize(clip, 1, cull="front")
    idx = np.array([[0, 1, 2]], np.int32)
    nd, nt = naive_raster(clip, idx, 64, 64)
    got_cov = np.asarray(vis.tri_id) >= 0
    assert got_cov.sum() > 100
    mismatch = (got_cov != (nt >= 0)).sum()
    assert mismatch <= 12  # edge-rule differences only
    both = got_cov & (nt >= 0)
    np.testing.assert_allclose(np.asarray(vis.depth)[both], nd[both],
                               atol=1e-4)


def test_backface_culled():
    verts = [[0.0, 0.5, -1.0], [-0.5, -0.5, -1.0], [0.5, -0.5, -1.0]]
    clip_ccw = make_clip(verts)
    clip_cw = make_clip([verts[0], verts[2], verts[1]])
    vis_f, _ = rasterize(clip_cw, 1, cull="front")
    assert int((np.asarray(vis_f.tri_id) >= 0).sum()) == 0
    vis_b, _ = rasterize(clip_cw, 1, cull="back")
    assert int((np.asarray(vis_b.tri_id) >= 0).sum()) > 100
    vis_n, _ = rasterize(clip_ccw, 1, cull="none")
    assert int((np.asarray(vis_n.tri_id) >= 0).sum()) > 100


def test_depth_ordering():
    # Two quads (as tris), nearer one wins.
    def quad(z, s):
        return [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]

    verts = np.asarray(quad(-2.0, 1.0) + quad(-1.0, 0.3), np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2], [4, 6, 5], [4, 7, 6]], np.int32)
    clip = make_clip(verts[idx.reshape(-1)])
    vis, _ = rasterize(clip, 4, cull="none")
    tid = np.asarray(vis.tri_id)
    center = tid[32, 32]
    assert center in (2, 3)  # near quad in the middle
    # (20, 20) is outside the near quad (pixels ~22..42) but inside the
    # far one (pixels 16..48).
    corner = tid[20, 20]
    assert corner in (0, 1)
    nd, nt = naive_raster(make_clip(verts), idx, 64, 64, cull="none")
    both = (tid >= 0) & (nt >= 0)
    np.testing.assert_allclose(np.asarray(vis.depth)[both], nd[both],
                               atol=1e-4)


def test_medium_triangle_path():
    # a triangle spanning most of the screen exercises the med expansion
    verts = [[0.0, 3.0, -1.0], [-3.0, -3.0, -1.0], [3.0, -3.0, -1.0]]
    clip = make_clip(verts)
    vis, setup = rasterize(clip, 1, cull="none")
    cov = (np.asarray(vis.tri_id) >= 0).mean()
    assert cov > 0.5
    idx = np.array([[0, 1, 2]], np.int32)
    nd, nt = naive_raster(clip, idx, 64, 64, cull="none")
    got = np.asarray(vis.tri_id) >= 0
    assert (got != (nt >= 0)).mean() < 0.02


def test_near_plane_crossing():
    verts = np.asarray([[0.0, 0.05, -5.0], [-0.3, 0.05, 1.0],
                        [0.3, 0.05, 1.0]], np.float32)
    clip = make_clip(verts.tolist())
    vis, _ = rasterize(clip, 1, cull="none")
    d = np.asarray(vis.depth)
    assert np.all(np.isfinite(d))
    assert (np.asarray(vis.tri_id) >= 0).sum() > 0


def test_offscreen_and_degenerate():
    verts = [[10.0, 10.0, -1.0], [10.5, 10.0, -1.0], [10.0, 10.5, -1.0],
             [0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]
    clip = make_clip(verts)
    vis, setup = rasterize(clip, 2, cull="none")
    assert int((np.asarray(vis.tri_id) >= 0).sum()) == 0
    assert not bool(np.asarray(setup.valid).any())
    np.testing.assert_allclose(np.asarray(vis.depth), 1.0)


def test_overflow_flags():
    # A scene exceeding every static cap must raise the matching
    # OVERFLOW_* bits (no silent fragment loss — VERDICT weak #4).
    rng = np.random.default_rng(1)
    n = 64
    centers = rng.uniform([-1, -1, -4], [1, 1, -2], (n, 3))
    offs = rng.uniform(-0.5, 0.5, (n, 3, 3))
    verts = (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)
    clip = make_clip(verts)

    # ample caps: no overflow
    vis_ok, _ = rasterize(clip, n)
    assert int(vis_ok.overflow) == 0

    # pair_cap too small for 64 triangles x >=1 bin each
    tight = raster2.BinGrid(width=64, height=64, bin_size=32,
                            chunk=8, pair_cap=16, med_cap=128,
                            med_slots=16)
    vis, _ = rasterize(clip, n, grid=tight)
    assert int(vis.overflow) & raster2.OVERFLOW_PAIRS

    # med_cap=1 with several medium (bbox > 4 bins) triangles
    big = np.asarray([[0.0, 3.0, -1.0], [-3.0, -3.0, -1.0],
                      [3.0, -3.0, -1.0]], np.float32)
    many_big = np.concatenate([big + [0, 0, -k * 0.1] for k in range(3)])
    clip_big = make_clip(many_big)
    medtight = raster2.BinGrid(width=64, height=64, bin_size=16,
                               chunk=32, pair_cap=2048, med_cap=1,
                               med_slots=4)
    vis_m, _ = rasterize(clip_big, 3, grid=medtight)
    ov = int(vis_m.overflow)
    assert ov & raster2.OVERFLOW_MED_CAP
    assert ov & raster2.OVERFLOW_MED_SLOTS


def test_jit_and_no_recompile():
    verts = [[0.0, 0.5, -1.0], [-0.5, -0.5, -1.0], [0.5, -0.5, -1.0]]
    clip = make_clip(verts)
    tri_clip = jnp.asarray(clip.reshape(1, 3, 4).transpose(1, 2, 0))
    f = jax.jit(lambda c: raster2.rasterize_jit(c, GRID, "front", True)[0])
    a = f(tri_clip)
    b = f(tri_clip * 1.0)
    np.testing.assert_allclose(np.asarray(a.depth), np.asarray(b.depth))


@pytest.mark.parametrize("bin_w,bin_h,chunk", [(16, 16, 8), (32, 8, 16),
                                                (64, 16, 32)])
def test_bin_shape_does_not_change_the_image(bin_w, bin_h, chunk):
    """Bins, chunks and the small/medium split only schedule the work:
    on well-shaped triangles every bin shape gives the image of the
    default grid, bit for bit (min z, exact ties to the smallest id)."""
    import dataclasses
    from raster_oracle import regular_soup
    n = 120
    clip, _ = regular_soup(n, 11, size=0.5)
    ref, _ = rasterize(clip, n)
    grid = dataclasses.replace(GRID, bin_size=0, bin_w=bin_w, bin_h=bin_h,
                               chunk=chunk)
    got, _ = rasterize(clip, n, grid=grid)
    assert int(got.overflow) == 0
    assert (np.asarray(ref.tri_id) >= 0).mean() > 0.2
    np.testing.assert_array_equal(np.asarray(got.tri_id),
                                  np.asarray(ref.tri_id))
    np.testing.assert_array_equal(np.asarray(got.depth),
                                  np.asarray(ref.depth))


def test_depth_only_matches_full():
    """The id-free shadow resolve kernel must produce bit-identical
    depth to the full kernel (same records, same chunk math)."""
    rng = np.random.default_rng(9)
    n = 40
    centers = rng.uniform([-1, -1, -4], [1, 1, -2], (n, 3))
    offs = rng.uniform(-0.5, 0.5, (n, 3, 3))
    verts = (centers[:, None, :] + offs).reshape(-1, 3).astype(np.float32)
    clip = make_clip(verts)
    tri_clip = jnp.asarray(clip.reshape(n, 3, 4).transpose(1, 2, 0))
    vis_full, _ = raster2.rasterize_jit(tri_clip, GRID, "none", True)
    vis_d, _ = raster2.rasterize_jit(tri_clip, GRID, "none", True,
                                     None, False, True)
    assert vis_d.tri_id is None
    np.testing.assert_array_equal(np.asarray(vis_d.depth),
                                  np.asarray(vis_full.depth))
