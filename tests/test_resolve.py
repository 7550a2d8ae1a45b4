"""The raster resolve kernel (Pallas, Triton route) in interpret mode
against the float64 oracle and the plain-jnp resolve, plus the
backend rule that picks compiled vs interpreted kernels.

chip_smoke.py runs the same comparisons with the kernel compiled for
the GPU at 1920x1088 and 4096x4096; `test_compiled_resolve_matches_plain`
is the card-only form of them here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raster_oracle import naive_raster, soup
from soc_real_time_renderer.ops import backend, raster2

W = H = 64
GRID = raster2.BinGrid(width=W, height=H, bin_w=32, bin_h=16, chunk=16,
                       pair_cap=4096, med_cap=256, med_slots=16)


def _stream(planar, grid, cull="none"):
    setup = raster2.triangle_setup_planar(jnp.asarray(planar), grid.width,
                                          grid.height, cull)
    starts, recs, ov = raster2.pair_stream(setup, grid)
    assert int(ov) == 0
    return starts, recs, raster2.stream_grid(grid, planar.shape[2])


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("depth_only", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_matches_plain_and_oracle(seed, depth_only, chunk):
    n = 60
    clip, planar = soup(n, seed, extent=0.4)
    grid = dataclasses.replace(GRID, chunk=chunk)
    starts, recs, rgrid = _stream(planar, grid)
    kd, kt = raster2.resolve(starts, recs, rgrid, interpret=True,
                             depth_only=depth_only)
    xd, xt = raster2.resolve_xla(starts, recs, rgrid,
                                 depth_only=depth_only)
    # same stream, same arithmetic order: bit-identical on the CPU
    np.testing.assert_array_equal(np.asarray(kd), np.asarray(xd))
    if depth_only:
        assert kt is None and xt is None
    else:
        np.testing.assert_array_equal(np.asarray(kt), np.asarray(xt))

    od, ot = naive_raster(clip, np.arange(3 * n).reshape(n, 3), W, H,
                          cull="none")
    kd = np.asarray(kd)[:H, :W]
    if depth_only:
        cov = (kd < 1.0) == (od < 1.0)
        assert cov.mean() > 0.995
        both = (kd < 1.0) & (od < 1.0)
        np.testing.assert_allclose(kd[both], od[both], atol=1e-4)
    else:
        kt = np.asarray(kt)[:H, :W]
        same = kt == ot
        assert same.mean() > 0.995
        np.testing.assert_allclose(kd[same], od[same], atol=1e-4)


def test_empty_bins_resolve_to_clear():
    """One small triangle: every other bin has start == end and must run
    zero chunks and write the clear values."""
    verts = np.asarray([[0.3, 0.3, -2.0], [0.5, 0.3, -2.0],
                        [0.3, 0.5, -2.0]], np.float32)
    from raster_oracle import make_clip
    clip = make_clip(verts)
    planar = np.ascontiguousarray(clip.reshape(1, 3, 4).transpose(1, 2, 0))
    starts, recs, rgrid = _stream(planar, GRID)
    s = np.asarray(starts)
    assert (s[1:] == s[:-1]).sum() >= GRID.num_bins - 2
    d, t = raster2.resolve(starts, recs, rgrid, interpret=True)
    d, t = np.asarray(d), np.asarray(t)
    hit = t >= 0
    assert 0 < hit.sum() < 200
    assert np.all(d[~hit] == 1.0) and np.all(t[~hit] == -1)


def test_unaligned_starts_and_chunk_tails():
    """Bins start at arbitrary record columns (no chunk alignment) and
    end mid-chunk; the loads must read from the true start and mask the
    tail, so every chunk size gives the same image."""
    clip, planar = soup(90, 5, extent=0.3)
    outs = []
    for chunk in (8, 16, 32):
        grid = dataclasses.replace(GRID, chunk=chunk)
        starts, recs, rgrid = _stream(planar, grid)
        s = np.asarray(starts)
        if chunk == 16:
            assert np.any(s[:-1] % chunk != 0)
            assert np.any((s[1:] - s[:-1]) % chunk != 0)
        d, t = raster2.resolve(starts, recs, rgrid, interpret=True)
        outs.append((np.asarray(d), np.asarray(t)))
    for d, t in outs[1:]:
        np.testing.assert_array_equal(d, outs[0][0])
        np.testing.assert_array_equal(t, outs[0][1])


@pytest.mark.parametrize("depth_only", [False, True])
def test_row0_offsets_a_band(depth_only):
    """A call over a band of bin rows with row0 > 0 (the
    resolve_row_sharded form) reproduces those rows of the full image."""
    clip, planar = soup(70, 3, extent=0.4)
    starts, recs, rgrid = _stream(planar, GRID)
    full_d, full_t = raster2.resolve(starts, recs, rgrid, interpret=True,
                                     depth_only=depth_only)
    band_rows = 2
    band = dataclasses.replace(rgrid, height=band_rows * rgrid.bh)
    row0 = jnp.asarray([1], jnp.int32)
    d, t = raster2.resolve(starts, recs, band, interpret=True, row0=row0,
                           depth_only=depth_only)
    y0, y1 = rgrid.bh, (1 + band_rows) * rgrid.bh
    np.testing.assert_array_equal(np.asarray(d),
                                  np.asarray(full_d)[y0:y1])
    xd, _ = raster2.resolve_xla(starts, recs, band, row0=row0,
                                depth_only=depth_only)
    np.testing.assert_array_equal(np.asarray(xd), np.asarray(d))
    if not depth_only:
        np.testing.assert_array_equal(np.asarray(t),
                                      np.asarray(full_t)[y0:y1])


def test_exact_ties_take_the_smallest_id():
    """Two coincident triangles: every covered pixel is an exact z tie
    and must go to the lower id, whatever the chunking."""
    from raster_oracle import make_clip
    tri = [[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.5, -2.0]]
    clip = make_clip(tri * 2)
    planar = np.ascontiguousarray(clip.reshape(2, 3, 4).transpose(1, 2, 0))
    for chunk in (8, 16):
        grid = dataclasses.replace(GRID, chunk=chunk)
        starts, recs, rgrid = _stream(planar, grid)
        _, t = raster2.resolve(starts, recs, rgrid, interpret=True)
        t = np.asarray(t)
        assert (t == 0).sum() > 100 and not np.any(t == 1)


def test_records_layout_and_sentinel():
    """Records are [adj 9 | z 3 | w 3 | exact float id] per triangle,
    and the all-zero sentinel column T covers no pixel."""
    clip, planar = soup(20, 4)
    setup = raster2.triangle_setup_planar(jnp.asarray(planar), W, H,
                                          "none")
    rec = np.asarray(raster2.build_records(setup))
    assert rec.shape == (16, 21) and rec.dtype == np.float32
    vals = np.concatenate([np.asarray(setup.adj), np.asarray(setup.zs),
                           np.asarray(setup.ws)])
    np.testing.assert_array_equal(rec[:15, :20], vals)
    np.testing.assert_array_equal(rec[15, :20], np.arange(20))
    assert not rec[:, 20].any()
    # every bin gets 4 sentinel records: all resolve to the clear values
    grid = dataclasses.replace(GRID, pair_cap=4 * GRID.num_bins)
    starts = jnp.arange(grid.num_bins + 1, dtype=jnp.int32) * 4
    recs = jnp.broadcast_to(jnp.asarray(rec[:, 20:]),
                            (16, grid.pair_cap + grid.chunk))
    d, t = raster2.resolve(starts, recs, grid, interpret=True)
    assert np.all(np.asarray(d) == 1.0) and np.all(np.asarray(t) == -1)


def test_kernel_lowers_for_the_gpu():
    """The compiled (non-interpret) form lowers to a Triton kernel call
    for CUDA: catches primitives the Triton lowering does not support
    without needing a card."""
    clip, planar = soup(30, 6)
    starts, recs, rgrid = _stream(planar, GRID)
    for depth_only in (False, True):
        lowered = jax.jit(lambda s, r: raster2.resolve(
            s, r, rgrid, interpret=False, depth_only=depth_only)).trace(
            starts, recs).lower(lowering_platforms=("cuda",))
        assert "__gpu$xla.gpu.triton" in lowered.as_text()


@pytest.mark.gpu
def test_compiled_resolve_matches_plain(gpu):
    clip, planar = soup(2000, 7, extent=0.05, aspect=1920 / 1088)
    grid = raster2.default_grid(1920, 1088)
    starts, recs, rgrid = _stream(planar, dataclasses.replace(
        grid, pair_cap=65536, med_cap=2048))
    kd, kt = raster2.resolve(starts, recs, rgrid)
    xd, xt = raster2.resolve_xla(starts, recs, rgrid)
    assert float((np.asarray(kt) == np.asarray(xt)).mean()) > 0.9999
    np.testing.assert_allclose(np.asarray(kd), np.asarray(xd), atol=1e-6)


# ---------------------------------------------------------------------------
# backend rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("platform,want", [("gpu", False), ("cpu", True)])
def test_backend_rule(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert backend.interpret_mode() is want
    assert backend.interpret_mode(None) is want


@pytest.mark.parametrize("platform", ["rocm", "METAL", "iree"])
def test_backend_rule_rejects_other_platforms(monkeypatch, platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no Pallas route"):
        backend.interpret_mode()


@pytest.mark.parametrize("explicit", [True, False])
def test_backend_rule_explicit_override(monkeypatch, explicit):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    assert backend.interpret_mode(explicit) is explicit


# ---------------------------------------------------------------------------
# compile cache directory
# ---------------------------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from soc_real_time_renderer.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_default_is_the_checkout(monkeypatch):
    import os
    from soc_real_time_renderer.utils import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(root, ".jax_cache")


def test_compile_cache_entries_land_in_env_dir(tmp_path):
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import jax, jax.numpy as jnp\n"
            "from soc_real_time_renderer.utils import compile_cache\n"
            "compile_cache.enable()\n"
            "jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)).block_until_ready()\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu", PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                   check=True, timeout=120)
    assert any(tmp_path.iterdir())
