"""Triton resolve kernel (ops/pallas_raster.py) vs the XLA reference resolve.

The kernel runs through the Pallas interpreter here (``interpret=True``);
the same kernel compiles for the GPU, where ``resolve_tiles`` selects it.
Both resolves consume the SAME binning, so any difference is the resolve's
own: FMA contraction and summation order may flip a pixel centre lying
exactly on a shared edge between two faces.  At survey scale that is under
1e-4 of covered pixels; these small grid meshes are aligned with the pixel
grid, so far more of their pixel centres sit exactly on edges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    _raster_tiles_xla,
    bin_triangles,
    concat_candidates_for_tiles,
    resolve_tiles,
    setup_from_soa,
    tri_to_soa,
)
from geograypher_tpu.utils.fixtures import (
    brute_force_pix2face,
    make_grid_mesh,
    make_irregular_mesh,
    nadir_camera,
    oblique_camera,
)
from tests.test_rasterize import cam_tris

CFG = RasterConfig(caps=(256, 64, 32, 32))


def _pad_block(tris, block):
    """Pad (F, 3, 3) triangles to a bin_block multiple with culled faces
    (behind the camera)."""
    pad = (-tris.shape[0]) % block
    if pad:
        filler = np.zeros((pad, 3, 3))
        filler[..., 2] = -1.0
        tris = np.concatenate([tris, filler], axis=0)
    return tris


def run_both(tris, f, w, h, config=CFG, distortion=None):
    """(reference pix2face, kernel pix2face, binning overflow) for
    camera-frame triangles, from ONE shared binning."""
    tris = _pad_block(np.asarray(tris, np.float64), config.bin_block)
    soa = tri_to_soa(jnp.asarray(tris, jnp.float32))
    setup = setup_from_soa(
        soa, jnp.eye(4, dtype=jnp.float32), jnp.float32(f), w, h,
        config.znear, distortion=distortion,
    )
    binned = bin_triangles(setup, config, h, w)
    ref = resolve_tiles(binned, setup.planes, config, h, w)
    ker = resolve_tiles(binned, setup.planes, config, h, w, interpret=True)
    return np.asarray(ref), np.asarray(ker), int(binned.overflow)


# knife-edge flips allowed, as a share of covered pixels (see module
# docstring); every flip must be a swap between two faces
EDGE_FLIP_SHARE = 2e-3
# across two BINNINGS of one flat mesh, depth ties on shared edges also
# resolve in a different level order
REBIN_FLIP_SHARE = 1e-2


def assert_equiv(ref, ker, share=EDGE_FLIP_SHARE):
    """Same shape; disagreements are face-vs-face swaps at knife edges."""
    assert ref.shape == ker.shape
    bad = ref != ker
    covered = max(int((ref >= 0).sum()), 1)
    assert bad.sum() <= share * covered, (
        f"{bad.sum()} of {covered} differ"
    )
    if bad.any():
        assert (ref[bad] >= 0).all() and (ker[bad] >= 0).all()


def test_pallas_matches_xla_bumpy_mesh():
    verts, faces = make_grid_mesh(
        n=15, size=4.0, z_fn=lambda x, y: 0.25 * np.sin(2 * x) * np.cos(y)
    )
    tris = cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80))
    ref, ker, over = run_both(tris, 50.0, 80, 80)
    assert over == 0
    assert_equiv(ref, ker)
    assert (ref >= 0).any()


def test_pallas_matches_xla_mixed_sizes():
    rng = np.random.default_rng(11)
    n = 50
    centers = np.concatenate(
        [rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(2, 6, (n, 1))], axis=1
    )
    sizes = rng.choice([0.02, 0.15, 1.0], n)[:, None]
    offs = rng.uniform(-1, 1, (n, 3, 2))
    tris = np.zeros((n, 3, 3))
    tris[:, :, :2] = centers[:, None, :2] + offs * sizes[:, None]
    tris[:, :, 2] = centers[:, None, 2]
    ref, ker, _ = run_both(tris, 60.0, 256, 64)
    assert_equiv(ref, ker)
    assert (ref >= 0).any() and (ref == -1).any()


def test_pallas_occlusion_and_multichunk():
    """Hundreds of candidates in one tile, and a raised plane occluding
    the ground: the kernel walks the whole list and keeps the nearest."""
    v_lo, f_lo = make_grid_mesh(n=17, size=1.2)  # 512 small faces, center
    v_hi, f_hi = make_grid_mesh(n=3, size=0.5, offset=(0.0, 0.0, 1.0))
    verts = np.concatenate([v_lo, v_hi], axis=0)
    faces = np.concatenate([f_lo, f_hi + v_lo.shape[0]], axis=0)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 100.0, 200))
    cfg = RasterConfig(caps=(768, 64, 32, 16))
    ref, ker, over = run_both(tris, 100.0, 200, 200, cfg)
    assert over == 0
    assert_equiv(ref, ker)
    assert ker[100, 100] >= f_lo.shape[0]  # raised plane wins depth


def test_pallas_block_binning_matches_xla():
    """bin_block=8 (block-granular binning, the production setting): the
    kernel expands unit ids to faces itself."""
    verts, faces = make_grid_mesh(
        n=15, size=4.0, z_fn=lambda x, y: 0.25 * np.sin(2 * x) * np.cos(y)
    )
    tris = cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80))
    blk = RasterConfig(caps=(64, 16, 8, 8), bin_block=8)
    ref, ker, over = run_both(tris, 50.0, 80, 80, blk)
    assert over == 0
    assert_equiv(ref, ker)
    # and match face-granular binning
    flat, _, _ = run_both(tris, 50.0, 80, 80)
    assert_equiv(flat, ker, REBIN_FLIP_SHARE)


def test_pallas_block_binning_unordered_faces():
    """Blocks of spatially-UNRELATED faces (permuted order) are slower but
    must stay exactly correct (ride-along faces are inert)."""
    rng = np.random.default_rng(4)
    verts, faces = make_grid_mesh(n=9, size=4.0)
    faces = faces[rng.permutation(faces.shape[0])]
    tris = cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80))
    blk = RasterConfig(caps=(64, 32, 32, 32), bin_block=8)
    ref, ker, _ = run_both(tris, 50.0, 80, 80, blk)
    assert_equiv(ref, ker)
    flat, _, _ = run_both(tris, 50.0, 80, 80)
    assert_equiv(flat, ker, REBIN_FLIP_SHARE)


def test_pallas_l0_window3_matches_xla():
    """A 3x3 level-0 window (keeps tall oblique bboxes out of the L1
    resolve) with faces spanning several 8-px tile rows."""
    verts, faces = make_grid_mesh(
        n=15, size=4.0, z_fn=lambda x, y: 0.25 * np.sin(2 * x) * np.cos(y)
    )
    tris = cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80))
    w3 = RasterConfig(caps=(64, 16, 8, 8), bin_block=8, l0_window=3)
    ref, ker, over = run_both(tris, 160.0, 160, 96, w3)
    assert over == 0
    assert_equiv(ref, ker)
    assert (ker >= 0).any()


def test_pallas_oblique_deep_overdraw_matches_xla():
    """Oblique view over a bumpy mesh: deep far-field tiles."""
    verts, faces = make_grid_mesh(
        n=41, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(3 * x) * np.cos(2 * y)
    )
    c2w = oblique_camera(3.0, 90.0, 160, pitch_deg=32.0, azimuth_deg=135.0)
    tris = cam_tris(verts, faces, c2w)
    cfg = RasterConfig(caps=(512, 64, 32, 16), l0_window=(5, 2))
    ref, ker, over = run_both(tris, 90.0, 160, 96, cfg)
    assert over == 0
    assert_equiv(ref, ker)
    assert (ref >= 0).any()


def test_pallas_irregular_tin_matches_xla():
    """Irregular Delaunay TIN (photogrammetry-like face sizes)."""
    verts, faces = make_irregular_mesh(n_points=300, size=4.0, seed=3)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 60.0, 120))
    cfg = RasterConfig(caps=(128, 32, 32, 32), bin_block=8, l0_window=(5, 2))
    ref, ker, over = run_both(tris, 60.0, 120, 88, cfg)
    assert over == 0
    assert_equiv(ref, ker)
    assert len(np.unique(ker[ker >= 0])) > 50


def test_pallas_distorted_matches_xla():
    """Brown-Conrady sensor: vertices warped into distorted pixel space at
    setup; the resolve itself is unchanged."""
    verts, faces = make_grid_mesh(n=15, size=4.0)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 50.0, 96))
    dist = (
        jnp.asarray([0.05, -0.02, 0.0, 0.0, 1e-3, -1e-3, 0.0, 0.0]),
        jnp.float32(1.5),
        jnp.float32(-2.0),
    )
    ref, ker, over = run_both(tris, 50.0, 96, 80, distortion=dist)
    undist, _, _ = run_both(tris, 50.0, 96, 80)
    assert over == 0
    assert_equiv(ref, ker)
    assert (ker != undist).any()  # the warp really moved pixels


def test_pallas_empty_image():
    """A camera that sees nothing: every pixel stays background."""
    verts, faces = make_grid_mesh(n=9, size=4.0)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80))
    tris = tris.copy()
    tris[..., 2] = -tris[..., 2]  # everything behind the camera
    ref, ker, over = run_both(tris, 50.0, 80, 80)
    assert over == 0
    assert (ref == -1).all() and (ker == -1).all()


def test_pallas_cap_overflow_matches_xla():
    """Undersized caps drop candidates and report it; the kernel resolves
    exactly the truncated lists the reference does."""
    verts, faces = make_grid_mesh(n=17, size=4.0)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 60.0, 128))
    tiny = RasterConfig(caps=(8, 4, 4, 4))
    ref, ker, over = run_both(tris, 60.0, 128, 64, tiny)
    assert over > 0
    assert_equiv(ref, ker)
    full, _, _ = run_both(tris, 60.0, 128, 64)
    assert (ref != full).any()  # the drop is visible, never silent


@pytest.mark.parametrize("h, w", [(77, 133), (9, 130), (8, 1), (130, 7)])
def test_pallas_image_not_tile_multiple(h, w):
    """Image sizes that are not tile multiples: the padded tile grid is
    cropped back to (h, w)."""
    verts, faces = make_grid_mesh(n=11, size=4.0)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 40.0, max(h, w)))
    ref, ker, _ = run_both(tris, 40.0, w, h)
    assert ker.shape == (h, w)
    assert_equiv(ref, ker)
    assert (ker >= 0).any()


def test_pallas_lowest_face_id_ties():
    """Exact depth ties (coplanar duplicate faces) resolve to the lowest
    face id, like the brute-force oracle."""
    verts, faces = make_grid_mesh(n=7, size=4.0)
    tris = cam_tris(verts, faces, nadir_camera(4.0, 40.0, 64))
    n = tris.shape[0]
    dup = np.concatenate([tris, tris[::-1]], axis=0)  # face k ties 2n-1-k
    ref, ker, over = run_both(dup, 40.0, 64, 64)
    assert over == 0
    assert_equiv(ref, ker)
    oracle = brute_force_pix2face(dup, 40.0, 64, 64)
    seen = ker >= 0
    assert seen.any() and (ker[seen] < n).all()
    np.testing.assert_array_equal(seen, oracle >= 0)
    # the float64 oracle differs only at pixel centres on shared edges
    assert (ker == oracle).mean() > 0.98


def test_resolve_chosen_by_platform():
    """``resolve_tiles`` lowers to the Triton kernel for CUDA and to the
    XLA reference for the CPU, from one traced program; the CPU result is
    bit-identical to the reference."""
    verts, faces = make_grid_mesh(n=9, size=4.0)
    tris = jnp.asarray(
        cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80)), jnp.float32
    )
    setup = setup_from_soa(
        tri_to_soa(tris), jnp.eye(4), jnp.float32(50.0), 80, 80
    )
    binned = bin_triangles(setup, CFG, 80, 80)
    fn = jax.jit(lambda b, p: resolve_tiles(b, p, CFG, 80, 80))
    traced = fn.trace(binned, setup.planes)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda and "raster_resolve" in cuda
    assert "triton" not in cpu
    ref = _raster_tiles_xla(
        concat_candidates_for_tiles(binned, CFG, 80, 80), setup.planes, CFG,
        80, 80,
    )
    np.testing.assert_array_equal(
        np.asarray(fn(binned, setup.planes)), np.asarray(ref)
    )


def test_resolve_other_platform_raises():
    """No resolve exists for platforms other than CUDA and the CPU."""
    verts, faces = make_grid_mesh(n=5, size=4.0)
    tris = jnp.asarray(
        cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80)), jnp.float32
    )
    setup = setup_from_soa(
        tri_to_soa(tris), jnp.eye(4), jnp.float32(50.0), 80, 80
    )
    binned = bin_triangles(setup, CFG, 80, 80)
    traced = jax.jit(
        lambda b, p: resolve_tiles(b, p, CFG, 80, 80)
    ).trace(binned, setup.planes)
    with pytest.raises(NotImplementedError):
        traced.lower(lowering_platforms=("rocm",))


def test_kernel_refuses_cpu_without_interpret():
    """The kernel itself never falls back: off the GPU it runs only when a
    caller asks for the interpreter."""
    from geograypher_tpu.ops.pallas_raster import raster_tiles_triton

    verts, faces = make_grid_mesh(n=5, size=4.0)
    tris = jnp.asarray(
        cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80)), jnp.float32
    )
    setup = setup_from_soa(
        tri_to_soa(tris), jnp.eye(4), jnp.float32(50.0), 80, 80
    )
    binned = bin_triangles(setup, CFG, 80, 80)
    with pytest.raises(ValueError, match="interpret"):
        raster_tiles_triton(binned, setup.planes, CFG, 80, 80)


def test_kernel_config_guards():
    """A tile whose pixel count is not a power of two cannot be a Triton
    block: the wrapper refuses it instead of lowering."""
    from geograypher_tpu.ops.pallas_raster import raster_tiles_triton

    verts, faces = make_grid_mesh(n=5, size=4.0)
    tris = jnp.asarray(
        cam_tris(verts, faces, nadir_camera(4.0, 50.0, 80)), jnp.float32
    )
    cfg = dataclasses.replace(CFG, tile_h=6)
    setup = setup_from_soa(
        tri_to_soa(tris), jnp.eye(4), jnp.float32(50.0), 80, 80
    )
    binned = bin_triangles(setup, cfg, 80, 80)
    with pytest.raises(ValueError, match="power-of-two"):
        raster_tiles_triton(
            binned, setup.planes, cfg, 80, 80, interpret=True
        )
