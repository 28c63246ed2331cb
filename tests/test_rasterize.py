"""Rasterizer correctness: analytic oracles, occlusion, hierarchy levels."""

import numpy as np
import pytest

import jax.numpy as jnp

from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    rasterize_batch,
    rasterize_triangles,
    transform_to_camera,
)
from geograypher_tpu.utils.fixtures import (
    brute_force_pix2face,
    gather_tri_verts,
    make_grid_mesh,
    nadir_camera,
)

SMALL = RasterConfig(caps=(256, 64, 32, 32))


def cam_tris(verts, faces, c2w):
    w2c = np.linalg.inv(c2w)
    tri = gather_tri_verts(verts, faces)
    return np.asarray(
        transform_to_camera(jnp.asarray(tri, jnp.float32), jnp.asarray(w2c, jnp.float32))
    )


def test_flat_mesh_pixel_oracle():
    """Flat plane at the triangle-ratio distance with one grid cell per
    pixel (the reference's analytic correctness oracle,
    tests/test_derived_meshes.py:16-76, re-derived for face ids).

    One-pixel triangles are the densest case: every candidate in a tile
    must be kept, so capacities are sized to the content and the overflow
    counter must read zero.
    """
    f, sensor, n = 20.0, 40, 41
    verts, faces = make_grid_mesh(n=n, size=4.0)
    c2w = nadir_camera(4.0, f, sensor)
    tris = cam_tris(verts, faces, c2w)
    from geograypher_tpu.ops.rasterize import bin_triangles, setup_triangles

    dense_cfg = RasterConfig(caps=(768, 32, 16, 8))
    setup = setup_triangles(
        jnp.asarray(tris, jnp.float32), jnp.asarray(f, jnp.float32), sensor, sensor
    )
    binned = bin_triangles(setup, dense_cfg, sensor, sensor)
    assert int(binned.overflow) == 0

    p2f = np.asarray(
        rasterize_triangles(jnp.asarray(tris), jnp.asarray(f, jnp.float32),
                            image_w=sensor, image_h=sensor, config=dense_cfg)
    )
    # Every pixel must hit the mesh
    assert (p2f >= 0).all()
    # Pixel (r, c) center lies in grid cell (iy=n-2-r, ix=c); the two
    # triangles of cell (iy, ix) are ids 2*(iy*(n-1)+ix) (+1).
    r, c = np.meshgrid(np.arange(sensor), np.arange(sensor), indexing="ij")
    cell = (n - 2 - r) * (n - 1) + c
    ok = (p2f == 2 * cell) | (p2f == 2 * cell + 1)
    assert ok.all(), f"{(~ok).sum()} pixels landed in the wrong cell"


def test_matches_brute_force_oracle():
    """Bit-exact agreement with an independent numpy rasterizer on a bumpy
    mesh (non-trivial depth) at an oblique view."""
    rng = np.random.default_rng(3)
    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.3 * np.sin(2 * x) * np.cos(3 * y)
    )
    # Oblique camera: rotate the nadir pose around X by 25 degrees
    c2w = nadir_camera(4.0, 50.0, 80)
    a = np.deg2rad(25)
    rot = np.array(
        [[1, 0, 0, 0], [0, np.cos(a), -np.sin(a), 0], [0, np.sin(a), np.cos(a), 0], [0, 0, 0, 1]]
    )
    c2w = rot @ c2w
    tris = cam_tris(verts, faces, c2w)
    p2f = np.asarray(
        rasterize_triangles(jnp.asarray(tris), jnp.asarray(50.0, jnp.float32),
                            image_w=80, image_h=80, config=SMALL)
    )
    oracle = brute_force_pix2face(tris.astype(np.float64), 50.0, 80, 80)
    agree = p2f == oracle
    # f32 vs f64 edge tests can flip pixels exactly on triangle boundaries;
    # everything else must agree exactly.
    assert agree.mean() > 0.995, f"only {agree.mean():.4f} agreement"
    # disagreeing pixels must still be adjacent faces (boundary flips)
    bad = ~agree
    if bad.any():
        assert np.all(np.abs(p2f[bad] - oracle[bad]) <= 21 * 2 + 2)


def test_occlusion():
    """A small plane floating above a big plane must win the z-test."""
    v_lo, f_lo = make_grid_mesh(n=5, size=4.0)
    v_hi, f_hi = make_grid_mesh(n=3, size=1.0, offset=(0.0, 0.0, 1.0))
    verts = np.concatenate([v_lo, v_hi], axis=0)
    faces = np.concatenate([f_lo, f_hi + v_lo.shape[0]], axis=0)
    n_lo = f_lo.shape[0]
    c2w = nadir_camera(4.0, 100.0, 200)
    tris = cam_tris(verts, faces, c2w)
    p2f = np.asarray(
        rasterize_triangles(jnp.asarray(tris), jnp.asarray(100.0, jnp.float32),
                            image_w=200, image_h=200, config=SMALL)
    )
    # Center of image: the high plane (faces >= n_lo) must be visible.
    assert p2f[100, 100] >= n_lo
    # Corner: only the low plane exists there.
    assert 0 <= p2f[5, 5] < n_lo
    # The high plane spans [-0.5, .5]^2 world = 25px half-width from center:
    assert (p2f[80:120, 80:120] >= n_lo).all()
    assert (p2f[10:40, 10:40] < n_lo).all()


def test_giant_triangle_global_list():
    """A triangle covering the whole image exercises the level-3 path."""
    tris = np.array(
        [[[0.0, 0.0, 5.0], [300.0, 0.0, 5.0], [0.0, 300.0, 5.0]]]
    )
    p2f = np.asarray(
        rasterize_triangles(jnp.asarray(tris, jnp.float32), jnp.asarray(10.0, jnp.float32),
                            image_w=256, image_h=64, config=SMALL)
    )
    oracle = brute_force_pix2face(tris, 10.0, 256, 64)
    assert (p2f == oracle).all()
    assert (p2f == 0).any() and (p2f == -1).any()


def test_global_from_is_output_invariant():
    """``RasterConfig.global_from`` (pin the oversized-face tail to the
    global binning level) is a PERFORMANCE control: pix2face and the
    binning overflow must be bit-identical with and without it, and the
    census must show the tail moved to the global level."""
    from geograypher_tpu.ops.rasterize import (
        bin_triangles,
        setup_triangles,
    )

    verts, faces = make_grid_mesh(n=17, size=4.0)
    # append 16 giant faces (an oversized tail, ids at the end)
    rng = np.random.default_rng(3)
    anchor = rng.uniform(-2.0, 0.0, (16, 3))
    anchor[:, 2] = 0.0
    gv = np.stack(
        [anchor, anchor + [2.5, 0.0, 0.0], anchor + [2.5, 0.1, 0.0]],
        axis=1,
    ).reshape(48, 3)
    verts2 = np.concatenate([verts, gv], axis=0)
    faces2 = np.concatenate(
        [faces, len(verts) + np.arange(48).reshape(16, 3)], axis=0
    )
    # pad to a bin_block multiple
    bb = 8
    n = len(faces2)
    pad = -n % bb
    if pad:
        faces2 = np.concatenate([faces2, np.repeat(faces2[-1:], pad, 0)])
    gf = len(faces)  # first giant id
    c2w = nadir_camera(4.0, 30.0, 96)
    tris = cam_tris(verts2, faces2, c2w)
    base = RasterConfig(caps=(64, 32, 16, 16), bin_block=bb)
    import dataclasses

    pinned = dataclasses.replace(base, global_from=gf)
    outs = {}
    for name, cfg in (("plain", base), ("pinned", pinned)):
        setup = setup_triangles(
            jnp.asarray(tris, jnp.float32), jnp.asarray(30.0, jnp.float32),
            96, 96,
        )
        census = np.asarray(
            bin_triangles(setup, cfg, 96, 96, return_census=True)
        )
        p2f = np.asarray(
            rasterize_triangles(
                jnp.asarray(tris, jnp.float32),
                jnp.asarray(30.0, jnp.float32),
                image_w=96, image_h=96, config=cfg,
            )
        )
        outs[name] = (p2f, census)
    np.testing.assert_array_equal(outs["plain"][0], outs["pinned"][0])
    # pinned: the giant tail all sits in the global list; nothing of it
    # remains at L0..L2 (the grid faces stay at L0, so L0 is unchanged)
    assert outs["pinned"][1][3] >= outs["plain"][1][3]
    assert outs["pinned"][1][3] >= 2  # >= 16 faces / bin_block


def test_mixed_levels_and_background():
    """Small + medium + giant triangles together; background stays -1."""
    rng = np.random.default_rng(7)
    n = 60
    # camera-frame triangles at z in [2, 6), random sizes
    centers = np.concatenate(
        [rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(2, 6, (n, 1))], axis=1
    )
    sizes = rng.choice([0.01, 0.1, 0.8], n)[:, None]
    offs = rng.uniform(-1, 1, (n, 3, 2))
    tris = np.zeros((n, 3, 3))
    tris[:, :, :2] = centers[:, None, :2] + offs * sizes[:, None]
    tris[:, :, 2] = centers[:, None, 2]
    p2f = np.asarray(
        rasterize_triangles(jnp.asarray(tris, jnp.float32), jnp.asarray(60.0, jnp.float32),
                            image_w=160, image_h=120, config=SMALL)
    )
    oracle = brute_force_pix2face(tris, 60.0, 160, 120)
    agree = (p2f == oracle).mean()
    assert agree > 0.995, f"agreement {agree}"


def test_behind_camera_and_degenerate():
    tris = np.array(
        [
            [[0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]],  # behind
            [[0.0, 0.0, 2.0], [1.0, 0.0, 2.0], [2.0, 0.0, 2.0]],  # degenerate
            [[-0.5, -0.5, 2.0], [0.5, -0.5, 2.0], [0.0, 0.5, 2.0]],  # fine
        ]
    )
    p2f = np.asarray(
        rasterize_triangles(jnp.asarray(tris, jnp.float32), jnp.asarray(50.0, jnp.float32),
                            image_w=100, image_h=100, config=SMALL)
    )
    hit = np.unique(p2f)
    assert set(hit.tolist()) == {-1, 2}


def test_batch_rasterize():
    verts, faces = make_grid_mesh(n=11, size=4.0)
    tri = jnp.asarray(gather_tri_verts(verts, faces), jnp.float32)
    c2w_a = nadir_camera(4.0, 50.0, 100)
    c2w_b = c2w_a.copy()
    c2w_b[2, 3] = 4.0  # higher camera -> mesh smaller in view
    w2c = jnp.asarray(
        np.stack([np.linalg.inv(c2w_a), np.linalg.inv(c2w_b)]), jnp.float32
    )
    fs = jnp.asarray([50.0, 50.0], jnp.float32)
    p2f = np.asarray(
        rasterize_batch(tri, w2c, fs, image_w=100, image_h=100, config=SMALL)
    )
    assert p2f.shape == (2, 100, 100)
    assert (p2f[0] >= 0).all()  # mesh fills the frame at distance 2
    assert (p2f[1] == -1).any() and (p2f[1] >= 0).any()  # smaller at distance 4


def test_setup_from_soa_distortion():
    """Vertex-space Brown-Conrady rasterization: zero distortion equals
    the pinhole raster exactly; nonzero k1 agrees with the reference-style
    NN remap of the pinhole map on ~all pixels (both approximate the same
    ground truth; they may differ along triangle edges)."""
    import jax.numpy as jnp

    from geograypher_tpu.cameras.distortion import (
        make_maps,
        remap_image_jax,
    )
    from geograypher_tpu.ops.rasterize import (
        RasterConfig,
        rasterize_setup,
        setup_from_soa,
        tri_to_soa,
    )
    from geograypher_tpu.utils.fixtures import (
        gather_tri_verts,
        make_grid_mesh,
        nadir_camera,
    )

    H, W = 160, 256
    focal = 150.0
    config = RasterConfig(caps=(128, 64, 32, 32))
    verts, faces = make_grid_mesh(n=41, size=4.0)
    tri_soa = jnp.asarray(
        tri_to_soa(gather_tri_verts(verts, faces).astype(np.float32))
    )
    w2c = jnp.asarray(
        np.linalg.inv(nadir_camera(4.0, focal, W)), jnp.float32
    )
    fl = jnp.float32(focal)

    setup0 = setup_from_soa(tri_soa, w2c, fl, W, H)
    p2f0, _ = rasterize_setup(setup0, config, H, W)

    zero = (np.zeros(8), 0.0, 0.0)
    setup_z = setup_from_soa(tri_soa, w2c, fl, W, H, distortion=zero)
    p2f_z, _ = rasterize_setup(setup_z, config, H, W)
    np.testing.assert_array_equal(np.asarray(p2f_z), np.asarray(p2f0))

    dist = np.array([0.08, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    setup_d = setup_from_soa(
        tri_soa, w2c, fl, W, H, distortion=(dist, 0.0, 0.0)
    )
    p2f_d, _ = rasterize_setup(setup_d, config, H, W)

    # reference-style: pinhole render then NN warp into distorted geometry
    _i2w, w2i = make_maps(
        float(focal), 0.0, 0.0, W, H, dist, image_scale=1.0
    )
    p2f_ref = remap_image_jax(p2f0, jnp.asarray(w2i), fill_value=-1)

    a, b = np.asarray(p2f_d), np.asarray(p2f_ref)
    both = (a >= 0) & (b >= 0)
    agree = np.mean(a[both] == b[both])
    # the NN remap quantizes edges to the nearest pixel while the vertex
    # warp is sub-pixel; at ~3 px triangles roughly half the pixels are
    # edge pixels, so ~0.87 agreement is the expected NN-noise level
    assert agree > 0.85, f"vertex-warp vs NN-remap agreement {agree:.3f}"
    # coverage should be close
    assert abs(np.mean(a >= 0) - np.mean(b >= 0)) < 0.05
