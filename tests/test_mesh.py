"""TexturedMesh engine tests: CRS frames, ROI, textures, rendering,
aggregation, vector export, polygon labeling."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from geograypher_tpu.cameras.core import CameraSet
from geograypher_tpu.meshes.mesh import TexturedMesh
from geograypher_tpu.ops.rasterize import RasterConfig
from geograypher_tpu.utils import crs as crs_utils
from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera
from geograypher_tpu.utils.vector import Polygon, VectorData

CFG = RasterConfig(caps=(512, 64, 32, 16))

# A survey site near (lat 36, lon -119), UTM zone 11N
SITE_LAT, SITE_LON = 36.0, -119.0
SITE_UTM = 32611


def make_geo_mesh(n=15, size=40.0, z0=100.0):
    """Grid mesh positioned at the site, in UTM coords -> TexturedMesh."""
    verts, faces = make_grid_mesh(n=n, size=size)
    e0, n0 = crs_utils.lla_to_tm(
        SITE_LAT, SITE_LON, np.deg2rad(-117.0), crs_utils.UTM_K0, 500000.0, 0.0
    )
    verts[:, 0] += e0
    verts[:, 1] += n0
    verts[:, 2] += z0
    return TexturedMesh(
        (verts, faces), CRS=SITE_UTM, raster_config=CFG
    ), (e0, n0)


def local_camera_set(mesh: TexturedMesh, n_cams=2, sensor=100, focal=50.0):
    """Cameras in a local frame centered on the mesh: local->ECEF maps the
    origin to the mesh centroid."""
    centroid = mesh.verts.mean(axis=0)
    # Build an orthonormal local frame: Z up along ECEF radial
    up = centroid / np.linalg.norm(centroid)
    east = np.cross([0, 0, 1], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    l2e = np.eye(4)
    l2e[:3, 0], l2e[:3, 1], l2e[:3, 2] = east, north, up
    l2e[:3, 3] = centroid
    c2ws = []
    for k in range(n_cams):
        c2w = nadir_camera(40.0, focal, sensor)
        c2w[0, 3] += k * 2.0
        c2w[2, 3] = 25.0
        c2ws.append(c2w)
    return CameraSet(
        c2ws,
        {0: {"f": focal, "cx": 0.0, "cy": 0.0, "image_width": sensor,
             "image_height": sensor}},
        local_to_epsg_4978_transform=l2e,
    )


def test_crs_internal_frame_is_ecef():
    mesh, _ = make_geo_mesh()
    assert mesh.CRS == 4978
    # ECEF magnitudes ~ earth radius
    r = np.linalg.norm(mesh.verts, axis=1)
    assert np.all((6.3e6 < r) & (r < 6.5e6))
    # Roundtrip back to UTM preserves the grid span
    utm = mesh.get_vertices_in_CRS(SITE_UTM)
    assert np.isclose(utm[:, 0].max() - utm[:, 0].min(), 40.0, atol=1e-3)


def test_roi_crop():
    mesh, (e0, n0) = make_geo_mesh(n=21, size=40.0)
    n_before = mesh.n_faces
    roi = Polygon(
        np.array(
            [[e0 - 10, n0 - 10], [e0 + 10, n0 - 10],
             [e0 + 10, n0 + 10], [e0 - 10, n0 + 10]]
        )
    )
    sub, _ = mesh.select_mesh_ROI(
        VectorData([roi], epsg=SITE_UTM), inplace=False
    )
    assert 0 < sub.n_faces < n_before
    utm = sub.get_vertices_in_CRS(SITE_UTM)
    assert utm[:, 0].max() <= e0 + 10 + 1e-6


def test_texture_alignment_and_conversion():
    mesh, _ = make_geo_mesh(n=5)
    vt = np.arange(mesh.n_verts, dtype=float) % 3
    mesh.set_texture(vt)
    assert mesh.vertex_texture is not None
    ft = mesh.get_texture(request_vertex_texture=False)
    assert ft.shape == (mesh.n_faces, 1)
    finite = ft[np.isfinite(ft)]
    assert set(np.unique(finite)).issubset({0.0, 1.0, 2.0})

    # continuous conversion = mean
    mesh.set_texture(np.linspace(0, 1.77, mesh.n_verts))
    ft = mesh.get_texture(request_vertex_texture=False)
    assert np.isfinite(ft).all()


def test_downsample_transfers_texture():
    mesh, _ = make_geo_mesh(n=21)
    mesh.set_texture(np.zeros(mesh.n_verts))
    small = mesh.downsample(0.3)
    assert small.n_faces < mesh.n_faces
    assert small.vertex_texture.shape[0] == small.n_verts


def test_render_and_aggregate_round_trip_local_frame():
    """Labels -> rendered masks -> aggregate -> argmax recovers labels,
    through the full TexturedMesh + CameraSet stack with a nontrivial
    local->ECEF transform."""
    mesh, _ = make_geo_mesh(n=15, size=40.0)
    cams = local_camera_set(mesh, n_cams=3)
    rng = np.random.default_rng(0)
    face_labels = rng.integers(0, 4, mesh.n_faces).astype(float)
    mesh.set_texture(face_labels, is_vertex=False)

    renders = list(mesh.render_flat(cams))
    assert renders[0].shape == (100, 100, 1)
    hit = np.isfinite(renders[0][..., 0])
    assert hit.mean() > 0.5

    # aggregate those renders back via a LookUp-style segmentor camera set
    from geograypher_tpu.predictors.segmentors import ArraySegmentor
    from geograypher_tpu.cameras.segmentor_set import SegmentorCameraSet

    seg = ArraySegmentor([r[..., 0] for r in renders], num_classes=4)
    seg_cams = SegmentorCameraSet(cams, seg)
    avg, info = mesh.aggregate_projected_images(seg_cams)
    assert avg.shape == (mesh.n_faces, 4)
    observed = info["projection_counts"] > 0
    pred = np.argmax(avg, axis=1).astype(float)
    assert (pred[observed] == face_labels[observed]).mean() > 0.99


def test_aggregate_projected_images_planned_routing():
    """use_planned=True must serve the reference-shaped API through the
    planned weighted path and agree with the streaming loop; 'auto' on a
    tiny survey must stay streaming (below the amortization threshold)."""
    mesh, _ = make_geo_mesh(n=15, size=40.0)
    cams = local_camera_set(mesh, n_cams=3)
    rng = np.random.default_rng(1)
    face_labels = rng.integers(0, 4, mesh.n_faces).astype(float)
    mesh.set_texture(face_labels, is_vertex=False)
    renders = list(mesh.render_flat(cams))

    from geograypher_tpu.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu.predictors.segmentors import ArraySegmentor

    seg = ArraySegmentor([r[..., 0] for r in renders], num_classes=4)
    seg_cams = SegmentorCameraSet(cams, seg)
    avg_s, info_s = mesh.aggregate_projected_images(
        seg_cams, use_planned=False
    )
    avg_p, info_p = mesh.aggregate_projected_images(
        seg_cams, use_planned=True
    )
    assert "plan" in info_p  # proves the planned path actually served it
    np.testing.assert_array_equal(
        info_p["projection_counts"], info_s["projection_counts"]
    )
    np.testing.assert_allclose(
        info_p["summed_projections"], info_s["summed_projections"],
        rtol=1e-5, atol=1e-6,
    )
    seen = info_s["projection_counts"] > 0
    np.testing.assert_allclose(
        avg_p[seen], avg_s[seen], rtol=1e-5, atol=1e-6
    )
    assert np.isnan(avg_p[~seen]).all()
    # auto on a tiny survey: streaming (no plan in additional info)
    _avg_a, info_a = mesh.aggregate_projected_images(seg_cams)
    assert "plan" not in info_a
    # strict routing reports the reason when it cannot serve the call
    with pytest.raises(ValueError, match="cannot serve"):
        mesh.aggregate_projected_images(
            seg_cams, use_planned=True, check_null_image=True
        )


def test_export_face_labels_vector(tmp_path):
    mesh, (e0, n0) = make_geo_mesh(n=11, size=40.0)
    labels = np.zeros(mesh.n_faces)
    # label the faces in the +x half as class 1 (in UTM frame)
    utm = mesh.get_vertices_in_CRS(SITE_UTM)
    face_cx = utm[mesh.faces][:, :, 0].mean(axis=1)
    labels[face_cx > e0] = 1.0
    out_file = tmp_path / "labels.geojson"
    vd = mesh.export_face_labels_vector(
        labels, export_file=out_file, resolution_m=0.5
    )
    assert len(vd) >= 2
    assert set(vd["class_ID"]) == {0, 1}
    doc = json.loads(out_file.read_text())
    assert doc["type"] == "FeatureCollection"
    # class-1 polygons live in the +x half
    read_back = VectorData.read_file(out_file)
    for g, cid in zip(read_back.geometries, read_back["class_ID"]):
        cx, _ = g.centroid
        assert (cx > e0) == (cid == 1)


def test_label_polygons():
    mesh, (e0, n0) = make_geo_mesh(n=11, size=40.0)
    utm = mesh.get_vertices_in_CRS(SITE_UTM)
    face_cx = utm[mesh.faces][:, :, 0].mean(axis=1)
    labels = np.where(face_cx > e0, 1.0, 0.0)
    mesh.IDs_to_labels = {0: "left", 1: "right"}
    polys = VectorData(
        [
            Polygon(np.array([[e0 - 15, n0 - 5], [e0 - 5, n0 - 5],
                              [e0 - 5, n0 + 5], [e0 - 15, n0 + 5]])),
            Polygon(np.array([[e0 + 5, n0 - 5], [e0 + 15, n0 - 5],
                              [e0 + 15, n0 + 5], [e0 + 5, n0 + 5]])),
        ],
        epsg=SITE_UTM,
    )
    out = mesh.label_polygons(labels, polys, resolution_m=0.5)
    assert out == ["left", "right"]


def test_height_above_ground_and_ground_label(tmp_path):
    from geograypher_tpu.utils.raster import Raster, write_geotiff

    mesh, (e0, n0) = make_geo_mesh(n=9, size=40.0, z0=100.0)
    # DTM at constant 99m over the site in UTM coords
    dtm = Raster(
        data=np.full((50, 50), 99.0, np.float32),
        transform=(2.0, 0.0, e0 - 50.0, 0.0, -2.0, n0 + 50.0),
        epsg=SITE_UTM,
    )
    path = tmp_path / "dtm.tif"
    write_geotiff(path, dtm)
    hag = mesh.get_height_above_ground(path)
    # mesh z=100 in UTM; UTM alt carries through -> ~1m above the 99m DTM
    assert np.allclose(hag, 1.0, atol=0.2)

    mesh.set_texture(np.zeros(mesh.n_verts))
    tex, gid = mesh.label_ground_class(path, height_above_ground_threshold=2.0)
    assert gid == 1
    assert (tex[:, 0] == gid).all()


def test_save_and_reload_mesh(tmp_path):
    mesh, _ = make_geo_mesh(n=7)
    mesh.set_texture(np.arange(mesh.n_verts) % 2 * 255.0)
    p = tmp_path / "mesh.ply"
    mesh.save_mesh(p)
    re = TexturedMesh(p, CRS=4978, raster_config=CFG)
    assert re.n_verts == mesh.n_verts
    assert re.n_faces == mesh.n_faces
    assert np.allclose(re.verts, mesh.verts, atol=1e-9)
    assert re.vertex_texture is not None  # colors round-tripped


def test_pix2face_cache(tmp_path):
    mesh, _ = make_geo_mesh(n=9)
    cams = local_camera_set(mesh, n_cams=1, sensor=64, focal=32.0)
    a = mesh.pix2face(cams, save_to_cache=True, cache_folder=tmp_path)
    files = list(tmp_path.glob("pix2face_*"))
    assert len(files) == 1
    # second call loads from cache (same content)
    b = mesh.pix2face(cams, save_to_cache=True, cache_folder=tmp_path)
    assert (a == b).all()
    # corrupt entry -> cleared and recomputed
    files[0].write_bytes(b"garbage")
    c = mesh.pix2face(cams, save_to_cache=True, cache_folder=tmp_path)
    assert (a == c).all()


def test_verts_vector_and_area_ratios():
    mesh, (e0, n0) = make_geo_mesh(n=5)
    vd = mesh.get_verts_vector()
    assert len(vd) == mesh.n_verts
    assert vd.epsg == SITE_UTM
    pts = np.stack(vd.geometries)
    assert abs(pts[:, 0].mean() - e0) < 1.0

    # flat mesh -> ratio ~1 everywhere
    ratios = mesh.get_face_area_ratios()
    assert ratios.shape == (mesh.n_faces,)
    assert np.allclose(ratios, 1.0, atol=1e-3)

    # a steep mesh has lower ratios
    verts, faces = make_grid_mesh(n=5, size=10.0, z_fn=lambda x, y: 3 * x)
    steep = TexturedMesh((verts, faces), raster_config=CFG)
    steep_ratios = steep.get_face_area_ratios()
    assert (steep_ratios < 0.5).all()


def test_check_raster_capacity():
    mesh, _ = make_geo_mesh(n=15)
    cams = local_camera_set(mesh, n_cams=1, sensor=64, focal=32.0)
    assert mesh.check_raster_capacity(cams) == 0
    # absurdly small caps must report overflow
    tiny = RasterConfig(caps=(8, 8, 8, 8))
    assert mesh.check_raster_capacity(cams, config=tiny) > 0


def _assert_ortho_georef(mesh, crs, resolution_m, max_pixels=8192):
    """Every rendered pixel's CRS coordinate (via bounds) must match the
    hit face's true centroid to within a couple of ground pixels."""
    p2f, bounds, out_crs = mesh.ortho_pix2face(
        resolution_m=resolution_m, max_pixels=max_pixels
    )
    assert out_crs == crs
    h, w = p2f.shape
    x0, y0, x1, y1 = bounds
    res_x = (x1 - x0) / w
    res_y = (y1 - y0) / h
    assert np.isclose(res_x, res_y, rtol=1e-6)  # square ground pixels
    utm = mesh.get_vertices_in_CRS(crs)
    face_c = utm[mesh.faces].mean(axis=1)
    ii, jj = np.nonzero(p2f >= 0)
    sel = slice(None, None, max(1, len(ii) // 500))
    ii, jj = ii[sel], jj[sel]
    fid = p2f[ii, jj]
    px = x0 + (jj + 0.5) * res_x
    py = y1 - (ii + 0.5) * res_y  # row 0 = top = max y
    err = np.hypot(px - face_c[fid, 0], py - face_c[fid, 1])
    # face centroid lies within ~1 face diagonal of any covered pixel
    face_diag = np.sqrt(2) * (utm[:, 0].max() - utm[:, 0].min()) / 10
    assert err.max() < face_diag + 2 * res_x, err.max()


def test_ortho_pix2face_georeferencing_nonsquare():
    """Non-square footprint: bounds must match the rendered footprint on
    both axes (regression: per-axis res scaling misgeoreferenced by up to
    half the span difference)."""
    mesh, _ = make_geo_mesh(n=11, size=40.0)
    # stretch x4 in easting -> strongly non-square 160 x 40 m footprint
    utm = mesh.get_vertices_in_CRS(SITE_UTM)
    cx = utm[:, 0].mean()
    utm[:, 0] = cx + (utm[:, 0] - cx) * 4.0
    mesh2 = TexturedMesh((utm, mesh.faces), CRS=SITE_UTM, raster_config=CFG)
    _assert_ortho_georef(mesh2, SITE_UTM, resolution_m=0.5)


def test_ortho_pix2face_max_pixels_clamp_keeps_georef():
    """When max_pixels degrades the resolution, bounds must still be the
    exact rendered footprint (and a warning is logged)."""
    mesh, _ = make_geo_mesh(n=11, size=40.0)
    _assert_ortho_georef(mesh, SITE_UTM, resolution_m=0.05, max_pixels=256)


def test_load_texture_from_named_mesh_scalar(tmp_path):
    """load_texture('<scalar name>') pulls a per-vertex property stored in
    the mesh file (reference meshes.py:589-596 pyvista scalar branch)."""
    import struct

    from geograypher_tpu.meshes.mesh import TexturedMesh

    verts, faces = make_grid_mesh(n=5, size=2.0)
    labels = (np.arange(len(verts)) % 3).astype(np.float32)
    # ascii PLY with an extra per-vertex property
    lines = [
        "ply", "format ascii 1.0",
        f"element vertex {len(verts)}",
        "property float x", "property float y", "property float z",
        "property float treeclass",
        f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header",
    ]
    for v, c in zip(verts, labels):
        lines.append(f"{v[0]} {v[1]} {v[2]} {c}")
    for f in faces:
        lines.append(f"3 {f[0]} {f[1]} {f[2]}")
    ply = tmp_path / "scalar.ply"
    ply.write_text("\n".join(lines) + "\n")

    mesh = TexturedMesh(ply, texture="treeclass")
    tex = mesh.get_texture(request_vertex_texture=True)
    assert np.allclose(tex[:, 0], labels)


def test_spatial_sort_faces_morton_locality():
    """Morton reorder permutes faces + per-face texture consistently and
    improves id locality for tile-band aggregation windows."""
    from geograypher_tpu.meshes.mesh import TexturedMesh

    rng = np.random.default_rng(0)
    verts, faces = make_grid_mesh(n=21, size=4.0)
    # scramble face order to simulate an incoherent mesh file
    perm = rng.permutation(len(faces))
    mesh = TexturedMesh((verts, faces[perm]))
    tex = rng.integers(0, 9, (mesh.n_faces, 1)).astype(float)
    mesh.set_texture(tex, is_vertex=False)

    centroids_before = {
        tuple(np.round(verts[f].mean(axis=0), 6)): float(t)
        for f, t in zip(mesh.faces, tex[:, 0])
    }
    order = mesh.spatial_sort_faces()
    assert sorted(order) == list(range(mesh.n_faces))
    tex_after = mesh.get_texture(request_vertex_texture=False)
    # texture still attached to the same physical triangle
    for f, t in zip(mesh.faces, tex_after[:, 0]):
        key = tuple(np.round(verts[f].mean(axis=0), 6))
        assert centroids_before[key] == float(t)

    # locality: consecutive faces are spatial neighbors on average
    cent = verts[mesh.faces].mean(axis=1)
    step = np.linalg.norm(np.diff(cent[:, :2], axis=0), axis=1)
    cell = 4.0 / 20
    assert np.median(step) < 2 * cell


def test_aggregate_class_counts_match_per_channel_path():
    """The class-count route for one-hot segmentor images (one segment-sum
    over (face, class) ids per view) must match the general per-channel
    mean path (``project_image_to_faces`` over the one-hot stack)."""
    from geograypher_tpu.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu.ops.aggregate import (
        accumulate_view,
        finalize_aggregation,
        init_aggregation,
        project_image_to_faces,
    )
    from geograypher_tpu.predictors.segmentors import ArraySegmentor

    mesh, _ = make_geo_mesh(n=15, size=40.0)
    cams = local_camera_set(mesh, n_cams=3)
    rng = np.random.default_rng(3)
    face_labels = rng.integers(0, 4, mesh.n_faces).astype(float)
    mesh.set_texture(face_labels, is_vertex=False)
    renders = list(mesh.render_flat(cams))
    seg = ArraySegmentor([r[..., 0] for r in renders], num_classes=4)
    seg_cams = SegmentorCameraSet(cams, seg)

    avg_cls, info_cls = mesh.aggregate_projected_images(seg_cams)

    state = init_aggregation(mesh.n_faces, 4)
    for i in range(len(cams)):
        p2f = mesh.pix2face(cams, [i])[0]
        img = np.asarray(seg_cams.get_image_by_index(i), np.float32)
        sums, counts = project_image_to_faces(p2f, img, mesh.n_faces)
        state = accumulate_view(state, sums, counts)
    avg_ch = np.asarray(finalize_aggregation(state))

    np.testing.assert_array_equal(
        info_cls["projection_counts"], np.asarray(state.view_count)
    )
    assert np.allclose(avg_cls, avg_ch, atol=1e-5, equal_nan=True)
    observed = info_cls["projection_counts"] > 0
    pred = np.argmax(avg_cls, axis=1).astype(float)
    assert (pred[observed] == face_labels[observed]).mean() > 0.99


def test_ortho_pix2face_tiling_matches_single_shot():
    """Auto-tiled ortho rendering (max_pixels smaller than the footprint)
    must reproduce the single-shot map at the SAME resolution — tiling
    must never degrade resolution (only max_total_pixels may, loudly)."""
    mesh, _ = make_geo_mesh(n=15, size=40.0)
    # a resolution that does NOT divide the footprint exactly: otherwise
    # the mesh boundary passes exactly through edge-pixel centers, whose
    # inclusive coverage flips on ~1e-7 arithmetic noise in either path
    res = 0.43
    a, bounds_a, crs_a = mesh.ortho_pix2face(resolution_m=res)
    b, bounds_b, crs_b = mesh.ortho_pix2face(resolution_m=res, max_pixels=48)
    assert a.shape == b.shape and a.shape[0] > 48
    assert bounds_a == bounds_b and crs_a == crs_b
    # knife-edge pixels may flip between the per-tile cameras' slightly
    # different (still ~0.06%-error) perspective centers
    agree = a == b
    assert agree.mean() > 0.995
    if (~agree).any():
        assert ((a[~agree] >= 0) == (b[~agree] >= 0)).mean() > 0.9


def test_export_face_labels_subresolution_feature():
    """A single-cell labeled feature (reference GEOS would union it
    exactly: utils/geometric.py:13) survives vector export at fine
    resolution with the analytically-correct area."""
    mesh, (e0, n0) = make_geo_mesh(n=15, size=40.0)
    cell = 40.0 / 14.0  # grid step in meters
    labels = np.zeros(mesh.n_faces)
    # faces 2*k and 2*k+1 are the two triangles of one grid cell
    cell_idx = 3 * 14 + 5
    labels[2 * cell_idx] = 1.0
    labels[2 * cell_idx + 1] = 1.0
    mesh.set_texture(labels, is_vertex=False)
    out = mesh.export_face_labels_vector(resolution_m=cell / 8.0)
    ids = np.asarray(out.attributes["class_ID"])
    areas = np.array([p.area for p in out.geometries])
    got = areas[ids == 1].sum()
    assert abs(got - cell * cell) < 0.2 * cell * cell


def test_export_exact_vs_raster_parity():
    """Exact (mesh-edge) and raster-assisted vector exports agree on
    per-class area to raster tolerance; exact areas match the summed
    face areas to float precision."""
    mesh, (e0, n0) = make_geo_mesh(n=11, size=40.0)
    utm = mesh.get_vertices_in_CRS(SITE_UTM)
    face_cx = utm[mesh.faces][:, :, 0].mean(axis=1)
    labels = np.where(face_cx > e0, 1.0, 0.0)
    exact = mesh.export_face_labels_vector(labels, mode="exact")
    raster = mesh.export_face_labels_vector(
        labels, mode="raster", resolution_m=0.25
    )
    tris = utm[mesh.faces][:, :, :2]
    tri_area = 0.5 * np.abs(
        (tris[:, 1, 0] - tris[:, 0, 0]) * (tris[:, 2, 1] - tris[:, 0, 1])
        - (tris[:, 2, 0] - tris[:, 0, 0]) * (tris[:, 1, 1] - tris[:, 0, 1])
    )
    for cls in (0, 1):
        a_exact = sum(
            g.area
            for g, c in zip(exact.geometries, exact["class_ID"])
            if c == cls
        )
        a_raster = sum(
            g.area
            for g, c in zip(raster.geometries, raster["class_ID"])
            if c == cls
        )
        want = tri_area[labels == cls].sum()
        assert abs(a_exact - want) < 1e-6 * want
        assert abs(a_raster - want) < 0.05 * want


def test_label_polygons_exact_mode():
    mesh, (e0, n0) = make_geo_mesh(n=11, size=40.0)
    utm = mesh.get_vertices_in_CRS(SITE_UTM)
    face_cx = utm[mesh.faces][:, :, 0].mean(axis=1)
    labels = np.where(face_cx > e0, 1.0, 0.0)
    mesh.IDs_to_labels = {0: "left", 1: "right"}
    # a polygon straddling the split: 70% right of it -> "right"; plus a
    # NARROW sliver (0.1 m wide, far below any raster resolution) fully
    # on the left that the raster path could not resolve
    polys = VectorData(
        [
            Polygon(np.array([[e0 - 3, n0 - 5], [e0 + 7, n0 - 5],
                              [e0 + 7, n0 + 5], [e0 - 3, n0 + 5]])),
            Polygon(np.array([[e0 - 6.0, n0 - 5], [e0 - 5.9, n0 - 5],
                              [e0 - 5.9, n0 + 5], [e0 - 6.0, n0 + 5]])),
        ],
        epsg=SITE_UTM,
    )
    out = mesh.label_polygons(labels, polys, mode="exact")
    assert out == ["right", "left"]


def test_remap_texture_string_labels():
    """String labels resolve through IDs_to_labels (textures are stored
    numerically, so direct string comparison can never match — review
    regression)."""
    verts, faces = make_grid_mesh(n=5, size=4.0)
    mesh = TexturedMesh((verts, faces), raster_config=CFG)
    tex = np.zeros(mesh.n_faces)
    tex[: mesh.n_faces // 2] = 1.0
    mesh.set_texture(tex, is_vertex=False)
    mesh.IDs_to_labels = {0: "ground", 1: "tree"}
    mesh.remap_texture({"tree": 7, "ground": 3})
    out = mesh.get_texture(request_vertex_texture=False)
    out = np.asarray(out).reshape(-1)
    assert set(np.unique(out[np.isfinite(out)])) == {3.0, 7.0}
    assert (out[: mesh.n_faces // 2] == 7.0).all()
    assert mesh.IDs_to_labels == {7: "tree", 3: "ground"}
    # numeric keys still match texture values directly
    mesh.remap_texture({7: 1, 3: 0})
    out2 = np.asarray(
        mesh.get_texture(request_vertex_texture=False)
    ).reshape(-1)
    assert (out2[: mesh.n_faces // 2] == 1.0).all()


def test_geometry_edit_invalidates_soa_cache():
    """project_images after an in-place geometry edit must use the NEW
    triangles (review regression: only _tri_verts_cache was cleared)."""
    from tests.test_mesh import local_camera_set  # self-import for clarity

    mesh, _ = make_geo_mesh(n=9)
    cams = local_camera_set(mesh)
    # populate the SOA cache through the fused path
    p_before = mesh.pix2face(cams, [0])[0]
    _ = mesh._tri_soa_device(cams)
    assert mesh._tri_soa_cache
    order = mesh.spatial_sort_faces()
    assert not mesh._tri_soa_cache  # cleared by the edit
    p_after = mesh.pix2face(cams, [0])[0]
    # same geometry, permuted face ids: the map must follow the new order
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    expect = np.where(p_before >= 0, inv[np.clip(p_before, 0, None)], -1)
    assert np.array_equal(p_after, expect)
