"""Synthetic survey generator for end-to-end tests and examples.

Plays the role of the reference's ``create_scene_mesh`` + example data
(utils/example_data.py:9-112): produces a complete fake Metashape export —
a georeferenced scene mesh (PLY), a camera XML with a chunk->ECEF
component transform, per-camera label images, and ground-truth geospatial
label polygons — so every entrypoint can run hermetically.
"""

from __future__ import annotations

import textwrap
from pathlib import Path
from typing import Optional

import numpy as np

from geograypher_tpu.utils import crs as crs_utils
from geograypher_tpu.utils.fixtures import make_scene_mesh, nadir_camera


def local_to_ecef_frame(lat: float, lon: float, alt: float = 0.0) -> np.ndarray:
    """4x4 local ENU frame -> ECEF at the given origin."""
    x, y, z = crs_utils.lla_to_ecef(lat, lon, alt)
    origin = np.array([float(x), float(y), float(z)])
    up = origin / np.linalg.norm(origin)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    t = np.eye(4)
    t[:3, 0], t[:3, 1], t[:3, 2] = east, north, up
    t[:3, 3] = origin
    return t


def make_metashape_xml(
    cam_to_worlds,
    image_names,
    local_to_ecef: np.ndarray,
    f,
    width: int,
    height: int,
    cx: float = 0.0,
    cy: float = 0.0,
    distortion: Optional[dict] = None,
    sensor_ids=None,
) -> str:
    """Serialize cameras into the Metashape XML schema the parser reads.

    ``f`` is one focal length, or a sequence of them — one sensor each —
    with ``sensor_ids`` giving every camera's index into it.
    """
    focals = np.atleast_1d(np.asarray(f, np.float64))
    if sensor_ids is None:
        sensor_ids = [0] * len(image_names)
    dist_tags = "".join(
        f"<{k}>{v}</{k}>" for k, v in (distortion or {}).items()
    )
    sensors = "\n".join(
        f'<sensor id="{si}" label="synthetic{si}" type="frame">'
        f'<resolution width="{width}" height="{height}"/>'
        f'<calibration type="frame" class="adjusted">'
        f'<resolution width="{width}" height="{height}"/>'
        f"<f>{fi:.17g}</f><cx>{cx}</cx><cy>{cy}</cy>{dist_tags}"
        f"</calibration></sensor>"
        for si, fi in enumerate(focals)
    )
    cams = "\n".join(
        f'<camera id="{i}" sensor_id="{si}" label="{name}">'
        f'<transform>{" ".join(f"{float(v):.17g}" for v in np.asarray(t).flatten())}'
        f"</transform></camera>"
        for i, (t, name, si) in enumerate(
            zip(cam_to_worlds, image_names, sensor_ids)
        )
    )
    rot = " ".join(f"{float(v):.17g}" for v in local_to_ecef[:3, :3].flatten())
    tra = " ".join(f"{float(v):.17g}" for v in local_to_ecef[:3, 3])
    return textwrap.dedent(
        f"""\
        <document version="2.0.0">
          <chunk label="Chunk 1" enabled="true">
            <sensors next_id="{len(focals)}">
              {sensors}
            </sensors>
            <cameras next_id="{len(image_names)}" next_group_id="0">
              {cams}
            </cameras>
            <components next_id="1" active_id="0">
              <component id="0" label="Component 1">
                <transform>
                  <rotation locked="true">{rot}</rotation>
                  <translation locked="true">{tra}</translation>
                  <scale locked="true">1.0</scale>
                </transform>
              </component>
            </components>
          </chunk>
        </document>"""
    )


def create_example_survey(
    output_folder,
    n_cameras: int = 4,
    sensor: int = 96,
    focal: float = 48.0,
    scene_size: float = 40.0,
    n_objects: int = 3,
    lat: float = 36.0,
    lon: float = -119.0,
    seed: int = 0,
    write_label_images: bool = True,
):
    """Write a full synthetic survey to disk.

    Returns a dict of paths + ground-truth arrays:
    mesh_file, cameras_file, image_folder, label_folder, face_labels,
    labels_vector_file, dtm_file, local_to_ecef.
    """
    import cv2

    from geograypher_tpu.utils.meshio import save_mesh
    from geograypher_tpu.utils.raster import Raster, write_geotiff
    from geograypher_tpu.utils.vector import Polygon, VectorData

    output_folder = Path(output_folder)
    (output_folder / "images").mkdir(parents=True, exist_ok=True)
    (output_folder / "labels").mkdir(parents=True, exist_ok=True)

    verts, faces, face_labels, centers = make_scene_mesh(
        n_objects=n_objects, ground_n=21, size=scene_size, seed=seed
    )
    l2e = local_to_ecef_frame(lat, lon)

    # cameras: nadir grid pass over the scene
    height = scene_size * focal / sensor
    cam_to_worlds = []
    names = []
    for k in range(n_cameras):
        c2w = nadir_camera(scene_size, focal, sensor)
        c2w[0, 3] = (k % 2) * scene_size * 0.2 - scene_size * 0.1
        c2w[1, 3] = (k // 2) * scene_size * 0.2 - scene_size * 0.1
        cam_to_worlds.append(c2w)
        names.append(f"img_{k:04d}.png")

    xml = make_metashape_xml(
        cam_to_worlds, names, l2e, focal, sensor, sensor
    )
    cameras_file = output_folder / "cameras.xml"
    cameras_file.write_text(xml)

    # The PLY is saved in the LOCAL chunk frame, exactly like a Metashape
    # mesh export: consumers apply the camera XML's component transform
    # (local -> ECEF) when loading.
    mesh_file = output_folder / "mesh.ply"
    save_mesh(mesh_file, verts, faces)

    # per-camera label images: render ground-truth labels with the engine
    if write_label_images:
        hom = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
        verts_ecef = (l2e @ hom.T).T[:, :3]
        from geograypher_tpu.cameras.metashape import MetashapeCameraSet
        from geograypher_tpu.meshes.mesh import TexturedMesh
        from geograypher_tpu.ops.rasterize import RasterConfig

        cams = MetashapeCameraSet(cameras_file, output_folder / "images")
        mesh = TexturedMesh(
            (verts_ecef, faces),
            CRS=4978,
            raster_config=RasterConfig(caps=(512, 64, 32, 16)),
            local_to_epsg_4978_transform=l2e,
        )
        mesh.set_texture(face_labels.astype(float), is_vertex=False)
        for i, img in enumerate(mesh.render_flat(cams)):
            lab = np.where(np.isfinite(img[..., 0]), img[..., 0], 255)
            cv2.imwrite(
                str(output_folder / "labels" / f"img_{i:04d}.png"),
                lab.astype(np.uint8),
            )
            cv2.imwrite(
                str(output_folder / "images" / f"img_{i:04d}.png"),
                np.full((sensor, sensor, 3), 127, np.uint8),
            )

    # ground-truth object polygons in UTM
    utm = crs_utils.utm_epsg_for(lat, lon)
    origin_utm = crs_utils.transform_points(
        np.array([[lat, lon, 0.0]]), 4326, utm
    )[0]
    polys, labels = [], []
    for k, (cx_, cy_, h, half) in enumerate(centers):
        polys.append(
            Polygon(
                np.array(
                    [
                        [origin_utm[0] + cx_ - half, origin_utm[1] + cy_ - half],
                        [origin_utm[0] + cx_ + half, origin_utm[1] + cy_ - half],
                        [origin_utm[0] + cx_ + half, origin_utm[1] + cy_ + half],
                        [origin_utm[0] + cx_ - half, origin_utm[1] + cy_ + half],
                    ]
                )
            )
        )
        labels.append(f"object_{k + 1}")
    labels_vector_file = output_folder / "labels.geojson"
    VectorData(polys, {"species": labels}, epsg=utm).to_file(labels_vector_file)

    # flat DTM at ~0 elevation over the site
    dtm_file = output_folder / "dtm.tif"
    write_geotiff(
        dtm_file,
        Raster(
            data=np.zeros((64, 64), np.float32),
            transform=(
                2 * scene_size / 64, 0.0, origin_utm[0] - scene_size,
                0.0, -2 * scene_size / 64, origin_utm[1] + scene_size,
            ),
            epsg=utm,
        ),
    )

    return {
        "mesh_file": mesh_file,
        "cameras_file": cameras_file,
        "image_folder": output_folder / "images",
        "label_folder": output_folder / "labels",
        "labels_vector_file": labels_vector_file,
        "dtm_file": dtm_file,
        "face_labels": face_labels,
        "local_to_ecef": l2e,
        "n_classes": n_objects + 1,
        "utm_epsg": utm,
    }


# Rig orientations matching the reference's under-canopy workflow
# (/root/reference/examples/undercanopy_painting.ipynb): four horizontal
# yaw quadrants plus straight up / straight down, together covering the
# full 360-degree sphere of the original equirectangular capture.
UNDERCANOPY_RIG_ORIENTATIONS = [
    {"yaw_deg": 0.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 90.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 180.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 270.0, "pitch_deg": 0.0, "roll_deg": 0.0},
    {"yaw_deg": 0.0, "pitch_deg": -90.0, "roll_deg": 0.0},
    {"yaw_deg": 0.0, "pitch_deg": 90.0, "roll_deg": 0.0},
]
UNDERCANOPY_FORMAT_STR = "_yaw{yaw_deg:03.0f}_pitch{pitch_deg:03.0f}"


def create_undercanopy_survey(
    output_folder,
    n_stations: int = 3,
    sensor: int = 128,
    scene_size: float = 20.0,
    n_objects: int = 4,
    station_height: float = 1.6,
    pano_size: tuple = (128, 256),
    lat: float = 36.0,
    lon: float = -119.0,
    seed: int = 0,
):
    """Write a synthetic under-canopy 360-capture survey to disk.

    Mirrors the data layout of the reference's under-canopy example
    (/root/reference/examples/undercanopy_painting.ipynb): ground-level
    equirectangular captures between canopy objects, perspective
    re-projections of each panorama (the "raw" image folder), and a
    parallel folder of per-pixel class predictions for those perspective
    images.  Here the predictions are OCCLUSION-CORRECT renders of the
    known per-face labels through the rig camera set, so an aggregation
    run can be checked against ground truth exactly.

    Returns a dict of paths + ground truth: cameras_file, mesh_file,
    equirect_folder, perspective_folder, prediction_folder, rig_camera,
    rig_orientations, format_str, face_labels, n_classes, local_to_ecef.
    """
    import cv2

    from geograypher_tpu.utils.image import perspective_from_equirectangular
    from geograypher_tpu.utils.meshio import save_mesh

    output_folder = Path(output_folder)
    equirect_folder = output_folder / "equirect"
    perspective_folder = output_folder / "images-reprojected"
    prediction_folder = output_folder / "predictions"
    for f in (equirect_folder, perspective_folder, prediction_folder):
        f.mkdir(parents=True, exist_ok=True)

    verts, faces, face_labels, centers = make_scene_mesh(
        n_objects=n_objects, ground_n=21, size=scene_size, seed=seed
    )
    l2e = local_to_ecef_frame(lat, lon)

    # ground-level stations on a walking line through the scene, nudged
    # off any canopy-object footprint (cameras must stand BESIDE objects,
    # not inside them)
    xs = np.linspace(-scene_size / 4, scene_size / 4, n_stations)
    stations = []
    for x in xs:
        pos = np.array([x, 0.0, station_height])
        for _ in range(20):
            clear = all(
                max(abs(pos[0] - cx_), abs(pos[1] - cy_)) > half + 0.7
                for cx_, cy_, _h, half in centers
            )
            if clear:
                break
            pos[1] += 0.9
        stations.append(pos.copy())

    # base 360-camera pose: upright, forward = +x (east); camera frame is
    # x right, y down, z forward, so x_cam=-north, y_cam=-up, z_cam=east
    base_rot = np.eye(4)
    base_rot[:3, 0] = [0.0, -1.0, 0.0]
    base_rot[:3, 1] = [0.0, 0.0, -1.0]
    base_rot[:3, 2] = [1.0, 0.0, 0.0]
    c2ws, names = [], []
    for k, pos in enumerate(stations):
        c2w = base_rot.copy()
        c2w[:3, 3] = pos
        c2ws.append(c2w)
        names.append(f"pano_{k:04d}.png")

    cameras_file = output_folder / "cameras.xml"
    # real Metashape labels are absolute paths to the photogrammetry-time
    # images (reference derived_cameras.py:33-38 rebases them)
    cameras_file.write_text(
        make_metashape_xml(
            c2ws, [str(equirect_folder / n) for n in names], l2e,
            sensor / 2.0, sensor, sensor,
        )
    )
    mesh_file = output_folder / "mesh.ply"
    save_mesh(mesh_file, verts, faces)

    # synthetic equirectangular panoramas (yaw hue x pitch brightness
    # gradient) + their perspective re-projections: the "raw images" an
    # ML model would consume (reference utils/image.py:129-267 path)
    he, we = pano_size
    yy, xx = np.mgrid[0:he, 0:we]
    pano = np.stack(
        [
            (255 * xx / we).astype(np.uint8),
            (255 * yy / he).astype(np.uint8),
            np.full((he, we), 96, np.uint8),
        ],
        axis=-1,
    )
    for k in range(n_stations):
        cv2.imwrite(str(equirect_folder / names[k]), pano)
        for o in UNDERCANOPY_RIG_ORIENTATIONS:
            persp = perspective_from_equirectangular(
                pano, o["roll_deg"], o["pitch_deg"], o["yaw_deg"],
                fov_deg=90.0, out_size=(sensor, sensor),
            )
            out_name = (
                Path(names[k]).stem
                + UNDERCANOPY_FORMAT_STR.format(**o)
                + ".png"
            )
            cv2.imwrite(str(perspective_folder / out_name), persp)

    rig_camera = {
        "f": sensor / 2.0,  # 90-degree horizontal FOV
        "cx": 0.0,
        "cy": 0.0,
        "image_width": sensor,
        "image_height": sensor,
    }

    # occlusion-correct per-pixel "predictions" for every perspective
    # image: render the known face labels through the rig camera set
    from geograypher_tpu.cameras.rig import (
        create_rig_cameras_from_equirectangular,
    )
    from geograypher_tpu.meshes.mesh import TexturedMesh
    from geograypher_tpu.ops.rasterize import RasterConfig

    rig_set = create_rig_cameras_from_equirectangular(
        camera_file=cameras_file,
        original_images=equirect_folder,
        perspective_images=perspective_folder,
        rig_camera=rig_camera,
        rig_orientations=UNDERCANOPY_RIG_ORIENTATIONS,
        perspective_filename_format_str=UNDERCANOPY_FORMAT_STR,
    )
    mesh = TexturedMesh(
        mesh_file,
        transform_filename=cameras_file,
        raster_config=RasterConfig(caps=(1024, 128, 64, 32)),
    )
    mesh.set_texture(face_labels.astype(float), is_vertex=False)
    for cam_idx, img in enumerate(mesh.render_flat(rig_set)):
        lab = np.where(np.isfinite(img[..., 0]), img[..., 0], 255)
        out = prediction_folder / rig_set.image_filenames[cam_idx].name
        cv2.imwrite(str(out), lab.astype(np.uint8))

    return {
        "cameras_file": cameras_file,
        "mesh_file": mesh_file,
        "equirect_folder": equirect_folder,
        "perspective_folder": perspective_folder,
        "prediction_folder": prediction_folder,
        "rig_camera": rig_camera,
        "rig_orientations": list(UNDERCANOPY_RIG_ORIENTATIONS),
        "format_str": UNDERCANOPY_FORMAT_STR,
        "face_labels": face_labels,
        "n_classes": int(face_labels.max()) + 1,
        "local_to_ecef": l2e,
    }


def create_non_overlapping_points(
    n_points: int,
    distance_thresh: float = 1.0,
    size: float = 10.0,
    random_seed: Optional[int] = None,
) -> np.ndarray:
    """Rejection-sample ``n_points`` 2D points at least ``distance_thresh``
    apart inside a ``size x size`` square centered at the origin
    (reference utils/example_data.py:9-21)."""
    rng = np.random.default_rng(random_seed)
    points = (rng.random((1, 2)) - 0.5) * size
    while points.shape[0] < n_points:
        cand = (rng.random((1, 2)) - 0.5) * size
        if np.min(np.linalg.norm(points - cand, axis=1)) > distance_thresh:
            points = np.concatenate([points, cand], axis=0)
    return points


def _cylinder_mesh(center, radius: float, height: float, resolution: int = 10):
    """Closed triangulated cylinder (axis +z, base at z=0)."""
    cx, cy = center
    ang = 2 * np.pi * np.arange(resolution) / resolution
    ring = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], 1)
    bot = np.concatenate([ring, np.zeros((resolution, 1))], axis=1)
    top = np.concatenate([ring, np.full((resolution, 1), height)], axis=1)
    verts = np.concatenate(
        [bot, top, [[cx, cy, 0.0]], [[cx, cy, height]]], axis=0
    )
    cb, ct = 2 * resolution, 2 * resolution + 1
    faces = []
    for i in range(resolution):
        j = (i + 1) % resolution
        faces += [
            (i, j, resolution + i),  # side quad
            (j, resolution + j, resolution + i),
            (cb, j, i),  # bottom cap
            (ct, resolution + i, resolution + j),  # top cap
        ]
    return verts, np.array(faces, dtype=np.int32)


def _cone_mesh(center, radius: float, height: float, resolution: int = 12):
    """Closed triangulated cone (base at z=0, apex at z=height)."""
    cx, cy = center
    ang = 2 * np.pi * np.arange(resolution) / resolution
    ring = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], 1)
    base = np.concatenate([ring, np.zeros((resolution, 1))], axis=1)
    verts = np.concatenate(
        [base, [[cx, cy, 0.0]], [[cx, cy, height]]], axis=0
    )
    cb, apex = resolution, resolution + 1
    faces = []
    for i in range(resolution):
        j = (i + 1) % resolution
        faces += [(i, j, apex), (cb, j, i)]
    return verts, np.array(faces, dtype=np.int32)


def create_scene_mesh(
    box_centers=(),
    cylinder_centers=(),
    cone_centers=(),
    cylinder_radius: float = 0.5,
    cone_radius: float = 0.5,
    box_size: float = 1.0 / np.sqrt(2.0),
    grid_size=(20.0, 20.0),
    add_ground: bool = True,
    ground_resolution: int = 200,
):
    """Procedural concept-figure scene: boxes, cylinders, and cones on an
    optional ground plane (API analog of the reference's
    ``create_scene_mesh``, utils/example_data.py:29-111).

    Returns ``(verts, faces, face_IDs, labels_vd)``: ``face_IDs`` is a
    float per-face instance ID (NaN for ground faces, instances numbered
    across all shapes in box/cylinder/cone order, like the reference),
    and ``labels_vd`` is a :class:`~geograypher_tpu.utils.vector
    .VectorData` of per-instance convex-hull footprint polygons with a
    ``name`` column in {"cube", "cylinder", "cone"}.
    """
    from scipy.spatial import ConvexHull

    from geograypher_tpu.utils.fixtures import _box_mesh, make_grid_mesh
    from geograypher_tpu.utils.vector import Polygon, VectorData

    all_verts, all_faces, all_ids = [], [], []
    polygons, names = [], []
    v_off = 0
    instance = 0.0

    def add(verts, faces, name):
        nonlocal v_off, instance
        all_verts.append(verts)
        all_faces.append(faces + v_off)
        all_ids.append(np.full((faces.shape[0],), instance))
        hull = ConvexHull(verts[:, :2])
        polygons.append(Polygon(verts[hull.vertices, :2]))
        names.append(name)
        v_off += verts.shape[0]
        instance += 1.0

    for x, y in box_centers:
        bv, bf = _box_mesh((x, y, 0.0), box_size / 2.0, box_size)
        add(bv, bf, "cube")
    for x, y in cylinder_centers:
        cv, cf = _cylinder_mesh((x, y), cylinder_radius, 1.0)
        add(cv, cf, "cylinder")
    for x, y in cone_centers:
        cv, cf = _cone_mesh((x, y), cone_radius, 1.0)
        add(cv, cf, "cone")

    if add_ground:
        gx, _gy = grid_size
        gv, gf = make_grid_mesh(n=int(ground_resolution), size=float(gx))
        all_verts.append(gv)
        all_faces.append(gf + v_off)
        all_ids.append(np.full((gf.shape[0],), np.nan))

    verts = np.concatenate(all_verts, axis=0)
    faces = np.concatenate(all_faces, axis=0).astype(np.int32)
    face_ids = np.concatenate(all_ids, axis=0)
    labels_vd = VectorData(polygons, {"name": names})
    return verts, faces, face_ids, labels_vd
