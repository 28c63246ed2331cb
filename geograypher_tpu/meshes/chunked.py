"""Spatially-chunked processing for survey-scale meshes.

Port of the reference's ``TexturedPhotogrammetryMeshChunked``
(/root/reference/geograypher/meshes/derived_meshes.py:23-411): cluster
camera locations with KMeans, extract a buffered sub-mesh per cluster
(tracking original face ids), process each chunk, and scatter-add results
back into full-mesh arrays.

On TPU this is a memory-bound escape hatch, not the primary scale
mechanism — parallel/sharding.py distributes whole views across chips and
keeps the mesh replicated.  Chunking matters when the mesh itself
outgrows HBM (tens of millions of faces), and its camera-cluster ->
sub-mesh decomposition is exactly the sharding strategy a face-sharded
variant would use (SURVEY.md §2.7).
"""

from __future__ import annotations

import logging
import typing

import numpy as np

from geograypher_tpu.cameras.core import CameraSet
from geograypher_tpu.constants import CHUNKED_MESH_BUFFER_DIST_METERS
from geograypher_tpu.meshes.mesh import TexturedMesh
from geograypher_tpu.utils import crs as crs_utils
from geograypher_tpu.utils.vector import Polygon, VectorData

logger = logging.getLogger(__name__)


def _camera_utm_coords(cameras: CameraSet):
    """((N, 2) planar camera coords, epsg-or-None): projected UTM when
    georeferenced, else the local frame — the one shared projection rule
    for clustering and chunk footprints."""
    lon_lats = cameras.get_lon_lat_coords()
    if lon_lats and lon_lats[0] is not None:
        lla = np.array([[ll[1], ll[0], 0.0] for ll in lon_lats])
        utm = crs_utils.utm_epsg_for(lla[0, 0], lla[0, 1])
        return crs_utils.transform_points(lla, 4326, utm)[:, :2], utm
    return cameras.get_camera_locations()[:, :2], None


def cluster_cameras(
    cameras: CameraSet, n_clusters: int, seed: int = 0
) -> typing.List[np.ndarray]:
    """KMeans over camera locations -> per-cluster camera index arrays
    (reference derived_meshes.py:57-77).  Uses projected (UTM) coords when
    georeferenced, else local coords."""
    from sklearn.cluster import KMeans

    pts, _epsg = _camera_utm_coords(cameras)
    n_clusters = min(n_clusters, len(pts))
    km = KMeans(n_clusters=n_clusters, n_init=10, random_state=seed)
    assignments = km.fit_predict(pts)
    return [np.where(assignments == k)[0] for k in range(n_clusters)]


def mesh_chunk_for_cameras(
    mesh: TexturedMesh,
    cameras: CameraSet,
    camera_indices: np.ndarray,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
):
    """Buffered sub-mesh around a camera cluster + original face ids
    (reference derived_meshes.py:110-147)."""
    all_pts, epsg = _camera_utm_coords(cameras)
    pts = all_pts[np.asarray(camera_indices)]
    x0, y0 = pts.min(axis=0) - buffer_meters
    x1, y1 = pts.max(axis=0) + buffer_meters
    hull = Polygon(
        np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    )
    sub, face_mask = mesh.select_mesh_ROI(
        VectorData([hull], epsg=epsg), inplace=False
    )
    face_ids = np.where(face_mask)[0]
    return sub, face_ids


def aggregate_images_chunked(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_clusters: int = 8,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
    aggregate_img_scale: float = 1.0,
    **kwargs,
):
    """Chunked aggregate_projected_images (reference derived_meshes.py:222-317):
    per-cluster sub-mesh aggregation scattered back via face ids."""
    clusters = cluster_cameras(cameras, n_clusters)
    n_faces = mesh.n_faces
    total_sum = None
    total_count = np.zeros(n_faces)
    for k, cam_idx in enumerate(clusters):
        if len(cam_idx) == 0:
            continue
        sub_mesh, face_ids = mesh_chunk_for_cameras(
            mesh, cameras, cam_idx, buffer_meters
        )
        if sub_mesh.n_faces == 0:
            continue
        sub_cams = cameras.get_subset_cameras(cam_idx)
        logger.info(
            "chunk %d: %d cameras, %d faces", k, len(cam_idx), sub_mesh.n_faces
        )
        avg, info = sub_mesh.aggregate_projected_images(
            sub_cams, aggregate_img_scale=aggregate_img_scale, **kwargs
        )
        if total_sum is None:
            total_sum = np.zeros((n_faces, avg.shape[1]))
        # scatter-add the chunk's per-view sums/counts back
        # (derived_meshes.py:292-302)
        counts = info["projection_counts"]
        sums = info["summed_projections"]
        np.add.at(total_sum, face_ids, np.nan_to_num(sums))
        np.add.at(total_count, face_ids, counts)
    if total_sum is None:
        raise ValueError("No chunks produced data")
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = total_sum / total_count[:, None]
    avg[total_count == 0] = np.nan
    return avg, {
        "projection_counts": total_count,
        "summed_projections": total_sum,
    }


def render_flat_chunked(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_cameras_per_chunk: int = 100,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
    **render_kwargs,
):
    """Chunked render generator (reference derived_meshes.py:153-220):
    yields (render, camera) per camera, using a cluster-local sub-mesh."""
    n_clusters = max(len(cameras) // max(n_cameras_per_chunk, 1), 1)
    clusters = cluster_cameras(cameras, n_clusters)
    for cam_idx in clusters:
        if len(cam_idx) == 0:
            continue
        sub_mesh, _ = mesh_chunk_for_cameras(
            mesh, cameras, cam_idx, buffer_meters
        )
        sub_mesh.IDs_to_labels = mesh.IDs_to_labels
        sub_cams = cameras.get_subset_cameras(cam_idx)
        yield from sub_mesh.render_flat(
            sub_cams, return_camera=True, **render_kwargs
        )


def label_polygons_chunked(
    mesh: TexturedMesh,
    face_labels: np.ndarray,
    polygons: VectorData,
    polygons_per_cluster: int = 1000,
    **kwargs,
):
    """Chunked polygon labeling (reference derived_meshes.py:319-411):
    cluster polygons spatially and label each cluster against the mesh."""
    from sklearn.cluster import KMeans

    n = len(polygons)
    n_clusters = max(n // polygons_per_cluster, 1)
    cents = np.array([g.centroid for g in polygons.geometries])
    km = KMeans(n_clusters=n_clusters, n_init=10, random_state=0)
    assign = km.fit_predict(cents)
    out: list = [None] * n
    for k in range(n_clusters):
        idx = np.where(assign == k)[0]
        sub_polys = VectorData(
            [polygons.geometries[i] for i in idx],
            {key: [v[i] for i in idx] for key, v in polygons.attributes.items()},
            epsg=polygons.epsg,
        )
        labels = mesh.label_polygons(face_labels, sub_polys, **kwargs)
        for i, lab in zip(idx, labels):
            out[i] = lab
    return out


def aggregate_class_images_chunked_distributed(
    mesh: TexturedMesh,
    cameras: CameraSet,
    n_classes: int,
    n_clusters: int = 4,
    buffer_meters: float = CHUNKED_MESH_BUFFER_DIST_METERS,
    class_image_provider: typing.Optional[
        typing.Callable[[int], np.ndarray]
    ] = None,
    **pipeline_kwargs,
):
    """Chunked survey aggregation over a DEVICE MESH: each camera
    cluster's buffered sub-mesh runs through the production distributed
    pipeline (``parallel.pipeline.aggregate_class_images_distributed`` —
    sharded views, census-bucketed caps, donated accumulators),
    and per-chunk results scatter-add back into full-mesh arrays via the
    chunk's original face ids — the composition of the reference's
    chunked processing (derived_meshes.py:222-317) with multi-chip view
    sharding.  Returns ``(fraction_sums (F, C), view_counts (F,))``
    exactly like the unchunked pipeline.
    """
    from geograypher_tpu.parallel.pipeline import (
        aggregate_class_images_distributed,
    )

    clusters = cluster_cameras(cameras, n_clusters)
    total_fracs = np.zeros((mesh.n_faces, n_classes))
    total_views = np.zeros(mesh.n_faces)
    produced = False
    for k, cam_idx in enumerate(clusters):
        if len(cam_idx) == 0:
            continue
        sub_mesh, face_ids = mesh_chunk_for_cameras(
            mesh, cameras, cam_idx, buffer_meters
        )
        if sub_mesh.n_faces == 0:
            continue
        sub_cams = cameras.get_subset_cameras(cam_idx)
        logger.info(
            "distributed chunk %d: %d cameras, %d faces",
            k, len(cam_idx), sub_mesh.n_faces,
        )
        provider = None
        if class_image_provider is not None:
            # remap the sub-set's view index back to the survey index
            def provider(j, _idx=np.asarray(cam_idx)):
                return class_image_provider(int(_idx[j]))

        fracs, views = aggregate_class_images_distributed(
            sub_mesh, sub_cams, n_classes,
            class_image_provider=provider, **pipeline_kwargs,
        )
        np.add.at(total_fracs, face_ids, np.nan_to_num(fracs))
        np.add.at(total_views, face_ids, views)
        produced = True
    if not produced:
        raise ValueError("No chunks produced data")
    return total_fracs, total_views
