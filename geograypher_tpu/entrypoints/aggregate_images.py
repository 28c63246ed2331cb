"""aggregate_images: project per-image predictions onto the mesh and export
a geospatial map.

Port of the reference entrypoint
(/root/reference/geograypher/entrypoints/aggregate_images.py:19-279) with
the same argument surface (pyproj CRS objects become EPSG ints).  The
pipeline: MetashapeCameraSet (+ subsetting) -> LookUpSegmentor-wrapped
cameras -> TexturedMesh.aggregate_projected_images -> per-face argmax ->
optional DTM ground relabel -> vector export.
"""

from __future__ import annotations

import argparse
import json
import typing

import numpy as np

from geograypher_tpu.cameras.metashape import MetashapeCameraSet
from geograypher_tpu.cameras.segmentor_set import SegmentorCameraSet
from geograypher_tpu.constants import PATH_TYPE
from geograypher_tpu.meshes.mesh import TexturedMesh
from geograypher_tpu.ops.aggregate import find_argmax_nonzero_value
from geograypher_tpu.predictors.segmentors import LookUpSegmentor
from geograypher_tpu.utils.files import ensure_containing_folder


def aggregate_images(
    mesh_file: PATH_TYPE,
    cameras_file: PATH_TYPE,
    image_folder: PATH_TYPE,
    label_folder: PATH_TYPE,
    mesh_CRS: typing.Optional[int] = None,
    original_image_folder: typing.Optional[PATH_TYPE] = None,
    subset_images_folder: typing.Optional[PATH_TYPE] = None,
    filename_regex: typing.Optional[str] = None,
    take_every_nth_camera: typing.Optional[int] = 100,
    DTM_file: typing.Optional[PATH_TYPE] = None,
    height_above_ground_threshold: float = 2.0,
    ROI: typing.Optional[PATH_TYPE] = None,
    ROI_buffer_radius_meters: float = 50,
    IDs_to_labels: typing.Union[dict, str, None] = None,
    mesh_downsample: float = 1.0,
    n_classes: typing.Optional[int] = None,
    n_aggregation_clusters: typing.Optional[int] = None,
    n_cameras_per_aggregation_cluster: typing.Optional[int] = None,
    aggregate_image_scale: float = 1.0,
    aggregated_face_values_savefile: typing.Optional[PATH_TYPE] = None,
    predicted_face_classes_savefile: typing.Optional[PATH_TYPE] = None,
    top_down_vector_projection_savefile: typing.Optional[PATH_TYPE] = None,
    vis: bool = False,
):
    """Aggregate per-image labels from multiple viewpoints onto the mesh.

    See the reference docstring (aggregate_images.py:43-100) for argument
    semantics; all are preserved.  ``n_classes`` sets the label-map class
    count (else inferred from IDs_to_labels).
    """
    if isinstance(IDs_to_labels, str):
        IDs_to_labels = {
            int(k): v for k, v in json.load(open(IDs_to_labels)).items()
        }

    camera_set = MetashapeCameraSet(
        cameras_file,
        image_folder,
        original_image_folder=original_image_folder,
        validate_images=True,
    )
    if subset_images_folder is not None:
        camera_set = camera_set.get_subset_by_folder(subset_images_folder)
    if filename_regex is not None:
        camera_set = camera_set.get_subset_by_regex(filename_regex)
    if take_every_nth_camera is not None:
        camera_set = camera_set.get_subset_every_nth(take_every_nth_camera)
    if ROI is not None:
        camera_set = camera_set.get_subset_ROI(ROI, ROI_buffer_radius_meters)

    mesh = TexturedMesh(
        mesh_file,
        downsample_target=mesh_downsample,
        CRS=mesh_CRS,
        transform_filename=cameras_file,
        ROI=ROI,
        ROI_buffer_meters=ROI_buffer_radius_meters,
        IDs_to_labels=IDs_to_labels,
    )

    if n_classes is None:
        n_classes = len(IDs_to_labels) if IDs_to_labels else 10
    segmentor = LookUpSegmentor(
        base_folder=image_folder,
        lookup_folder=label_folder,
        num_classes=n_classes,
    )
    seg_cameras = SegmentorCameraSet(camera_set, segmentor)

    import jax

    if n_aggregation_clusters is None and n_cameras_per_aggregation_cluster:
        n_aggregation_clusters = max(
            len(camera_set) // n_cameras_per_aggregation_cluster, 1
        )
    if n_aggregation_clusters is None and jax.device_count() > 1:
        # Multi-chip: shard views across the device mesh with host-side
        # image prefetch (the replacement for the reference's
        # sequential chunked aggregation)
        from geograypher_tpu.parallel.pipeline import (
            aggregate_class_images_distributed,
        )

        frac_sums, views = aggregate_class_images_distributed(
            mesh,
            seg_cameras,
            n_classes=n_classes,
            aggregate_img_scale=aggregate_image_scale,
        )
        with np.errstate(invalid="ignore", divide="ignore"):
            average_projections = frac_sums / views[:, None]
        average_projections[views == 0] = np.nan
        info = {"projection_counts": views, "summed_projections": frac_sums}
    elif n_aggregation_clusters is not None:
        from geograypher_tpu.meshes.chunked import aggregate_images_chunked

        average_projections, info = aggregate_images_chunked(
            mesh,
            seg_cameras,
            n_clusters=n_aggregation_clusters,
            aggregate_img_scale=aggregate_image_scale,
        )
    else:
        average_projections, info = mesh.aggregate_projected_images(
            seg_cameras, aggregate_img_scale=aggregate_image_scale
        )

    if aggregated_face_values_savefile is not None:
        ensure_containing_folder(aggregated_face_values_savefile)
        np.save(aggregated_face_values_savefile, average_projections)

    import jax.numpy as jnp

    predicted_face_classes = np.array(
        find_argmax_nonzero_value(
            jnp.asarray(np.nan_to_num(average_projections), jnp.float32)
        )
    )
    # faces never observed stay NaN
    predicted_face_classes[info["projection_counts"] == 0] = np.nan

    if DTM_file is not None:
        mesh.set_texture(predicted_face_classes, is_vertex=False)
        vert_tex = mesh.get_texture(request_vertex_texture=True)
        mesh.set_texture(vert_tex, is_vertex=True)
        tex, _ = mesh.label_ground_class(
            DTM_file,
            height_above_ground_threshold=height_above_ground_threshold,
            ground_ID=np.nan if IDs_to_labels is None else len(IDs_to_labels),
        )
        predicted_face_classes = mesh.vert_to_face_texture()[:, 0]

    if predicted_face_classes_savefile is not None:
        ensure_containing_folder(predicted_face_classes_savefile)
        np.save(predicted_face_classes_savefile, predicted_face_classes)

    if top_down_vector_projection_savefile is not None:
        mesh.export_face_labels_vector(
            predicted_face_classes,
            export_file=top_down_vector_projection_savefile,
        )
    return predicted_face_classes, average_projections


def parse_args():
    parser = argparse.ArgumentParser(
        description=aggregate_images.__doc__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--mesh-file", required=True)
    parser.add_argument("--cameras-file", required=True)
    parser.add_argument("--image-folder", required=True)
    parser.add_argument("--label-folder", required=True)
    parser.add_argument("--mesh-CRS", type=int, default=None)
    parser.add_argument("--original-image-folder", default=None)
    parser.add_argument("--subset-images-folder", default=None)
    parser.add_argument("--filename-regex", default=None)
    parser.add_argument("--take-every-nth-camera", type=int, default=100)
    parser.add_argument("--DTM-file", default=None)
    parser.add_argument("--height-above-ground-threshold", type=float, default=2.0)
    parser.add_argument("--ROI", default=None)
    parser.add_argument("--ROI-buffer-radius-meters", type=float, default=50)
    parser.add_argument("--IDs-to-labels", default=None)
    parser.add_argument("--mesh-downsample", type=float, default=1.0)
    parser.add_argument("--n-classes", type=int, default=None)
    parser.add_argument("--n-aggregation-clusters", type=int, default=None)
    parser.add_argument("--aggregate-image-scale", type=float, default=1.0)
    parser.add_argument("--aggregated-face-values-savefile", default=None)
    parser.add_argument("--predicted-face-classes-savefile", default=None)
    parser.add_argument("--top-down-vector-projection-savefile", default=None)
    parser.add_argument("--vis", action="store_true")
    return parser.parse_args()


if __name__ == "__main__":
    args = parse_args()
    aggregate_images(**vars(args))
