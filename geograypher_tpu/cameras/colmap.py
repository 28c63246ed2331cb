"""COLMAP text-export parser -> :class:`CameraSet`.

Behavioral equivalent of the reference's ``COLMAPCameraSet``
(/root/reference/geograypher/cameras/derived_cameras.py:199-321): parses
``cameras.txt`` / ``images.txt`` (every other row of images.txt is keypoint
data and is skipped), converts COLMAP's (QW, QX, QY, QZ) world->cam
quaternion + translation into cam-to-world 4x4s.  Only SIMPLE_RADIAL is
supported, matching the reference (derived_cameras.py:267).

Unlike the reference — whose COLMAP path silently has NO distortion
correction (SURVEY.md §2.1) — the single radial coefficient is mapped onto
the Brown-Conrady ``k1`` slot.  COLMAP's model distorts normalized
coordinates as ``x * (1 + k * r^2)`` with r measured in normalized units,
which is exactly the Metashape k1 term, so the shared distortion engine
applies directly.
"""

from __future__ import annotations

import typing
from pathlib import Path

import numpy as np

from geograypher_tpu.cameras.core import CameraSet
from geograypher_tpu.constants import PATH_TYPE
from geograypher_tpu.utils.numeric import quaternion_wxyz_to_matrix


class COLMAPCameraSet(CameraSet):
    def __init__(
        self,
        cameras_file: PATH_TYPE,
        images_file: PATH_TYPE,
        image_folder: typing.Union[None, PATH_TYPE] = None,
        validate_images: bool = False,
    ):
        import pandas as pd

        cameras_data = pd.read_csv(
            cameras_file,
            sep=" ",
            skiprows=[0, 1, 2],
            header=None,
            names=(
                "CAMERA_ID",
                "MODEL",
                "WIDTH",
                "HEIGHT",
                "PARAMS_F",
                "PARAMS_CX",
                "PARAMS_CY",
                "PARAMS_RADIAL",
            ),
        )
        images_data = pd.read_csv(
            images_file,
            sep=" ",
            skiprows=lambda x: (x in (0, 1, 2, 3) or x % 2),
            header=None,
            names=(
                "IMAGE_ID",
                "QW",
                "QX",
                "QY",
                "QZ",
                "TX",
                "TY",
                "TZ",
                "CAMERA_ID",
                "NAME",
            ),
            usecols=list(range(10)),
        )

        if np.any(cameras_data["MODEL"] != "SIMPLE_RADIAL"):
            raise NotImplementedError("Not a supported camera model")

        sensors_dict = {}
        for _, row in cameras_data.iterrows():
            # COLMAP cx/cy are from the corner; this framework measures from
            # the center (reference derived_cameras.py:276-280)
            sensors_dict[row["CAMERA_ID"]] = {
                "image_width": int(row["WIDTH"]),
                "image_height": int(row["HEIGHT"]),
                "f": float(row["PARAMS_F"]),
                "cx": float(row["PARAMS_CX"] - row["WIDTH"] / 2),
                "cy": float(row["PARAMS_CY"] - row["HEIGHT"] / 2),
                "distortion_params": {"k1": float(row["PARAMS_RADIAL"])},
            }

        cam_to_world_transforms = []
        sensor_IDs = []
        image_filenames = []
        for _, row in images_data.iterrows():
            rot_mat = quaternion_wxyz_to_matrix(
                (row["QW"], row["QX"], row["QY"], row["QZ"])
            )
            world_to_cam = np.eye(4)
            world_to_cam[:3, :3] = rot_mat
            world_to_cam[:3, 3] = (row["TX"], row["TY"], row["TZ"])
            cam_to_world_transforms.append(np.linalg.inv(world_to_cam))
            sensor_IDs.append(row["CAMERA_ID"])
            image_filenames.append(
                Path(image_folder, row["NAME"]) if image_folder is not None else None
            )

        super().__init__(
            cam_to_world_transforms=cam_to_world_transforms,
            intrinsic_params_per_sensor_type=sensors_dict,
            image_filenames=image_filenames,
            sensor_IDs=sensor_IDs,
            image_folder=image_folder,
            validate_images=validate_images,
        )
