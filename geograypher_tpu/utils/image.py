"""Image-space utilities: EXIF GPS, camera-frame rotations, equirectangular
-> perspective resampling.

Counterpart of /root/reference/geograypher/utils/image.py, with cv2.remap
replacing skimage.warp and numpy replacing scipy Rotation.
"""

from __future__ import annotations

import typing

import numpy as np

from geograypher_tpu.constants import PATH_TYPE
from geograypher_tpu.utils.numeric import rotation_rpy_to_matrix


def resize_nearest(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest-neighbour resize of the first two axes to (height, width)
    with ``cv2.INTER_NEAREST``'s sampling (source index
    ``floor(dst * src / dst)``), in numpy: label rasters keep their exact
    values and no optional image library is needed."""
    src_h, src_w = image.shape[:2]
    rows = np.minimum(
        (np.arange(height) * (src_h / height)).astype(np.int64), src_h - 1
    )
    cols = np.minimum(
        (np.arange(width) * (src_w / width)).astype(np.int64), src_w - 1
    )
    return image[rows[:, None], cols[None, :]]


def get_GPS_exif(image_filename: PATH_TYPE) -> typing.Optional[tuple]:
    """(lon, lat) from EXIF GPS tags (reference image.py:10-27), via PIL."""
    from PIL import ExifTags, Image

    try:
        with Image.open(image_filename) as img:
            exif = img.getexif()
            gps = exif.get_ifd(ExifTags.IFD.GPSInfo)
    except Exception:
        return None
    if not gps:
        return None

    def dms_to_deg(dms, ref):
        deg = float(dms[0]) + float(dms[1]) / 60 + float(dms[2]) / 3600
        return -deg if ref in ("S", "W") else deg

    try:
        lat = dms_to_deg(gps[2], gps[1])
        lon = dms_to_deg(gps[4], gps[3])
    except (KeyError, IndexError):
        return None
    return (lon, lat)


def rotate_by_roll_pitch_yaw(
    cam_to_world: np.ndarray, roll: float, pitch: float, yaw: float
) -> np.ndarray:
    """Apply a camera-frame roll/pitch/yaw to a cam-to-world transform
    (reference image.py:29-70): the rotation composes on the CAMERA side,
    so the rig member's orientation is expressed relative to the rig."""
    rot = rotation_rpy_to_matrix(roll, pitch, yaw)
    out = np.array(cam_to_world, dtype=np.float64)
    out[:3, :3] = out[:3, :3] @ rot
    return out


def perspective_from_equirectangular(
    equirect_image: np.ndarray,
    roll: float,
    pitch: float,
    yaw: float,
    fov_deg: float = 90.0,
    out_size: typing.Tuple[int, int] = (1024, 1024),
    oversample: float = 1.0,
    return_sampled_mask: bool = False,
):
    """Sample a pinhole view out of a 360 panorama
    (reference image.py:129-267).

    A ray grid for the virtual pinhole camera is rotated by (roll, pitch,
    yaw), converted to spherical coordinates and used to sample the
    equirectangular image (with longitude wraparound).

    Args:
        equirect_image: (He, We[, C]) panorama; x spans 360 deg of yaw,
            y spans 180 deg of pitch.
        roll, pitch, yaw: virtual camera orientation, degrees.
        fov_deg: horizontal field of view of the virtual camera.
        out_size: (height, width) of the output.
        oversample: sample at this multiple of the output resolution then
            area-downsample (antialiasing; reference image.py:245-253).
        return_sampled_mask: also return a (He, We) bool mask of the
            panorama pixels that were sampled (reference image.py:255-267).
    """
    import cv2

    he, we = equirect_image.shape[:2]
    oh, ow = int(out_size[0] * oversample), int(out_size[1] * oversample)
    f = (ow / 2) / np.tan(np.deg2rad(fov_deg) / 2)

    xs = (np.arange(ow) + 0.5) - ow / 2
    ys = (np.arange(oh) + 0.5) - oh / 2
    xx, yy = np.meshgrid(xs, ys)
    rays = np.stack([xx, yy, np.full_like(xx, f)], axis=-1)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)

    rot = rotation_rpy_to_matrix(roll, pitch, yaw)
    rays = rays @ rot.T

    # spherical: yaw (longitude) around +Y axis... camera convention:
    # x right, y down, z forward. longitude from atan2(x, z), latitude
    # from asin(y).
    lon = np.arctan2(rays[..., 0], rays[..., 2])  # [-pi, pi]
    lat = np.arcsin(np.clip(rays[..., 1], -1, 1))  # [-pi/2, pi/2]
    map_x = ((lon / (2 * np.pi)) + 0.5) * we - 0.5
    # latitude must CLAMP, not wrap: BORDER_WRAP applies to both axes,
    # and pole-adjacent rows (map_y just past he-1 or below 0) would
    # otherwise bilinear-blend with the OPPOSITE pole's pixels
    map_y = np.clip(((lat / np.pi) + 0.5) * he - 0.5, 0.0, he - 1.0)

    out = cv2.remap(
        np.asarray(equirect_image),
        map_x.astype(np.float32),
        map_y.astype(np.float32),
        interpolation=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_WRAP,  # longitude wraparound (image.py:230)
    )
    if oversample != 1.0:
        out = cv2.resize(
            out, (out_size[1], out_size[0]), interpolation=cv2.INTER_AREA
        )
    if return_sampled_mask:
        mask = np.zeros((he, we), dtype=bool)
        xi = np.clip(np.round(map_x).astype(int) % we, 0, we - 1)
        yi = np.clip(np.round(map_y).astype(int), 0, he - 1)
        mask[yi.ravel(), xi.ravel()] = True
        return out, mask
    return out
