"""Small geometric helpers (counterpart of reference utils/geometric.py).

The heavy pieces of the reference module moved to dedicated device ops:
``batched_unary_union`` -> raster union (utils/vector.union_all),
``clip_line_segments`` (Embree) -> ops/raycast.clip_line_segments.
"""

from __future__ import annotations

import numpy as np


def get_scale_from_transform(transform: np.ndarray) -> float:
    """Isotropic scale of a 4x4: cbrt of the rotation block determinant
    (reference geometric.py:97-113)."""
    if transform is None:
        return 1.0
    return float(np.cbrt(np.linalg.det(np.asarray(transform)[:3, :3])))


def angle_between(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Angle(s) in radians between vectors, vectorized over leading dims
    (reference geometric.py:115-134)."""
    v1 = np.asarray(v1, dtype=np.float64)
    v2 = np.asarray(v2, dtype=np.float64)
    n1 = np.linalg.norm(v1, axis=-1)
    n2 = np.linalg.norm(v2, axis=-1)
    dot = np.sum(v1 * v2, axis=-1)
    cos = np.clip(dot / np.maximum(n1 * n2, 1e-300), -1.0, 1.0)
    return np.arccos(cos)


def orthogonal_projection(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Projection of v1 onto v2."""
    v2 = np.asarray(v2, dtype=np.float64)
    denom = np.sum(v2 * v2, axis=-1, keepdims=True)
    return v2 * np.sum(np.asarray(v1) * v2, axis=-1, keepdims=True) / denom


def projection_onto_plane(v: np.ndarray, normal: np.ndarray) -> np.ndarray:
    """Component of v in the plane with the given normal
    (reference geometric.py:136-142)."""
    return np.asarray(v, dtype=np.float64) - orthogonal_projection(v, normal)


def projection_onto_spanned_plane(
    v: np.ndarray, e1: np.ndarray, e2: np.ndarray
) -> np.ndarray:
    """Component of v in the plane SPANNED by e1 and e2 (the reference's
    projection convention, geometric.py:136-142); vectorized over leading
    dims."""
    normal = np.cross(np.asarray(e1, np.float64), np.asarray(e2, np.float64))
    return projection_onto_plane(v, normal)


def serpentine_face_order(
    centroids_2d: np.ndarray, rows_per_bin: float = 2.0
) -> np.ndarray:
    """Scanline face permutation with SERPENTINE x order (x reversed on odd
    scanline rows) over 2D centroids.

    Consecutive ids stay spatially adjacent across row turns, so fixed-size
    id blocks (RasterConfig.bin_block) never union an image-wide bbox at a
    row wrap — plain scanline wraps produced ~1 full-width block per mesh
    row, which fell to the coarse raster levels (L2/global) where each
    costs a whole-parent resolve in the tile kernel.

    ``rows_per_bin`` sets the scanline bin height in units of the mesh's
    natural face-row pitch (``sqrt(F)`` bins = 1.0).  The default 2.0
    keeps id blocks SQUARE-ISH (~2 face rows tall x ~4 faces wide):
    1-row bins make blocks 8 faces long in x, and oblique views looking
    along x turn those runs into ~2x-taller image bboxes that overflow
    the L0/L1 fit windows (measured: L2 census 514-588 units on
    azimuth-aligned oblique 4K views at 1.0 vs exactly 0 at 2.0).

    Returns ``order`` with ``new_faces = faces[order]``.
    """
    cent = np.asarray(centroids_2d, np.float64)
    n_bins = max(int(np.sqrt(len(cent)) / max(rows_per_bin, 1e-9)), 1)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    y_bin = np.minimum(
        ((cent[:, 1] - lo[1]) / span[1] * n_bins).astype(np.int64),
        n_bins - 1,
    )
    x_key = np.where(y_bin % 2 == 1, -cent[:, 0], cent[:, 0])
    return np.lexsort((x_key, y_bin))


def partitioned_face_order(
    face_verts_2d: np.ndarray,
    rows_per_bin: float = 2.0,
    big_factor: float = 8.0,
    return_split: bool = False,
):
    """Serpentine face permutation with OVERSIZED faces packed into their
    own trailing id blocks.

    On irregular TINs (what photogrammetry software exports — arbitrary
    Metashape meshes, reference meshes.py:157-229) a small fraction of
    faces is vastly larger than the median: Delaunay hull slivers, mesh
    holes, water surfaces (measured on the 1M-face benchmark TIN: face
    bbox p99 = 2.4 mean cells but p100 = 622).  Under a plain serpentine
    order each such face drags its whole ``bin_block`` unit to the GLOBAL
    binning level — where every unit is resolved against the entire image
    — at 1 giant + 7 innocent faces per unit (censused 18-33 global units
    per 4K view, ~3x total slowdown vs the grid mesh).  Packing all faces
    whose xy-bbox diagonal exceeds ``big_factor`` x median into their own
    serpentine-ordered id range puts 8 giants in each global unit instead
    of one, and returns the innocents to L0.

    Regular meshes have no oversized faces and come out in plain
    serpentine order (bit-identical permutation).

    Args:
        face_verts_2d: (F, 3, 2) per-face xy vertex coordinates (any
            ground-plane projection; only relative extents matter).
        rows_per_bin: forwarded to :func:`serpentine_face_order`.
        big_factor: faces with bbox diagonal > ``big_factor * median``
            are packed separately.  8.0 is safely beyond every fit
            window at the benchmark's pixel scales while keeping the
            packed class tiny (< 0.1 % of faces on the benchmark TIN).
        return_split: also return the NEW index of the first oversized
            face (== number of regular faces).  Pass it to
            ``RasterConfig.global_from`` so the binning pins the
            oversized tail to the global level.

    Returns ``order`` with ``new_faces = faces[order]`` — or
    ``(order, n_regular)`` with ``return_split`` (``n_regular ==
    len(order)`` when nothing is oversized).
    """
    fv = np.asarray(face_verts_2d, np.float64)
    span = fv.max(axis=1) - fv.min(axis=1)
    diag = np.hypot(span[:, 0], span[:, 1])
    med = np.median(diag)
    big = diag > big_factor * max(med, 1e-300)
    cent = fv.mean(axis=1)
    if not big.any():
        order = serpentine_face_order(cent, rows_per_bin)
        return (order, len(order)) if return_split else order
    small_idx = np.flatnonzero(~big)
    big_idx = np.flatnonzero(big)
    order_small = serpentine_face_order(cent[small_idx], rows_per_bin)
    order_big = serpentine_face_order(cent[big_idx], rows_per_bin)
    order = np.concatenate([small_idx[order_small], big_idx[order_big]])
    return (order, len(small_idx)) if return_split else order
