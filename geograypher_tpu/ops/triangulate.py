"""Pairwise segment/ray closest-point math — the numerical heart of
multiview detection triangulation.

Jitted, branchless port of the reference's
``compute_approximate_ray_intersections`` (utils/numeric.py:39-237): for N
segments a0->a1 vs M segments b0->b1, the (N, M) closest points on each
and their distances, with optional clamping to segment ends and full
parallel-case handling.  The O(N^2) einsum blocks that dominate
``triangulate_detections`` (SURVEY.md §3.4) run on the device; the upper-
triangular block iteration of the reference (numeric.py:350-377) is kept
host-side for memory control at very large N.
"""

from __future__ import annotations

import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np


# every geometry contraction asks for full float32: a float32 matmul may
# otherwise run in TF32 on the GPU
_HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("clamp",))
def _pairwise_closest(a0, a1, b0, b1, clamp: bool):
    ftype = a0.dtype
    A = a1 - a0  # (N, 3)
    B = b1 - b0  # (M, 3)
    magA = jnp.linalg.norm(A, axis=1)
    magB = jnp.linalg.norm(B, axis=1)
    uA = A / magA[:, None]
    uB = B / magB[:, None]

    a0e = a0[:, None, :]
    b0e = b0[None, :, :]
    uAe = uA[:, None, :]
    uBe = uB[None, :, :]

    cross = jnp.cross(uAe, uBe)  # (N, M, 3)
    denom = jnp.sum(cross * cross, axis=2)  # (N, M)
    parallel = denom == 0
    safe_denom = jnp.where(parallel, 1.0, denom)

    t = b0e - a0e
    detA = jnp.einsum("ijk,ijk->ij", jnp.cross(t, uBe), cross, precision=_HIGHEST)
    detB = jnp.einsum("ijk,ijk->ij", jnp.cross(t, uAe), cross, precision=_HIGHEST)
    t0 = detA / safe_denom
    t1 = detB / safe_denom

    if clamp:
        t0c = jnp.clip(t0, 0.0, magA[:, None])
        t1c = jnp.clip(t1, 0.0, magB[None, :])
        pA = a0e + t0c[..., None] * uAe
        pB = b0e + t1c[..., None] * uBe
        oob_A = (t0 < 0) | (t0 > magA[:, None])
        oob_B = (t1 < 0) | (t1 > magB[None, :])
        # reproject the clamped A point onto B (where A was clamped)...
        dotB = jnp.clip(
            jnp.einsum("ijk,ijk->ij", pA - b0e, jnp.broadcast_to(uBe, pA.shape), precision=_HIGHEST),
            0.0,
            magB[None, :],
        )
        pB = jnp.where(
            oob_A[..., None], b0e + dotB[..., None] * uBe, pB
        )
        # ...then the (possibly updated) B point onto A (where B was clamped)
        dotA = jnp.clip(
            jnp.einsum("ijk,ijk->ij", pB - a0e, jnp.broadcast_to(uAe, pB.shape), precision=_HIGHEST),
            0.0,
            magA[:, None],
        )
        pA = jnp.where(
            oob_B[..., None], a0e + dotA[..., None] * uAe, pA
        )

        # Parallel segments: before / after / overlapping-middle cases
        # (reference numeric.py:157-227)
        d0 = jnp.einsum("ij,kj->ik", uA, b0, precision=_HIGHEST) - jnp.einsum("ij,ij->i", uA, a0, precision=_HIGHEST)[
            :, None
        ]
        d1 = jnp.einsum("ij,kj->ik", uA, b1, precision=_HIGHEST) - jnp.einsum("ij,ij->i", uA, a0, precision=_HIGHEST)[
            :, None
        ]
        before = (d0 <= 0) & (d1 <= 0) & parallel
        after = (d0 >= magA[:, None]) & (d1 >= magA[:, None]) & parallel
        middle = parallel & ~(before | after)

        a0b = jnp.broadcast_to(a0e, pA.shape)
        a1b = jnp.broadcast_to(a1[:, None, :], pA.shape)
        b0b = jnp.broadcast_to(b0e, pB.shape)
        b1b = jnp.broadcast_to(b1[None, :, :], pB.shape)
        uAb = jnp.broadcast_to(uAe, pA.shape)

        closer_b0 = jnp.abs(d0) < jnp.abs(d1)
        pA = jnp.where(before[..., None], a0b, pA)
        pB = jnp.where(
            before[..., None], jnp.where(closer_b0[..., None], b0b, b1b), pB
        )
        pA = jnp.where(after[..., None], a1b, pA)
        pB = jnp.where(
            after[..., None], jnp.where(closer_b0[..., None], b0b, b1b), pB
        )
        t_mid = jnp.clip(d0, 0.0, magA[:, None])
        pA_mid = a0b + t_mid[..., None] * uAb
        a2b = b0b - pA_mid
        along = jnp.einsum("ijk,ijk->ij", a2b, uAb, precision=_HIGHEST)[..., None] * uAb
        pB_mid = pA_mid + (a2b - along)
        pA = jnp.where(middle[..., None], pA_mid, pA)
        pB = jnp.where(middle[..., None], pB_mid, pB)
    else:
        pA = a0e + t0[..., None] * uAe
        pB = b0e + t1[..., None] * uBe
        # parallel: arbitrarily b0 and its projection onto A
        d0 = jnp.einsum("ij,kj->ik", uA, b0, precision=_HIGHEST) - jnp.einsum("ij,ij->i", uA, a0, precision=_HIGHEST)[
            :, None
        ]
        pA_par = jnp.broadcast_to(a0e, pA.shape) + d0[..., None] * jnp.broadcast_to(
            uAe, pA.shape
        )
        pA = jnp.where(parallel[..., None], pA_par, pA)
        pB = jnp.where(
            parallel[..., None], jnp.broadcast_to(b0e, pB.shape), pB
        )

    dist = jnp.linalg.norm(pA - pB, axis=2)
    return pA, pB, dist


def pairwise_segment_closest_points(
    a0, a1, b0, b1, clamp: bool = False
):
    """Closest points + distances between all segment pairs.

    Host-friendly wrapper returning numpy; same signature/semantics as the
    reference's compute_approximate_ray_intersections (numeric.py:39).
    """
    pA, pB, dist = _pairwise_closest(
        jnp.asarray(a0, jnp.float32),
        jnp.asarray(a1, jnp.float32),
        jnp.asarray(b0, jnp.float32),
        jnp.asarray(b1, jnp.float32),
        clamp=clamp,
    )
    return np.asarray(pA), np.asarray(pB), np.asarray(dist)


# Alias matching the reference's name for ported call sites
compute_approximate_ray_intersections = pairwise_segment_closest_points


def calc_graph_weights(
    starts: np.ndarray,
    ends: np.ndarray,
    ray_IDs: np.ndarray,
    similarity_threshold: float,
    out_dir=None,
    min_dist: float = 1e-6,
    step: int = 5000,
    transform: typing.Optional[typing.Callable] = None,
):
    """Graph edges between intersecting rays, weighted by inverse distance
    (reference numeric.py:428-507).  Pairwise blocks run on-device; edge
    formatting is host-side."""
    import json
    from pathlib import Path

    from geograypher_tpu.utils.numeric import chunk_slices, format_graph_edges

    edge_weights = []
    for islice, jslice, diagonal in chunk_slices(N=len(starts), step=step):
        _, _, dist = pairwise_segment_closest_points(
            starts[islice], ends[islice], starts[jslice], ends[jslice],
            clamp=True,
        )
        dist = np.array(dist, dtype=np.float64)  # writable copy
        if diagonal:
            np.fill_diagonal(dist, np.nan)
        dist[dist > similarity_threshold] = np.nan
        dist[dist < min_dist] = min_dist
        if transform is not None:
            dist = transform(dist)
        edge_weights.extend(format_graph_edges(islice, jslice, dist, ray_IDs))

    if out_dir is None:
        return edge_weights
    path = Path(out_dir) / "edge_weights.json"
    with path.open("w") as fh:
        json.dump(edge_weights, fh)
    return path


def calc_communities(
    starts: np.ndarray,
    ends: np.ndarray,
    edge_weights,
    louvain_resolution: float = 1.0,
    out_dir=None,
    transform_to_epsg_4978: typing.Optional[np.ndarray] = None,
    seed: int = 0,
):
    """Louvain communities over the ray-intersection graph; each community
    is triangulated to one 3D point (reference numeric.py:509-619).

    Deterministic: Louvain runs with a fixed seed (the reference leaves it
    unseeded, SURVEY.md §5).
    """
    import networkx
    from pathlib import Path

    from geograypher_tpu.constants import (
        EARTH_CENTERED_EARTH_FIXED_EPSG,
        LAT_LON_EPSG,
    )
    from geograypher_tpu.utils import crs as crs_utils
    from geograypher_tpu.utils.numeric import intersection_average

    graph = networkx.Graph(edge_weights)
    if len(graph) > 0:
        communities = networkx.community.louvain_communities(
            graph, weight="weight", resolution=louvain_resolution, seed=seed
        )
        communities = sorted(communities, key=len, reverse=True)
        community_points = []
        ray_IDs = np.full(starts.shape[0], fill_value=np.nan)
        for community_ID, community in enumerate(communities):
            idx = np.array(list(community))
            ray_IDs[idx] = community_ID
            community_points.append(
                intersection_average(starts=starts[idx], ends=ends[idx])
            )
        community_points = np.vstack(community_points)
        result = {"ray_IDs": ray_IDs, "community_points": community_points}
        if transform_to_epsg_4978 is not None:
            hom = np.concatenate(
                [community_points, np.ones_like(community_points[:, :1])], axis=1
            )
            ecef = (transform_to_epsg_4978 @ hom.T).T
            result["community_points_latlon"] = crs_utils.transform_points(
                ecef[:, :3], EARTH_CENTERED_EARTH_FIXED_EPSG, LAT_LON_EPSG
            )
    else:
        result = {
            "ray_IDs": np.zeros((0,), dtype=int),
            "community_points": np.zeros((0, 3)),
        }
        if transform_to_epsg_4978 is not None:
            result["community_points_latlon"] = np.zeros((0, 3))

    if out_dir is not None:
        path = Path(out_dir) / "communities.npz"
        np.savez(path, **result)
        return path
    return result


def triangulate_rays_lstsq(starts: np.ndarray, directions: np.ndarray) -> np.ndarray:
    """Least-squares intersection point of rays (reference numeric.py:239-269;
    kept for API parity — the main triangulation flow uses
    intersection_average instead).

    Solves min_x sum_i || (I - d_i d_i^T)(x - s_i) ||^2 in closed form.
    """
    d = np.asarray(directions, dtype=np.float64)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    s = np.asarray(starts, dtype=np.float64)
    eye = np.eye(3)
    projs = eye[None] - d[:, :, None] * d[:, None, :]  # (N, 3, 3)
    A = projs.sum(axis=0)
    b = np.einsum("nij,nj->i", projs, s)
    return np.linalg.solve(A, b)
