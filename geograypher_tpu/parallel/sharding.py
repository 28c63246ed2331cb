"""Multi-chip distribution: camera views sharded across a device mesh.

The reference has no distributed execution at all (SURVEY.md §2.7); its
only scale mechanism is sequential spatial chunking
(``TexturedPhotogrammetryMeshChunked``, derived_meshes.py:23-411).  Here
that decomposition becomes a sharding strategy:

* mesh geometry (triangle vertices / planes) is REPLICATED — 1M faces x
  (3, 3) f32 = 36 MB, comfortably within device memory;
* cameras/views are SHARDED over the "views" mesh axis (the natural data
  axis: a survey has hundreds-thousands of views);
* per-face accumulators are computed per device and combined with a
  ``psum`` across devices — the chunked-mesh scatter-add (derived_meshes.py:292-302)
  reborn as a collective.

``shard_map`` is used rather than relying on GSPMD sharding propagation:
the rasterizer's per-view pipeline (sort, searchsorted, resolve kernel) is
explicitly per-device work, not something to be partitioned op-by-op.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from geograypher_tpu.ops.aggregate import (
    accumulate_view,
    init_aggregation,
    project_image_to_faces,
)
from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    rasterize_triangles,
    transform_to_camera,
)

VIEW_AXIS = "views"


def make_view_mesh(devices=None) -> Mesh:
    """1D device mesh over the view axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (VIEW_AXIS,))


def pad_views(n_views: int, n_devices: int) -> int:
    """Views padded so every device gets an equal static batch."""
    return -(-n_views // n_devices) * n_devices


@functools.partial(
    jax.jit,
    static_argnames=("image_w", "image_h", "config", "n_faces", "mesh"),
)
def sharded_render_aggregate(
    tri_verts: jax.Array,
    face_texture: jax.Array,
    world_to_cam: jax.Array,
    focals: jax.Array,
    view_valid: jax.Array,
    *,
    image_w: int,
    image_h: int,
    n_faces: int,
    config: RasterConfig,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array]:
    """The flagship multi-chip step: every device rasterizes its shard of
    views, renders the face texture into them, folds each view's pixels
    back into per-face (sum, count) accumulators, and the partial
    accumulators are psum-combined across devices.

    This is a self-contained render->aggregate round trip (the benchmark
    workload and the parity oracle).  Real prediction aggregation uses the
    same structure with per-view label images streamed in instead of the
    rendered texture — see
    meshes.mesh.TexturedMesh.aggregate_projected_images.

    Args:
        tri_verts: (F, 3, 3) replicated triangle vertices (local frame).
        face_texture: (F, C) replicated per-face texture.
        world_to_cam: (V, 4, 4) view transforms, V divisible by mesh size.
        focals: (V,) focal lengths.
        view_valid: (V,) 0/1 mask for padding views.

    Returns:
        value_sum: (F, C) summed per-view means
        view_count: (F,) views seeing each face
    """

    def per_device(tri_verts, face_texture, w2c_shard, f_shard, valid_shard):
        def per_view(state, inputs):
            w2c, focal, valid = inputs
            cam_tris = transform_to_camera(tri_verts, w2c)
            p2f = rasterize_triangles(
                cam_tris, focal, image_w=image_w, image_h=image_h, config=config
            )
            from geograypher_tpu.ops.aggregate import render_texture

            img = render_texture(p2f, face_texture)
            sums, counts = project_image_to_faces(p2f, img, n_faces)
            sums = sums * valid
            counts = counts * valid
            return accumulate_view(state, sums, counts), None

        state = init_aggregation(n_faces, face_texture.shape[1])
        state, _ = unrolled_view_scan(
            per_view, state, (w2c_shard, f_shard, valid_shard)
        )
        value_sum = jax.lax.psum(state.value_sum, VIEW_AXIS)
        view_count = jax.lax.psum(state.view_count, VIEW_AXIS)
        return value_sum, view_count

    return jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(), P(VIEW_AXIS), P(VIEW_AXIS), P(VIEW_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )(tri_verts, face_texture, world_to_cam, focals, view_valid)


def unrolled_view_scan(f, init, xs):
    """``lax.scan`` stand-in, python-unrolled over the leading axis.

    Per-device view loops are short, so unrolling costs only compile
    time; whether a ``lax.scan`` body compiles faster at the same run
    time is an open measurement.
    """
    n = jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry = init
    for i in range(n):
        carry, _ = f(carry, jax.tree_util.tree_map(lambda a: a[i], xs))
    return carry, None


def shard_views_for_mesh(
    world_to_cam: np.ndarray,
    focals: np.ndarray,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Pad view arrays to a device multiple and build the validity mask."""
    n = world_to_cam.shape[0]
    n_dev = mesh.devices.size
    n_pad = pad_views(n, n_dev)
    w2c = np.concatenate(
        [world_to_cam]
        + [np.broadcast_to(np.eye(4), (n_pad - n, 4, 4))] * (1 if n_pad > n else 0),
        axis=0,
    )
    f = np.concatenate([focals, np.full((n_pad - n,), 1.0)], axis=0)
    valid = np.concatenate([np.ones(n), np.zeros(n_pad - n)], axis=0)
    sharding = NamedSharding(mesh, P(VIEW_AXIS))
    return (
        jax.device_put(jnp.asarray(w2c, jnp.float32), sharding),
        jax.device_put(jnp.asarray(f, jnp.float32), sharding),
        jax.device_put(jnp.asarray(valid, jnp.float32), sharding),
    )
