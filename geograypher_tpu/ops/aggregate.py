"""Gather/scatter ops: render textures into views, project views onto faces.

Replacement for the reference's per-pixel indexing loops:

* ``render_texture``   <- meshes.py:1896-1904 (render_flat's gather)
* ``project_image_to_faces`` <- meshes.py:1961-1968 (project_images' scatter)
* ``accumulate_view`` / ``finalize_aggregation``
                       <- meshes.py:2016-2051 (aggregate_projected_images)

Semantics note (deliberate fix, SURVEY.md §5): the reference's projection
scatter is last-pixel-wins and acknowledged "ill-defined" when several
pixels land on one face (meshes.py:1965-1967).  Here a face's per-view value
is the MEAN over all its covering pixels (deterministic, and strictly more
information); cross-view aggregation then averages per-view values over the
views that saw the face, exactly like the reference's nansum/count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("background",))
def render_texture(
    pix2face: jax.Array,
    face_texture: jax.Array,
    background: float = float("nan"),
) -> jax.Array:
    """Gather per-face texture into an image.

    Args:
        pix2face: (..., H, W) int32 face ids, -1 background.
        face_texture: (F, C) float per-face texture.
        background: fill value for background pixels.

    Returns:
        (..., H, W, C) rendered image.
    """
    tex = face_texture[jnp.clip(pix2face, 0, None)]
    return jnp.where(
        (pix2face >= 0)[..., None], tex, jnp.asarray(background, tex.dtype)
    )


@functools.partial(jax.jit, static_argnames=("n_faces",))
def project_image_to_faces(
    pix2face: jax.Array,
    image: jax.Array,
    n_faces: int,
) -> Tuple[jax.Array, jax.Array]:
    """Scatter one view's pixels onto mesh faces.

    Args:
        pix2face: (H, W) int32.
        image: (H, W) or (H, W, C) pixel values; NaNs are ignored.
        n_faces: number of mesh faces (static).

    Returns:
        sums: (n_faces, C) sum of finite pixel values per face
        counts: (n_faces, C) number of finite pixels per face
    """
    if image.ndim == 2:
        image = image[..., None]
    c = image.shape[-1]
    flat_face = pix2face.reshape(-1)
    flat_img = image.reshape(-1, c).astype(jnp.float32)
    finite = jnp.isfinite(flat_img)
    hit = (flat_face >= 0)[:, None] & finite
    vals = jnp.where(hit, flat_img, 0.0)
    # background pixels scatter to segment n_faces (dropped)
    seg = jnp.where(flat_face >= 0, flat_face, n_faces)
    sums = jax.ops.segment_sum(vals, seg, num_segments=n_faces + 1)[:-1]
    counts = jax.ops.segment_sum(
        hit.astype(jnp.float32), seg, num_segments=n_faces + 1
    )[:-1]
    return sums, counts


@functools.partial(jax.jit, static_argnames=("n_faces", "n_classes"))
def project_image_class_counts(
    pix2face: jax.Array,
    class_image: jax.Array,
    n_faces: int,
    n_classes: int,
) -> jax.Array:
    """Per-face per-class pixel counts for a discrete label image.

    Pixels with class < 0 or face -1 are ignored.  One segment-sum over
    flattened (face, class) ids — a scatter-add with atomics on the GPU.
    Float32 sums of ones are exact in any order below 2^24 per bucket.

    Returns (n_faces, n_classes) float32 counts.
    """
    if n_faces * n_classes + 1 >= 2**31:
        # flattened (face, class) ids ride int32 (JAX default; int64
        # would silently truncate without jax_enable_x64) — overflow
        # here would wrap negative and segment_sum DROPS negative ids
        raise ValueError(
            f"n_faces * n_classes = {n_faces * n_classes} overflows the "
            "int32 flattened segment index — aggregate class subsets in "
            "chunks (e.g. via meshes/sparse.py's per-view local remap)"
        )
    flat_face = pix2face.reshape(-1)
    flat_cls = class_image.reshape(-1).astype(jnp.int32)
    ok = (flat_face >= 0) & (flat_cls >= 0) & (flat_cls < n_classes)
    seg = jnp.where(ok, flat_face * n_classes + flat_cls, n_faces * n_classes)
    counts = jax.ops.segment_sum(
        jnp.ones_like(seg, jnp.float32), seg, num_segments=n_faces * n_classes + 1
    )[:-1]
    return counts.reshape(n_faces, n_classes)


class AggregationState(NamedTuple):
    """Running cross-view accumulators (all shapes static)."""

    value_sum: jax.Array  # (F, C) sum over views of per-view mean values
    view_count: jax.Array  # (F,) number of views that saw each face


def init_aggregation(n_faces: int, n_channels: int) -> AggregationState:
    return AggregationState(
        value_sum=jnp.zeros((n_faces, n_channels), jnp.float32),
        view_count=jnp.zeros((n_faces,), jnp.float32),
    )


@jax.jit
def accumulate_view(
    state: AggregationState, sums: jax.Array, counts: jax.Array
) -> AggregationState:
    """Fold one view's per-face (sums, counts) into the running state."""
    seen = jnp.any(counts > 0, axis=1)
    mean = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), 0.0)
    return AggregationState(
        value_sum=state.value_sum + mean,
        view_count=state.view_count + seen.astype(jnp.float32),
    )


@jax.jit
def finalize_aggregation(state: AggregationState) -> jax.Array:
    """(F, C) average projection per face; NaN where no view saw the face
    (matching meshes.py:2037-2051)."""
    seen = state.view_count > 0
    avg = state.value_sum / jnp.maximum(state.view_count, 1.0)[:, None]
    return jnp.where(seen[:, None], avg, jnp.nan)


def find_argmax_nonzero_value(
    array: jax.Array, keepdims: bool = False, axis: int = 1
) -> jax.Array:
    """Argmax with NaN rows for zero-sum or non-finite rows
    (port of reference utils/indexing.py:9-33)."""
    argmax = jnp.argmax(array, axis=axis, keepdims=keepdims).astype(jnp.float32)
    zero_sum = jnp.sum(array, axis=axis) == 0
    non_finite = jnp.any(~jnp.isfinite(array), axis=axis)
    bad = zero_sum | non_finite
    if keepdims:
        bad = jnp.expand_dims(bad, axis)
    return jnp.where(bad, jnp.nan, argmax)


# ---------------------------------------------------------------------------
# Vertex <-> face texture conversion (votes)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_classes",))
def vert_to_face_discrete(
    faces: jax.Array, vert_labels: jax.Array, n_classes: int
) -> jax.Array:
    """Per-face mode of its 3 vertices' integer labels.

    Vote kernel replacing the reference's chunked ``fair_mode_non_nan``
    (meshes.py:928-963, numeric.py:622-659).  NaN vertex labels don't vote;
    ties break toward the LOWEST class id (deterministic; the reference
    randomizes).  Returns float with NaN where no vertex voted.
    """
    tri_labels = vert_labels[faces]  # (F, 3)
    votes = jnp.stack(
        [jnp.sum(tri_labels == c, axis=1) for c in range(n_classes)], axis=1
    ).astype(jnp.float32)
    has_vote = jnp.sum(votes, axis=1) > 0
    winner = jnp.argmax(votes, axis=1).astype(jnp.float32)
    return jnp.where(has_vote, winner, jnp.nan)


@jax.jit
def vert_to_face_mean(faces: jax.Array, vert_values: jax.Array) -> jax.Array:
    """Per-face nan-mean of its 3 vertices' continuous values."""
    tri = vert_values[faces]  # (F, 3, C) or (F, 3)
    if tri.ndim == 2:
        tri = tri[..., None]
    finite = jnp.isfinite(tri)
    s = jnp.sum(jnp.where(finite, tri, 0.0), axis=1)
    n = jnp.sum(finite, axis=1)
    return jnp.where(n > 0, s / jnp.maximum(n, 1), jnp.nan)


@functools.partial(jax.jit, static_argnames=("n_verts",))
def face_to_vert_texture(
    faces: jax.Array, face_values: jax.Array, n_verts: int
) -> jax.Array:
    """Mean of adjacent faces' values per vertex.

    The reference declares this NotImplemented (meshes.py:913-926); provided
    here since it falls out of a segment mean.
    """
    if face_values.ndim == 1:
        face_values = face_values[:, None]
    c = face_values.shape[-1]
    vid = faces.reshape(-1)
    vals = jnp.repeat(face_values, 3, axis=0)
    finite = jnp.all(jnp.isfinite(vals), axis=-1, keepdims=True)
    sums = jax.ops.segment_sum(
        jnp.where(finite, vals, 0.0), vid, num_segments=n_verts
    )
    counts = jax.ops.segment_sum(
        finite.astype(jnp.float32), vid, num_segments=n_verts
    )
    return jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), jnp.nan)
