"""Aggregation ops + the core round-trip parity oracle:
render per-face labels into views, aggregate them back, recover the labels.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from geograypher_tpu.ops.aggregate import (
    accumulate_view,
    face_to_vert_texture,
    finalize_aggregation,
    find_argmax_nonzero_value,
    init_aggregation,
    project_image_class_counts,
    project_image_to_faces,
    render_texture,
    vert_to_face_discrete,
    vert_to_face_mean,
)
from geograypher_tpu.ops.rasterize import RasterConfig, rasterize_batch
from geograypher_tpu.utils.fixtures import (
    gather_tri_verts,
    make_grid_mesh,
    nadir_camera,
)

CFG = RasterConfig(caps=(768, 64, 32, 16))


def test_render_texture_gather():
    p2f = jnp.asarray([[0, 1], [-1, 2]], jnp.int32)
    tex = jnp.asarray([[10.0], [20.0], [30.0]])
    out = np.asarray(render_texture(p2f, tex))
    assert out.shape == (2, 2, 1)
    assert out[0, 0, 0] == 10 and out[0, 1, 0] == 20 and out[1, 1, 0] == 30
    assert np.isnan(out[1, 0, 0])


def test_project_image_to_faces_mean():
    p2f = jnp.asarray([[0, 0], [1, -1]], jnp.int32)
    img = jnp.asarray([[2.0, 4.0], [6.0, 99.0]])
    sums, counts = project_image_to_faces(p2f, img, n_faces=3)
    sums, counts = np.asarray(sums), np.asarray(counts)
    assert sums[0, 0] == 6.0 and counts[0, 0] == 2  # two pixels on face 0
    assert sums[1, 0] == 6.0 and counts[1, 0] == 1
    assert counts[2, 0] == 0  # unseen face
    # NaN pixels are ignored
    img_nan = jnp.asarray([[jnp.nan, 4.0], [6.0, 1.0]])
    sums, counts = project_image_to_faces(p2f, img_nan, n_faces=3)
    assert np.asarray(counts)[0, 0] == 1 and np.asarray(sums)[0, 0] == 4.0


def test_class_counts():
    p2f = jnp.asarray([[0, 0, 1, -1]], jnp.int32)
    cls = jnp.asarray([[2, 2, 0, 1]], jnp.int32)
    counts = np.asarray(project_image_class_counts(p2f, cls, n_faces=2, n_classes=3))
    assert counts[0, 2] == 2 and counts[1, 0] == 1
    assert counts.sum() == 3  # background pixel dropped


def test_aggregation_cross_view_average():
    state = init_aggregation(n_faces=2, n_channels=1)
    # view 1 sees face 0 (mean 2.0); view 2 sees both (means 4.0, 10.0)
    state = accumulate_view(
        state, jnp.asarray([[4.0], [0.0]]), jnp.asarray([[2.0], [0.0]])
    )
    state = accumulate_view(
        state, jnp.asarray([[4.0], [10.0]]), jnp.asarray([[1.0], [1.0]])
    )
    avg = np.asarray(finalize_aggregation(state))
    assert np.isclose(avg[0, 0], 3.0)  # (2 + 4) / 2 views
    assert np.isclose(avg[1, 0], 10.0)


def test_find_argmax_nonzero():
    arr = jnp.asarray([[0.0, 2.0], [0.0, 0.0], [jnp.inf, 1.0]])
    out = np.asarray(find_argmax_nonzero_value(arr))
    assert out[0] == 1.0
    assert np.isnan(out[1]) and np.isnan(out[2])


def test_vert_face_conversions():
    faces = jnp.asarray([[0, 1, 2], [1, 2, 3]], jnp.int32)
    labels = jnp.asarray([1.0, 1.0, 0.0, jnp.nan])
    out = np.asarray(vert_to_face_discrete(faces, labels, n_classes=2))
    assert out[0] == 1.0  # two votes for 1
    assert out[1] == 0.0  # tie 1 vs 0 -> lowest class wins deterministically

    vals = jnp.asarray([0.0, 3.0, 6.0, jnp.nan])
    out = np.asarray(vert_to_face_mean(faces, vals))
    assert np.isclose(out[0, 0], 3.0)
    assert np.isclose(out[1, 0], 4.5)  # nan vertex excluded

    fvals = jnp.asarray([2.0, 4.0])
    vt = np.asarray(face_to_vert_texture(faces, fvals, n_verts=4))
    assert np.isclose(vt[0, 0], 2.0)
    assert np.isclose(vt[1, 0], 3.0)  # vertex 1 touches both faces


def test_round_trip_parity():
    """The reference's core invariant, stated in SURVEY.md §7: render
    per-face labels to N views, aggregate the label images back onto the
    mesh, take the per-face argmax -> recover exactly the original labels
    for every observed face."""
    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.2 * np.sin(x) * np.sin(y)
    )
    n_faces = faces.shape[0]
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, n_faces)

    # Three cameras: nadir + two shifted/raised
    c2ws = []
    for dx, dz in ((0.0, 0.0), (0.6, 0.5), (-0.5, 1.0)):
        c2w = nadir_camera(4.0, 60.0, 120)
        c2w[0, 3] += dx
        c2w[2, 3] += dz
        c2ws.append(np.linalg.inv(c2w))
    w2c = jnp.asarray(np.stack(c2ws), jnp.float32)
    fs = jnp.full((3,), 60.0, jnp.float32)

    tri = jnp.asarray(gather_tri_verts(verts, faces), jnp.float32)
    p2f = rasterize_batch(tri, w2c, fs, image_w=120, image_h=120, config=CFG)

    # Forward: render the labels into each view
    tex = jnp.asarray(labels, jnp.float32)[:, None]
    rendered = render_texture(p2f, tex)  # (3, H, W, 1)

    # Reverse: aggregate rendered label images back per face
    state = init_aggregation(n_faces, 1)
    for v in range(3):
        sums, counts = project_image_to_faces(p2f[v], rendered[v], n_faces)
        state = accumulate_view(state, sums, counts)
    avg = np.asarray(finalize_aggregation(state))[:, 0]

    observed = np.asarray((p2f[..., None] == jnp.arange(n_faces)).any((0, 1, 2)))
    assert observed.sum() > n_faces * 0.5
    # Every observed face must recover its label exactly: each view's
    # per-face mean is over pixels of a single face -> the label itself.
    assert np.allclose(avg[observed], labels[observed])
    assert np.all(np.isnan(avg[~observed]))


@pytest.mark.parametrize(
    "seed, n_faces, n_classes", [(0, 50, 3), (1, 1000, 10), (2, 7, 1)]
)
def test_class_counts_match_bincount(seed, n_faces, n_classes):
    """The segment-sum counts equal np.bincount over (face, class) ids;
    background faces and out-of-range classes are dropped."""
    rng = np.random.default_rng(seed)
    p2f = rng.integers(-1, n_faces, (37, 53)).astype(np.int32)
    cls = rng.integers(-2, n_classes + 2, (37, 53)).astype(np.int32)
    counts = np.asarray(
        project_image_class_counts(p2f, cls, n_faces=n_faces,
                                   n_classes=n_classes)
    )
    ok = (p2f >= 0) & (cls >= 0) & (cls < n_classes)
    ref = np.bincount(
        p2f[ok].astype(np.int64) * n_classes + cls[ok],
        minlength=n_faces * n_classes,
    ).reshape(n_faces, n_classes)
    np.testing.assert_array_equal(counts, ref)


def test_class_counts_flat_index_guard():
    """(face, class) ids past int32 would wrap negative and be dropped
    silently: refused instead."""
    p2f = jnp.zeros((2, 2), jnp.int32)
    with pytest.raises(ValueError, match="int32"):
        project_image_class_counts(p2f, p2f, n_faces=2**28, n_classes=8)
