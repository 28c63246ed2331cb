"""Census-bucketed aggregation planner (parallel/planner.py).

The library-resident flagship plan must reproduce the exact per-view
counts, survive undersized caps via the overflow resize-retry doctrine,
and never raise after partial work.  Reference result: per-view
``fused_view_class_counts`` under generous static caps, summed on host.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    fused_view_class_counts,
    tri_to_soa,
)
from geograypher_tpu.parallel.planner import (
    PlannedAggregator,
    aggregate_counts_planned,
    pack_view_params,
    plan_aggregation,
)
from geograypher_tpu.utils.fixtures import (
    gather_tri_verts,
    make_grid_mesh,
    nadir_camera,
    oblique_camera,
)

H, W = 96, 256
N_CLASSES = 5
N_VIEWS = 6
BASE = RasterConfig(caps=(32, 16, 16, 16), bin_block=8, l0_window=(5, 2))


@pytest.fixture(scope="module")
def scene():
    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y)
    )
    n_faces = faces.shape[0]
    f_pad = -(-n_faces // 8) * 8
    tv = gather_tri_verts(verts, faces).astype(np.float32)
    if f_pad != n_faces:
        filler = np.broadcast_to(
            verts.mean(axis=0).astype(np.float32), (f_pad - n_faces, 3, 3)
        )
        tv = np.concatenate([tv, filler], axis=0)
    tri = jnp.asarray(tri_to_soa(tv))

    rng = np.random.default_rng(0)
    c2ws, fls = [], []
    for k in range(N_VIEWS):
        focal = (100.0, 130.0)[k % 2]
        if k % 2 == 0:
            c2w = nadir_camera(4.0, focal, W)
            c2w[0, 3] += rng.uniform(-0.3, 0.3)
        else:
            c2w = oblique_camera(
                4.0, focal, W, pitch_deg=float(rng.uniform(15.0, 33.0)),
                azimuth_deg=float(360.0 * k / N_VIEWS),
            )
        c2ws.append(c2w)
        fls.append(focal)
    w2c = np.stack([np.linalg.inv(m) for m in c2ws]).astype(np.float32)
    params = pack_view_params(w2c, np.asarray(fls, np.float32))
    labels = np.asarray(
        jax.random.randint(
            jax.random.PRNGKey(3), (N_VIEWS, H, W), 0, N_CLASSES, jnp.int32
        )
    )
    return tri, f_pad, params, labels


def _reference_counts(tri, f_pad, params, labels):
    """Per-view fused counts under generous caps, summed on host."""
    cfg = dataclasses.replace(BASE, caps=(64, 32, 32, 32))
    total = np.zeros((f_pad, N_CLASSES), np.float64)
    for k in range(params.shape[0]):
        row = jnp.asarray(params[k])
        counts, over = fused_view_class_counts(
            tri, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
            row[26], jnp.asarray(labels[k]), W, H, cfg, f_pad, N_CLASSES,
            False,
        )
        assert int(np.asarray(over)) == 0
        total += np.asarray(counts, np.float64)
    return total


def test_planned_matches_reference(scene):
    tri, f_pad, params, labels = scene
    counts, plan = aggregate_counts_planned(
        tri, params, labels, BASE, H, W, f_pad, N_CLASSES,
        max_buckets=2, group=3,
    )
    ref = _reference_counts(tri, f_pad, params, labels)
    assert plan.plan_seconds > 0
    assert counts.shape == (f_pad, N_CLASSES)
    assert ref.sum() > 0
    np.testing.assert_array_equal(counts, ref)


def test_bucketing_splits_nadir_oblique(scene):
    tri, f_pad, params, labels = scene
    plan = plan_aggregation(tri, params, BASE, H, W, f_pad, max_buckets=4)
    # every view lands in exactly one bucket
    seen = sorted(i for b in plan.buckets for i in b.view_indices)
    assert seen == list(range(N_VIEWS))
    # the cover config's caps dominate every bucket's
    cover = plan.cover_config
    for b in plan.buckets:
        assert all(c >= bc for c, bc in zip(cover.caps, b.config.caps))
    # the plan split the mixed survey by caps
    assert len(plan.buckets) >= 2
    assert len({b.config.caps for b in plan.buckets}) == len(plan.buckets)


def test_census_caps_cover_every_view(scene):
    """An exact census sizes each bucket's caps to cover every one of its
    views: binning under the bucket config drops nothing."""
    from geograypher_tpu.ops.rasterize import bin_triangles, setup_from_soa

    tri, f_pad, params, labels = scene
    plan = plan_aggregation(tri, params, BASE, H, W, f_pad, max_buckets=4)
    assert not plan.sampled
    for b in plan.buckets:
        for k in b.view_indices:
            row = jnp.asarray(params[k])
            setup = setup_from_soa(
                tri, row[:16].reshape(4, 4), row[16], W, H
            )
            binned = bin_triangles(setup, b.config, H, W)
            assert int(binned.overflow) == 0


def _reference_weighted(tri, f_pad, params, labels):
    """Per-view fused counts normalized per face (f32, like the device),
    averaged over seeing views: (value_sum, view_count)."""
    cfg = dataclasses.replace(BASE, caps=(64, 32, 32, 32))
    value_sum = np.zeros((f_pad, N_CLASSES), np.float32)
    view_count = np.zeros((f_pad,), np.float32)
    for k in range(params.shape[0]):
        row = jnp.asarray(params[k])
        counts, over = fused_view_class_counts(
            tri, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
            row[26], jnp.asarray(labels[k]), W, H, cfg, f_pad, N_CLASSES,
            False,
        )
        assert int(np.asarray(over)) == 0
        counts = np.asarray(counts, np.float32)
        tot = counts.sum(axis=1, dtype=np.float32)
        seen = tot > 0
        value_sum += np.where(
            seen[:, None],
            counts / np.maximum(tot, 1.0).astype(np.float32)[:, None],
            0.0,
        ).astype(np.float32)
        view_count += seen.astype(np.float32)
    return value_sum, view_count


def test_weighted_planned_matches_reference(scene):
    """The weighted planned path must reproduce the reference's
    view-weighted aggregate_projected_images semantics (per view,
    per-face distribution counts/total; averaged over seeing views)."""
    from geograypher_tpu.parallel.planner import aggregate_projected_planned

    tri, f_pad, params, labels = scene
    value_sum, view_count, plan = aggregate_projected_planned(
        tri, params, labels, BASE, H, W, f_pad, N_CLASSES,
        max_buckets=2, group=3,
    )
    ref_vs, ref_vc = _reference_weighted(tri, f_pad, params, labels)
    np.testing.assert_array_equal(view_count, ref_vc)
    assert ref_vc.max() >= 2  # some faces genuinely multi-view
    np.testing.assert_allclose(value_sum, ref_vs, rtol=1e-6, atol=1e-7)


def test_global_level_planning():
    """Meshes with a non-empty GLOBAL census level (irregular TINs with
    locally large faces): the census sizes the global list's cap too, so
    plan + grouped run completes with ZERO resizes and exact counts."""
    from geograypher_tpu.utils.fixtures import make_irregular_mesh

    h, w = 96, 512
    cfg = dataclasses.replace(BASE, level_scales=(1, 2, 4))
    verts, faces = make_irregular_mesh(n_points=1200, size=4.0, seed=2)
    # three mesh-spanning triangles: bboxes exceed the 2x2 L2 window
    big_tris = np.array(
        [
            [[-2, -2, 0.3], [2, -2, 0.3], [0, 2, 0.3]],
            [[-2, 2, 0.25], [2, 2, 0.25], [0, -2, 0.25]],
            [[-2, 0, 0.2], [2, 0.5, 0.2], [0.5, 2, 0.2]],
        ],
        np.float32,
    )
    f_n = faces.shape[0] + 3
    f_pad = -(-f_n // 8) * 8
    tv = np.concatenate(
        [gather_tri_verts(verts, faces).astype(np.float32), big_tris]
    )
    tv = np.concatenate(
        [
            tv,
            np.broadcast_to(
                verts.mean(0).astype(np.float32), (f_pad - f_n, 3, 3)
            ),
        ]
    )
    tri = jnp.asarray(tri_to_soa(tv))
    c2ws, fls = [], []
    for k in range(4):
        focal = (220.0, 260.0)[k % 2]
        c2w = (
            nadir_camera(4.0, focal, w)
            if k % 2 == 0
            else oblique_camera(
                4.0, focal, w, pitch_deg=float(15 + 4 * k),
                azimuth_deg=90.0 * k,
            )
        )
        c2ws.append(np.linalg.inv(c2w))
        fls.append(focal)
    params = pack_view_params(
        np.stack(c2ws).astype(np.float32), np.asarray(fls, np.float32)
    )
    labels = np.asarray(
        jax.random.randint(
            jax.random.PRNGKey(5), (4, h, w), 0, N_CLASSES, jnp.int32
        )
    )
    plan = plan_aggregation(tri, params, cfg, h, w, f_pad, max_buckets=2)
    agg = PlannedAggregator(plan, N_CLASSES, group=4)
    agg.prepare(tri, params, labels)
    agg.run()
    counts = agg.finalize()
    assert agg.resizes == 0, "an exact census must never resize"
    ref_cfg = dataclasses.replace(cfg, caps=(64, 32, 32, 48))
    ref = np.zeros_like(counts)
    for k in range(4):
        row = jnp.asarray(params[k])
        c, over = fused_view_class_counts(
            tri, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
            row[26], jnp.asarray(labels[k]), w, h, ref_cfg, f_pad,
            N_CLASSES, False,
        )
        assert int(np.asarray(over)) == 0
        ref = ref + np.asarray(c)
    np.testing.assert_array_equal(counts, ref)


def test_undersized_bucket_caps_retry(scene, caplog):
    """Groups whose bucket caps are too small drop candidates: their
    contribution is gated to zero, and finalize re-censuses and re-runs
    exactly those views, so the result stays exact."""
    import logging as _logging

    tri, f_pad, params, labels = scene
    plan = plan_aggregation(tri, params, BASE, H, W, f_pad, max_buckets=1)
    b = plan.buckets[0]
    bad = dataclasses.replace(
        plan,
        buckets=(
            dataclasses.replace(
                b, config=dataclasses.replace(b.config, caps=(8, 4, 4, 4))
            ),
        ),
    )
    agg = PlannedAggregator(bad, N_CLASSES, group=3)
    agg.prepare(tri, params, labels)
    agg.run()
    with caplog.at_level(
        _logging.WARNING, logger="geograypher_tpu.parallel.planner"
    ):
        counts = agg.finalize()
    assert any("re-censusing" in r.message for r in caplog.records)
    assert agg.resizes == 1
    np.testing.assert_array_equal(
        counts, _reference_counts(tri, f_pad, params, labels)
    )


@pytest.mark.slow
def test_sampled_census_retry_completes(scene):
    """A sampled census that only sees a benign (nadir) view must still
    produce exact counts: hostile views overflow, their groups contribute
    zero, and finalize re-censuses + re-runs them (never raises, never
    drops counts)."""
    tri, f_pad, params, labels = scene
    # order the views nadir-first so sample index 0 censuses a nadir view
    plan = plan_aggregation(
        tri, params, BASE, H, W, f_pad, max_buckets=1,
        census_sample=1, sample_extra_margin=1.0,
    )
    assert plan.sampled
    agg = PlannedAggregator(plan, N_CLASSES, group=2)
    agg.prepare(tri, params, labels)
    assert all(g == 2 for _s, g, _b in agg._programs)
    agg.run()
    counts = agg.finalize()
    ref = _reference_counts(tri, f_pad, params, labels)
    np.testing.assert_array_equal(counts, ref)
    assert agg.resizes > 0


def test_label_index_shares_rows(scene):
    """1000-view-style label sharing: views map onto a smaller label
    stack; counts must equal running the full expanded stack."""
    tri, f_pad, params, labels = scene
    label_index = np.arange(N_VIEWS) % 2  # all views share 2 label rows
    counts, _ = aggregate_counts_planned(
        tri, params, labels[:2], BASE, H, W, f_pad, N_CLASSES,
        max_buckets=2, group=3, label_index=label_index,
    )
    expanded = labels[label_index]
    ref = _reference_counts(tri, f_pad, params, expanded)
    np.testing.assert_array_equal(counts, ref)


@pytest.mark.slow
def test_mesh_planned_aggregation(scene):
    """TexturedMesh.aggregate_class_images_planned: the flagship plan
    through the public mesh API, with plan caching."""
    from geograypher_tpu.cameras.core import CameraSet
    from geograypher_tpu.meshes.mesh import TexturedMesh

    verts, faces = make_grid_mesh(
        n=21, size=4.0, z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y)
    )
    tmesh = TexturedMesh((verts, faces), raster_config=BASE)
    rng = np.random.default_rng(0)
    c2ws, fls = [], []
    for k in range(4):
        focal = (100.0, 130.0)[k % 2]
        if k % 2 == 0:
            c2w = nadir_camera(4.0, focal, W)
        else:
            c2w = oblique_camera(
                4.0, focal, W, pitch_deg=25.0, azimuth_deg=90.0 * k
            )
        c2ws.append(c2w)
        fls.append(focal)
    sensors = {
        si: {
            "f": f, "cx": 0.0, "cy": 0.0,
            "image_width": W, "image_height": H,
        }
        for si, f in enumerate((100.0, 130.0))
    }
    cams = CameraSet(c2ws, sensors, sensor_IDs=[k % 2 for k in range(4)])
    label_imgs = [
        rng.integers(0, N_CLASSES, (H, W)).astype(np.int32) for _ in range(4)
    ]
    counts, plan = tmesh.aggregate_class_images_planned(
        cams, N_CLASSES, class_image_provider=lambda i: label_imgs[i],
        max_buckets=2, group=2,
    )
    assert counts.shape == (tmesh.n_faces, N_CLASSES)

    tri = tmesh._tri_soa_device(cams)
    batch = cams.get_camera_batch()
    from geograypher_tpu.parallel.planner import pack_camera_batch

    params = pack_camera_batch(batch, np.ones(4, np.float32))
    f_bucket = tmesh._face_bucket(tmesh.n_faces)
    ref = _reference_counts(tri, f_bucket, params, np.stack(label_imgs))
    np.testing.assert_array_equal(counts, ref[: tmesh.n_faces])
    assert ref[tmesh.n_faces:].sum() == 0  # padding faces see nothing

    # second call reuses the cached plan (no fresh census)
    counts2, plan2 = tmesh.aggregate_class_images_planned(
        cams, N_CLASSES, class_image_provider=lambda i: label_imgs[i],
        max_buckets=2, group=2,
    )
    assert plan2 is plan
    np.testing.assert_array_equal(counts2, counts)

    # the weighted variant through the mesh API: reference
    # aggregate_projected_images semantics, same plan cache
    avg, info = tmesh.aggregate_projected_images_planned(
        cams, N_CLASSES, class_image_provider=lambda i: label_imgs[i],
        max_buckets=2, group=2,
    )
    assert info["plan"] is plan
    ref_vs, ref_vc = _reference_weighted(
        tri, f_bucket, params, np.stack(label_imgs)
    )
    np.testing.assert_array_equal(
        info["projection_counts"], ref_vc[: tmesh.n_faces]
    )
    np.testing.assert_allclose(
        info["summed_projections"], ref_vs[: tmesh.n_faces],
        rtol=1e-6, atol=1e-7,
    )
    seen = ref_vc[: tmesh.n_faces] > 0
    assert np.isnan(avg[~seen]).all()
    assert np.isfinite(avg[seen]).all()
    # averages are distributions: rows sum to 1 on seen faces
    np.testing.assert_allclose(
        avg[seen].sum(axis=1), 1.0, rtol=1e-5
    )


def test_plan_reuse(scene):
    """A plan from one survey can be reused for identical cameras."""
    tri, f_pad, params, labels = scene
    counts1, plan = aggregate_counts_planned(
        tri, params, labels, BASE, H, W, f_pad, N_CLASSES, max_buckets=2,
        group=3,
    )
    labels2 = np.ascontiguousarray(labels[::-1])
    counts2, _ = aggregate_counts_planned(
        tri, params, labels2, BASE, H, W, f_pad, N_CLASSES, plan=plan,
        group=3,
    )
    ref2 = _reference_counts(tri, f_pad, params, labels2)
    np.testing.assert_array_equal(counts2, ref2)
    assert counts1.sum() == ref2.sum()  # same pixels, permuted labels
