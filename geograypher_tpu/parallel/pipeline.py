"""Distributed aggregation pipeline: host image loading overlapped with
sharded device compute.

The production path for ``aggregate_images`` at survey scale: a thread
pool loads + segments label images ahead of the device (cv2/PIL release
the GIL), class-index images are shipped as int8 (1 byte/pixel), and each
device in the view-axis mesh rasterizes + aggregates its own views
(setup -> binning -> resolve -> segment-sum counts,
``ops.rasterize.rasterize_and_count``).  Per-face accumulators stay DEVICE
RESIDENT across view groups (donated into each step, one host fetch at
the end) and are psum-combined across devices inside each step.

Throughput structure:

* ``views_per_step`` views run per device per jitted step (python-
  unrolled inside the program);
* all per-view camera scalars are packed into ONE ``(n_dev, G, 28)``
  row array — exactly two host->device transfers per step (params +
  the int8 image stack);
* the accumulators are donated, so steps update them in place.

Capacity doctrine: the binning caps are census-bucketed per view by the
library planner (``parallel/planner.py``), and every view's binning
overflow is measured inside the step — a step exceeding its static caps
contributes NOTHING to the accumulator (gated on overflow == 0) and is
re-censused, re-sized, and re-run at the end instead of silently dropping
counts or raising after partial work.

Lens distortion is applied IN the rasterizer (vertices warped into the
sensor's distorted pixel space — ``setup_from_soa(distortion=...)``),
matching the single-device production path; the reference instead warps
the rendered map through a NN remap (meshes.py:1805-1821), which this
supersedes with sub-pixel accuracy at survey triangle sizes.

Semantics match ``TexturedMesh.aggregate_projected_images`` over one-hot
segmentor images exactly: each view contributes its per-face class
fraction (class pixel counts / face pixel count — the per-view mean of
the one-hot image), and the cross-view result averages those per-view
fractions over the views that saw the face (VIEW-weighted, exactly like
``ops.aggregate.accumulate_view`` / ``finalize_aggregation``), not a
pixel-weighted pool of raw counts.
"""

from __future__ import annotations

import concurrent.futures
import functools
import logging
import time
import typing

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    rasterize_and_count,
    setup_from_soa,
)
from geograypher_tpu.parallel.planner import (
    PROW,
    pack_camera_batch,
    plan_aggregation,
    unpack_row,
)
from geograypher_tpu.parallel.sharding import VIEW_AXIS, make_view_mesh

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# RLE label transport.  Real segmentation label images are spatially
# coherent (large constant regions), so shipping them over the
# host->device link as dense pixels wastes nearly all the bytes: the
# run-length form is typically 10-100x smaller.  The device reconstructs
# the dense image EXACTLY with one scatter-add of per-run value DELTAS at
# the run starts followed by an integer cumsum.
# ---------------------------------------------------------------------------


def _rle_encode_class_image(img: np.ndarray, cap: int):
    """Row-major RLE of an integer class image, scatter-decode form.

    Returns (starts (cap,) int32, deltas (cap,) int8, n_runs) with
    padding starts = img.size (dropped by the device scatter's
    ``mode="drop"``), or None when the image needs more than ``cap``
    runs (caller falls back to dense transport).  Deltas telescope:
    ``cumsum(scatter(deltas at starts)) == flat image`` exactly.  Class
    values must fit int8 after deltas, i.e. classes in [-1, 126] — the
    int8 dense transport has the same bound.
    """
    flat = np.ascontiguousarray(img, dtype=np.int16).ravel()
    change = np.nonzero(np.diff(flat))[0]
    n_runs = change.size + 1
    if n_runs > cap:
        return None
    starts = np.empty(cap, np.int32)
    starts[0] = 0
    starts[1:n_runs] = change + 1
    starts[n_runs:] = flat.size
    vals = flat[starts[:n_runs]]
    deltas = np.zeros(cap, np.int16)
    deltas[0] = vals[0]
    deltas[1:n_runs] = np.diff(vals)
    return starts, deltas.astype(np.int8), n_runs


def _rle_decode_device(starts: jax.Array, deltas: jax.Array, h: int, w: int):
    """Exact device-side inverse of :func:`_rle_encode_class_image`."""
    d = (
        jnp.zeros((h * w,), jnp.int32)
        .at[starts]
        .add(deltas.astype(jnp.int32), mode="drop")
    )
    return jnp.cumsum(d).reshape(h, w)


# ---------------------------------------------------------------------------
# Program builders.  jax.jit caches per wrapped-function OBJECT, so programs
# must be built once per static configuration and reused across
# ``aggregate_class_images_distributed`` calls — a fresh closure per call
# would recompile the full multi-view 4K program every time.  All static
# context rides in the hashable cache key.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _build_device_step(
    device_mesh: Mesh, config: RasterConfig, use_dist: bool,
    group: int, w: int, h: int, n_faces: int, n_classes: int,
    rle_cap: int = 0,
):
    """The jitted per-step program.

    With ``rle_cap > 0`` the image operand is the RLE pair
    ``(starts (n_dev, G, cap) int32, deltas (n_dev, G, cap) int8)`` and
    each view's class image is reconstructed on device
    (:func:`_rle_decode_device`) — the host->device transfer shrinks
    from h*w bytes to 5*cap per view."""

    @functools.partial(jax.jit, donate_argnums=(3, 4))
    def device_step(tri_soa, params_shard, imgs_shard, acc_fracs, acc_views):
        def per_device(tri_soa, params_b, imgs_b, acc_fracs, acc_views):
            # collapse the local-shard=1 leading axis
            params_b = params_b.reshape(-1, PROW)
            if rle_cap:
                starts_b, deltas_b = imgs_b
                starts_b = starts_b.reshape(-1, rle_cap)
                deltas_b = deltas_b.reshape(-1, rle_cap)
            else:
                imgs_b = imgs_b.reshape((-1,) + imgs_b.shape[2:])

            fracs = jnp.zeros((n_faces, n_classes), jnp.float32)
            views = jnp.zeros((n_faces,), jnp.float32)
            over = jnp.zeros((), jnp.int32)
            for k in range(group):
                w2c_k, f_k, dist_k, valid_k = unpack_row(
                    params_b[k], use_dist
                )
                setup = setup_from_soa(
                    tri_soa, w2c_k, f_k, w, h, config.znear,
                    distortion=dist_k,
                )
                if rle_cap:
                    cls_k = _rle_decode_device(starts_b[k], deltas_b[k], h, w)
                else:
                    cls_k = imgs_b[k].astype(jnp.int32)
                counts, over_k = rasterize_and_count(
                    setup, cls_k, config, h, w, n_faces, n_classes
                )
                counts = counts * valid_k
                over = jnp.maximum(
                    over, over_k * valid_k.astype(jnp.int32)
                )
                face_total = jnp.sum(counts, axis=1)
                seen = (face_total > 0).astype(jnp.float32)
                # per-view class fraction: this view's vote, weighted
                # equally with every other view that saw the face
                fracs = fracs + counts / jnp.maximum(face_total, 1.0)[:, None]
                views = views + seen
            # overflow gating (resize-and-retry doctrine, planner.py): a
            # step whose static caps would drop candidates contributes
            # NOTHING — the caller re-sizes and re-runs it, so the
            # accumulator never mixes in undercounted views.  The gate is
            # global (pmax) so the step is atomic across devices.
            over_all = jax.lax.pmax(over, VIEW_AXIS)
            gate = (over_all == 0).astype(jnp.float32)
            return (
                acc_fracs + jax.lax.psum(fracs, VIEW_AXIS) * gate,
                acc_views + jax.lax.psum(views, VIEW_AXIS) * gate,
                over_all,
            )

        return jax.shard_map(
            per_device,
            mesh=device_mesh,
            in_specs=(P(), P(VIEW_AXIS), P(VIEW_AXIS), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )(tri_soa, params_shard, imgs_shard, acc_fracs, acc_views)

    return device_step


def aggregate_class_images_distributed(
    mesh,
    cameras,
    n_classes: int,
    class_image_provider: typing.Optional[typing.Callable[[int], np.ndarray]] = None,
    aggregate_img_scale: float = 1.0,
    device_mesh: typing.Optional[Mesh] = None,
    prefetch_workers: int = 4,
    config: typing.Optional[RasterConfig] = None,
    apply_distortion: typing.Optional[bool] = None,
    views_per_step: int = 4,
    plan_caps: bool = True,
    label_transport: str = "auto",
):
    """Aggregate per-view class images onto mesh faces across all devices.

    Args:
        mesh: TexturedMesh.
        cameras: CameraSet (or SegmentorCameraSet).
        n_classes: number of classes in the label images.
        class_image_provider: ``f(view_index) -> (H, W)`` integer class
            image (negative/255 = unlabeled).  Defaults to argmaxing
            ``cameras.get_image_by_index`` (segmentor one-hots).
        aggregate_img_scale: label/raster scale fraction.
        device_mesh: jax device mesh (defaults to all devices).
        apply_distortion: None (default) rasterizes each view directly in
            the sensor's distorted pixel space whenever the sensor is
            calibrated with distortion (reference behavior:
            meshes.py:1805-1821, via NN remap there); False disables.
        views_per_step: views processed per device per jitted step.
        plan_caps: census-bucket the binning caps per view through the
            library planner (default).  When False, ``config.caps`` runs
            every step in view order.  Either way, a step exceeding its
            static caps contributes nothing (gated on overflow == 0), is
            re-censused, re-sized, and re-run — never silently dropped
            and never raised after partial work.
        label_transport: "auto" (default), "dense", or "rle".  Real
            segmentation masks are spatially coherent, so their
            run-length form is typically 10-100x smaller than dense
            pixels — decisive when the host->device link, not compute,
            bounds the pipeline.  "auto" probes the first step's images
            and picks RLE when it saves >= 2x bytes; the capacity is
            sized at 2x the probed worst run count, and any later step
            whose images exceed it falls back to the dense program for
            that step (correct, just slower).  Decoding on device is
            exact (scatter of run deltas + integer cumsum).

    Returns (fraction_sums (F, n_classes), view_counts (F,)) as numpy
    arrays: ``fraction_sums`` is the sum over views of each view's
    per-face class fraction; the cross-view average is
    ``fraction_sums / view_counts`` (NaN where ``view_counts == 0``),
    identical to ``TexturedMesh.aggregate_projected_images``.
    """
    if device_mesh is None:
        device_mesh = make_view_mesh()
    n_dev = device_mesh.devices.size
    group = max(1, int(views_per_step))
    config = config or mesh.raster_config
    n_faces = mesh.n_faces
    # device-resident (9, F) SOA, cached on the mesh
    tri_soa = mesh._tri_soa_device(cameras)
    batch = cameras.get_camera_batch(image_scale=aggregate_img_scale)
    h, w = batch.image_height, batch.image_width

    if class_image_provider is None:

        def class_image_provider(i: int) -> np.ndarray:
            img = np.asarray(cameras.get_image_by_index(i, aggregate_img_scale))
            if img.ndim == 3:
                finite = np.isfinite(img).all(axis=-1)
                cls = np.argmax(np.nan_to_num(img), axis=-1)
                return np.where(finite, cls, -1).astype(np.int32)
            return np.nan_to_num(img, nan=-1).astype(np.int32)

    sharding = NamedSharding(device_mesh, P(VIEW_AXIS))
    replicated = NamedSharding(device_mesh, P())

    use_dist = bool(
        (apply_distortion is None or apply_distortion)
        and (
            np.any(np.asarray(batch.distortion))
            or np.any(np.asarray(batch.cx))
            or np.any(np.asarray(batch.cy))
        )
    )

    n = len(cameras)
    step_views = n_dev * group
    params_all = pack_camera_batch(batch, np.ones(n, np.float32))

    # -- census-bucketed step plan ---------------------------------------------
    # ONE worst-case config across a mixed nadir/oblique survey would run
    # every view at oblique-sized caps; reuse the library planner to census
    # the views, bucket them, and run bucket-homogeneous steps at each
    # bucket's own caps.  Bucket tails shorter than a step run under one
    # covering config so padding stays < 1 step per bucket.  The plan is
    # cached on the MESH keyed by everything the census sees; geometry
    # edits clear it via _invalidate_geometry_caches.  Reference anchor:
    # the per-camera python loop this pipelines, meshes.py:1911-2051.
    if plan_caps and n > 0:
        cache = getattr(mesh, "_pipeline_cfg_cache", None)
        if cache is None:
            cache = mesh._pipeline_cfg_cache = {}
        plan_key = (config, use_dist, w, h, cameras.get_camera_hash())
        plan = cache.get(plan_key)
        if plan is None:
            plan = plan_aggregation(
                tri_soa, params_all, config, h, w, n_faces,
                use_dist=use_dist,
                census_sample=None if n <= 64 else max(12, n // 16),
            )
            cache[plan_key] = plan
        step_specs: list = []  # (config index, view ids of this step)
        tail: list = []
        for bi, b in enumerate(plan.buckets):
            idxs = list(b.view_indices)
            nfull = len(idxs) // step_views * step_views
            for s0 in range(0, nfull, step_views):
                step_specs.append((bi, idxs[s0:s0 + step_views]))
            tail.extend(idxs[nfull:])
        for s0 in range(0, len(tail), step_views):
            step_specs.append((len(plan.buckets), tail[s0:s0 + step_views]))
        step_configs = [b.config for b in plan.buckets] + [plan.cover_config]
    else:
        step_specs = [
            (0, list(range(s0, min(s0 + step_views, n))))
            for s0 in range(0, n, step_views)
        ]
        step_configs = [config]
    order, valid_l, step_cfg_idx = [], [], []
    for ci, ids in step_specs:
        pad = step_views - len(ids)
        order.extend(ids + [ids[0]] * pad)
        valid_l.extend([1.0] * len(ids) + [0.0] * pad)
        step_cfg_idx.append(ci)
    n_pad = len(order)
    params = params_all[order]
    params[:, PROW - 1] = np.asarray(valid_l, np.float32)

    img_dtype = np.int8 if n_classes < 128 else np.int32

    # -- label transport selection --------------------------------------------
    # RLE requires int8-range classes (deltas must fit int8) and pays off
    # only when runs are long; probe the first step's images once and keep
    # them seeded for the prefetch pool below.
    if label_transport not in ("auto", "dense", "rle"):
        raise ValueError(f"unknown label_transport {label_transport!r}")
    rle_cap = 0
    _seed_imgs: dict = {}
    if label_transport != "dense" and img_dtype == np.int8 and n > 0:
        probe_runs = 0
        for i in range(min(n, step_views)):
            img = np.clip(class_image_provider(order[i]), -1, None).astype(
                img_dtype
            )
            _seed_imgs[i] = img
            flat = img.ravel()
            probe_runs = max(
                probe_runs, int(np.count_nonzero(np.diff(flat))) + 1
            )
        cap = 8 * (-(-2 * probe_runs // 8))
        if label_transport == "rle" or 5 * cap * 2 <= h * w:
            rle_cap = cap
        logger.debug(
            "label transport: probed worst %d runs -> %s", probe_runs,
            f"rle cap {rle_cap}" if rle_cap else "dense",
        )

    def _get_step(ci: int, use_rle: bool):
        return _build_device_step(
            device_mesh, step_configs[ci], use_dist, group, w, h, n_faces,
            n_classes, rle_cap=rle_cap if use_rle else 0,
        )

    total_fracs = jax.device_put(
        jnp.zeros((n_faces, n_classes), jnp.float32), replicated
    )
    total_views = jax.device_put(jnp.zeros((n_faces,), jnp.float32), replicated)

    overflows = []
    # Two-stage prefetch: an image pool loads + casts label images, and a
    # dedicated single-thread put pool stacks each step's images and
    # device_puts them (params + int8 stack) WHILE the device computes the
    # previous step, so transfers never serialize with compute on the
    # main thread.
    with concurrent.futures.ThreadPoolExecutor(
        prefetch_workers
    ) as pool, concurrent.futures.ThreadPoolExecutor(1) as put_pool:
        futures: dict = {}
        put_futures: dict = {}

        def fetch(i: int):
            # clip/cast (and RLE-encode) in the worker: the main loop
            # stays free to keep the device dispatch queue full
            img = _seed_imgs.pop(i, None)
            if img is None:
                img = np.clip(
                    class_image_provider(order[i]), -1, None
                ).astype(img_dtype)
            enc = _rle_encode_class_image(img, rle_cap) if rle_cap else None
            return img, enc

        def ensure(i: int):
            if i not in futures and i < n_pad:
                futures[i] = pool.submit(fetch, i)

        def put_step(start: int):
            t0 = time.perf_counter()
            idx = list(range(start, start + step_views))
            fetched = [futures.pop(i).result() for i in idx]
            t1 = time.perf_counter()
            params_dev = jax.device_put(
                params[idx].reshape(n_dev, group, PROW), sharding
            )
            use_rle = rle_cap and all(enc is not None for _, enc in fetched)
            if use_rle:
                starts = np.stack([enc[0] for _, enc in fetched], axis=0)
                deltas = np.stack([enc[1] for _, enc in fetched], axis=0)
                imgs_dev = (
                    jax.device_put(
                        starts.reshape(n_dev, group, rle_cap), sharding
                    ),
                    jax.device_put(
                        deltas.reshape(n_dev, group, rle_cap), sharding
                    ),
                )
            else:
                if rle_cap:
                    logger.warning(
                        "step %d: an image exceeded the RLE capacity %d "
                        "runs; falling back to dense transport for this "
                        "step", start, rle_cap,
                    )
                imgs = np.stack([img for img, _ in fetched], axis=0)
                imgs_dev = jax.device_put(
                    imgs.reshape((n_dev, group) + imgs.shape[1:]), sharding
                )
            # block until the transfer lands so the next put starts only
            # after this one (and the put thread's timeline is the link's)
            jax.block_until_ready(imgs_dev)
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug(
                    "put_step %d: fetch-wait %.0f ms, put %.0f ms",
                    start, (t1 - t0) * 1e3,
                    (time.perf_counter() - t1) * 1e3,
                )
            return params_dev, imgs_dev, bool(use_rle)

        def ensure_put(start: int):
            if start not in put_futures and start < n_pad:
                for i in range(start, start + step_views):
                    ensure(i)
                put_futures[start] = put_pool.submit(put_step, start)

        ensure_put(0)
        ensure_put(step_views)
        for si, start in enumerate(range(0, n_pad, step_views)):
            t0 = time.perf_counter()
            params_dev, imgs_dev, step_rle = put_futures.pop(start).result()
            t1 = time.perf_counter()
            ensure_put(start + 2 * step_views)
            # put_step already logged any per-step dense RLE fallback
            step_fn = _get_step(step_cfg_idx[si], bool(rle_cap) and step_rle)
            total_fracs, total_views, over = step_fn(
                tri_soa, params_dev, imgs_dev, total_fracs, total_views
            )
            if logger.isEnabledFor(logging.DEBUG):
                logger.debug(
                    "step %d: put-wait %.0f ms, dispatch %.0f ms",
                    start, (t1 - t0) * 1e3,
                    (time.perf_counter() - t1) * 1e3,
                )
            # keep only device handles here: fetching any scalar now
            # would sync the step and serialize transfer with compute
            overflows.append((start, over))

    # -- resize-and-retry on capacity overflow ---------------------------------
    # A step whose views exceeded its binning caps contributed NOTHING
    # (gated in the device step); re-census exactly those views, re-size
    # one covering config, and re-run the steps — a survey never raises
    # after partial work and never silently drops counts (same doctrine
    # as planner.PlannedAggregator.finalize).
    bad_starts = [s for s, over in overflows if int(np.asarray(over))]
    attempt = 0
    while bad_starts:
        if attempt >= 2:
            raise RuntimeError(
                "binning capacity overflow persisted after "
                f"{attempt} resize retries (steps {bad_starts}); the "
                "gated steps contributed nothing — result would be "
                "missing those views"
            )
        attempt += 1
        bad_idx = [
            i
            for s in bad_starts
            for i in range(s, s + step_views)
            if params[i, PROW - 1] > 0
        ]
        logger.warning(
            "capacity overflow: %d views in %d steps exceeded their "
            "binning caps; re-censusing and re-running them (attempt %d)",
            len(bad_idx), len(bad_starts), attempt,
        )
        sub_plan = plan_aggregation(
            tri_soa, params[bad_idx], config, h, w, n_faces,
            use_dist=use_dist, max_buckets=1, cap_margin=2.0 * attempt,
        )
        retry_step = _build_device_step(
            device_mesh, sub_plan.buckets[0].config, use_dist, group, w, h,
            n_faces, n_classes, rle_cap=0,
        )
        new_overflows = []
        for s in bad_starts:
            idx = list(range(s, s + step_views))
            imgs = np.stack(
                [
                    np.clip(
                        class_image_provider(order[i]), -1, None
                    ).astype(img_dtype)
                    for i in idx
                ]
            )
            params_dev = jax.device_put(
                params[idx].reshape(n_dev, group, PROW), sharding
            )
            imgs_dev = jax.device_put(
                imgs.reshape((n_dev, group) + imgs.shape[1:]), sharding
            )
            total_fracs, total_views, over = retry_step(
                tri_soa, params_dev, imgs_dev, total_fracs, total_views
            )
            new_overflows.append((s, over))
        bad_starts = [
            s for s, over in new_overflows if int(np.asarray(over))
        ]

    return np.asarray(total_fracs), np.asarray(total_views)
