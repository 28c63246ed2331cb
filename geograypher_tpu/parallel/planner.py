"""Census-bucketed aggregation planner: the flagship multi-view plan as a
library component.

The plan (per-view exact binning census, cap bucketing with a bounded
merge, grouped per-bucket count programs) is reachable from
``TexturedMesh``, the distributed pipeline and ``bench.py`` alike; the
reference keeps ALL of its performance behind its public API
(meshes.py:1971 ``aggregate_projected_images``).

Why bucketing: the per-tile candidate caps are static shapes that must
cover the WORST view a program runs, and on a mixed nadir/oblique survey
the worst oblique's caps would make every nadir view pay for them.  Views
are therefore censused individually, bucketed by rounded caps, and each
bucket runs its own statically-shaped jit program.

Each grouped program runs setup -> binning -> resolve -> segment-sum
counts per view.  Overflow doctrine: a group whose binning caps would
drop candidates contributes NOTHING to the accumulator (the program gates
its contribution on ``overflow == 0``), reports the overflow, and the
runner re-censuses exactly those views, re-sizes the bucket config, and
re-runs just those groups — a survey never raises after partial work and
never silently drops counts.  Only a sampled census can overflow.

All jitted programs are built through ``functools.lru_cache`` keyed on
their full static configuration, so repeated calls (and the benchmark's
warm/timed pairs) never recompile.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
import typing

import numpy as np

import jax
import jax.numpy as jnp

from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    bin_triangles,
    fused_view_class_counts,
    setup_from_soa,
)

logger = logging.getLogger(__name__)

# packed per-view parameter row: [w2c (16), f, dist (8), pcx, pcy, valid]
PROW = 28

# coarse rounding grid for bucket keys: views whose margined caps round to
# the same grid point share one compiled program, so a survey compiles at
# most a handful of grouped programs
CAP_GRID = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024)


def pack_view_params(
    world_to_cam: np.ndarray,
    f: np.ndarray,
    distortion: typing.Optional[np.ndarray] = None,
    cx: typing.Optional[np.ndarray] = None,
    cy: typing.Optional[np.ndarray] = None,
    valid: typing.Optional[np.ndarray] = None,
) -> np.ndarray:
    """(N, 28) float32 packed per-view parameter rows.

    One packed row array means exactly ONE host->device transfer per step
    for all camera scalars.  Layout: [w2c (16), f, dist8, pcx, pcy, valid].
    """
    n = np.asarray(f).shape[0]
    z = np.zeros((n, 1), np.float32)
    return np.concatenate(
        [
            np.asarray(world_to_cam, np.float32).reshape(n, 16),
            np.asarray(f, np.float32).reshape(n, 1),
            (
                np.asarray(distortion, np.float32).reshape(n, 8)
                if distortion is not None
                else np.zeros((n, 8), np.float32)
            ),
            np.asarray(cx, np.float32).reshape(n, 1) if cx is not None else z,
            np.asarray(cy, np.float32).reshape(n, 1) if cy is not None else z,
            (
                np.asarray(valid, np.float32).reshape(n, 1)
                if valid is not None
                else np.ones((n, 1), np.float32)
            ),
        ],
        axis=1,
    )


def pack_camera_batch(batch, valid: np.ndarray) -> np.ndarray:
    """Pack a ``CameraBatch`` into (N, 28) parameter rows."""
    n = valid.shape[0]
    return pack_view_params(
        np.asarray(batch.world_to_cam, np.float32),
        np.asarray(batch.f, np.float32).reshape(n),
        np.asarray(batch.distortion, np.float32).reshape(n, 8),
        np.asarray(batch.cx, np.float32).reshape(n),
        np.asarray(batch.cy, np.float32).reshape(n),
        valid.astype(np.float32).reshape(n),
    )


def unpack_row(row: jax.Array, use_dist: bool):
    """One packed parameter row -> (w2c, f, distortion-or-None, valid)."""
    w2c = row[:16].reshape(4, 4)
    f = row[16]
    distortion = (row[17:25], row[25], row[26]) if use_dist else None
    return w2c, f, distortion, row[27]


# ---------------------------------------------------------------------------
# Plan data model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One census bucket: its sized config and the views it runs."""

    config: RasterConfig  # binning caps sized from the bucket's census
    view_indices: typing.Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """A compiled-shape plan for one survey's aggregation."""

    buckets: typing.Tuple[BucketPlan, ...]
    image_h: int
    image_w: int
    n_faces: int
    use_dist: bool
    n_views: int
    plan_seconds: float  # census device time (the "cold" cost)
    # True when built from a sampled census: un-censused views may exceed
    # their bucket's caps, which the runner's overflow gating + finalize()
    # retry covers
    sampled: bool = False

    @property
    def cover_config(self) -> RasterConfig:
        """ONE config whose binning caps cover every view (elementwise max
        over buckets) — for consumers that need a single static shape."""
        caps = tuple(
            max(b.config.caps[i] for b in self.buckets) for i in range(4)
        )
        return dataclasses.replace(self.buckets[0].config, caps=caps)


# ---------------------------------------------------------------------------
# Jitted census program (lru-cached per static configuration)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _build_census(census_cfg: RasterConfig, use_dist: bool, w: int, h: int):
    """Per-view exact binning census: per-level max tile occupancy (4,)."""

    @jax.jit
    def census(tri_soa, row):
        w2c_k, f_k, dist_k, _ = unpack_row(row, use_dist)
        setup = setup_from_soa(
            tri_soa, w2c_k, f_k, w, h, census_cfg.znear, distortion=dist_k
        )
        return bin_triangles(setup, census_cfg, h, w, return_census=True)

    return census


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------


def _margin_caps(lvl: np.ndarray, margin: float) -> tuple:
    """Censused per-level maxes -> margined, 16-aligned cap tuple."""
    return tuple(
        int(max(16, -(-int(np.ceil(c * margin)) // 16) * 16)) for c in lvl
    )


def _bucket_key(caps: tuple) -> tuple:
    return tuple(
        min((g for g in CAP_GRID if g >= c), default=c) for c in caps
    )


def _merge_buckets(buckets: dict, max_buckets: int) -> dict:
    """Merge the smallest buckets until <= max_buckets remain.

    Each merge moves the smallest-view-count bucket into whichever other
    bucket minimizes the added static-shape work (sum of elementwise-max
    caps weighted by merged view count)."""
    while len(buckets) > max(1, max_buckets):
        keys = sorted(buckets, key=lambda key: (len(buckets[key]), sum(key)))
        src = keys[0]

        def merge_cost(dst):
            merged = tuple(max(a, b) for a, b in zip(src, dst))
            return sum(merged) * (len(buckets[src]) + len(buckets[dst])) - (
                sum(src) * len(buckets[src]) + sum(dst) * len(buckets[dst])
            )

        dst = min((key for key in keys[1:]), key=merge_cost)
        merged_key = tuple(max(a, b) for a, b in zip(src, dst))
        views_merged = buckets.pop(src) + buckets.pop(dst)
        buckets.setdefault(merged_key, []).extend(views_merged)
    return buckets


def census_config_of(config: RasterConfig) -> RasterConfig:
    """The config the census programs run under: same geometry
    (bin_block, windows, levels), caps cleared."""
    return dataclasses.replace(config, caps=(8, 8, 8, 8))


def plan_aggregation(
    tri_soa: jax.Array,
    params: np.ndarray,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    *,
    use_dist: bool = False,
    max_buckets: int = 4,
    cap_margin: float = 1.25,
    census_sample: typing.Optional[int] = None,
    sample_extra_margin: float = 1.4,
) -> AggregationPlan:
    """Census views, bucket them, and size each bucket's binning caps.

    Args:
        tri_soa: (9, F_pad) device coordinate rows (``tri_to_soa``).
        params: (N, 28) packed view rows (:func:`pack_view_params`).
        config: base RasterConfig (geometry fields are honored; ``caps``
            is replaced by censused values per bucket).
        census_sample: census only this many evenly-spaced views (plus
            first/last) instead of all N.  Un-censused views adopt the
            caps of their nearest censused neighbor, every capacity gets
            ``sample_extra_margin`` on top, and the runner's overflow
            gating + resize-retry covers the tail.  Use for 1000-view
            surveys where an exact census pass would rival the
            aggregation itself.

    Returns an :class:`AggregationPlan`; ``plan_seconds`` records the
    census wall time (the honest "cold" cost — compiles of the census
    program excluded, it is cached across calls).
    """
    n_views = params.shape[0]
    if n_views == 0:
        raise ValueError("no views to plan")
    t_plan0 = time.perf_counter()

    census = _build_census(
        census_config_of(config), use_dist, image_w, image_h
    )
    sampled = (
        census_sample is not None and 0 < census_sample < n_views
    )
    if sampled:
        idx = np.unique(
            np.round(np.linspace(0, n_views - 1, census_sample)).astype(int)
        )
        census_idx = [int(i) for i in idx]
        extra = sample_extra_margin
    else:
        census_idx = list(range(n_views))
        extra = 1.0

    params_dev = jnp.asarray(params)
    # dispatch every census asynchronously, then ONE host fetch for the
    # stacked results (a per-view fetch would sync the device per view)
    lvls = np.asarray(
        jnp.stack([census(tri_soa, params_dev[k]) for k in census_idx])
    )
    view_caps = {
        k: _margin_caps(lvls[i], cap_margin * extra)
        for i, k in enumerate(census_idx)
    }
    if sampled:
        # nearest censused neighbor by view index: survey views are
        # ordered along flight lines, so adjacent views share pose regime
        carr = np.asarray(census_idx)
        for k in range(n_views):
            if k not in view_caps:
                view_caps[k] = view_caps[int(carr[np.argmin(np.abs(carr - k))])]

    buckets: dict = {}
    for k in range(n_views):
        buckets.setdefault(_bucket_key(view_caps[k]), []).append(k)
    buckets = _merge_buckets(buckets, max_buckets)
    logger.info(
        "census buckets: %s",
        ", ".join(f"{key} x{len(v)}" for key, v in buckets.items()),
    )
    plans = tuple(
        BucketPlan(
            config=dataclasses.replace(config, caps=key),
            view_indices=tuple(idxs),
        )
        for key, idxs in sorted(buckets.items())
    )
    return AggregationPlan(
        buckets=plans,
        image_h=image_h,
        image_w=image_w,
        n_faces=n_faces,
        use_dist=use_dist,
        n_views=n_views,
        plan_seconds=time.perf_counter() - t_plan0,
        sampled=sampled,
    )


def clear_program_caches() -> None:
    """Release every cached planner program AND their compiled
    executables (``jax.clear_caches``) — for a runner that plans several
    surveys of different shapes in one process.  Re-running a cleared
    program costs a reload from the persistent compile cache, not a
    recompile."""
    _build_census.cache_clear()
    _build_group_step_counts.cache_clear()
    _build_group_step_weighted.cache_clear()
    jax.clear_caches()


# ---------------------------------------------------------------------------
# Grouped count programs
# ---------------------------------------------------------------------------


def _view_counts(tri_soa, row, label, config, w, h, n_faces, n_classes,
                 use_dist):
    """One packed view's ((n_faces, n_classes) counts, binning overflow)."""
    return fused_view_class_counts(
        tri_soa, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
        row[26], label.astype(jnp.int32), w, h, config, n_faces, n_classes,
        use_dist,
    )


@functools.lru_cache(maxsize=64)
def _build_group_step_counts(
    config: RasterConfig, g: int, w: int, h: int, n_faces: int,
    n_classes: int, use_dist: bool,
):
    """One bucket's grouped program: g views' count chains summed into a
    donated accumulator.  The group's contribution is GATED on its
    binning overflow: an overflowing group adds zero and reports the
    count, so the accumulator stays clean for a resize-and-retry (module
    docstring).  The view loop is python-unrolled."""

    @functools.partial(jax.jit, donate_argnums=(3,))
    def group_step(tri_soa, params_g, labels_g, acc):
        counts = jnp.zeros_like(acc)
        over = jnp.zeros((), jnp.int32)
        for k in range(g):
            counts_k, over_k = _view_counts(
                tri_soa, params_g[k], labels_g[k], config, w, h, n_faces,
                n_classes, use_dist,
            )
            counts = counts + counts_k
            over = over + over_k
        return acc + jnp.where(over == 0, counts, 0.0), over

    return group_step


@functools.lru_cache(maxsize=64)
def _build_group_step_weighted(
    config: RasterConfig, g: int, w: int, h: int, n_faces: int,
    n_classes: int, use_dist: bool,
):
    """One bucket's grouped VIEW-WEIGHTED program: g views' count chains,
    each normalized per face (counts/total), accumulated into
    (value_sum, view_count) — the reference's
    ``aggregate_projected_images`` semantics (meshes.py:2016-2051) at the
    bucketed flagship rate.  Gated on overflow like the pooled program."""

    @functools.partial(jax.jit, donate_argnums=(3, 4))
    def group_step(tri_soa, params_g, labels_g, acc, n_seen):
        over = jnp.zeros((), jnp.int32)
        contrib = jnp.zeros_like(acc)
        seen_c = jnp.zeros_like(n_seen)
        for k in range(g):
            counts_k, over_k = _view_counts(
                tri_soa, params_g[k], labels_g[k], config, w, h, n_faces,
                n_classes, use_dist,
            )
            over = over + over_k
            tot = jnp.sum(counts_k, axis=1, keepdims=True)
            contrib = contrib + jnp.where(
                tot > 0, counts_k / jnp.maximum(tot, 1.0), 0.0
            )
            seen_c = seen_c + (tot[:, 0] > 0).astype(jnp.float32)
        gate = (over == 0).astype(jnp.float32)
        return acc + gate * contrib, n_seen + gate * seen_c, over

    return group_step


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


class PlannedAggregator:
    """Executes an :class:`AggregationPlan`: device-resident labels in,
    (n_faces, n_classes) pixel-count sums out.

    Semantics: by default the POOLED pixel-count aggregation (sum over
    views of each view's per-face per-class pixel counts).  With
    ``weighted=True`` each view's counts are normalized per face
    (counts / total) and the accumulators are (value_sum, view_count) —
    EXACTLY the reference's view-weighted ``aggregate_projected_images``
    semantics (meshes.py:2016-2051) at the bucketed rate; ``finalize()``
    then returns the (value_sum, view_count) pair.

    Typical use::

        plan = plan_aggregation(tri_soa, params, config, H, W, n_faces)
        agg = PlannedAggregator(plan, n_classes, group=20)
        agg.prepare(tri_soa, params, labels)     # binds inputs
        acc = agg.run()                          # pure dispatch, device acc
        counts = agg.finalize()                  # overflow retry + fetch
    """

    def __init__(
        self,
        plan: AggregationPlan,
        n_classes: int,
        group: int = 20,
        max_retries: int = 2,
        retry_margin: float = 1.6,
        weighted: bool = False,
    ):
        self.plan = plan
        self.n_classes = n_classes
        self.group = max(1, int(group))
        self.max_retries = max_retries
        self.retry_margin = retry_margin
        self.weighted = weighted
        self._programs = None  # [(group_step, g, bucket)]
        self.resizes = 0  # buckets re-sized by the overflow retry

    # -- preparation -------------------------------------------------------

    def prepare(
        self, tri_soa, params: np.ndarray, labels, label_index=None
    ) -> None:
        """Bind inputs and build every bucket program.

        ``labels`` is a device (or numpy) (M, H, W) integer class stack;
        it is padded with one all-ignore (-1) image for group padding.
        ``label_index`` maps view id -> row of ``labels`` (default: the
        identity, M == n_views) — a survey larger than device memory for
        its label stack can share rows.
        """
        plan = self.plan
        h, w = plan.image_h, plan.image_w
        self.tri_soa = tri_soa
        n = plan.n_views
        # device label stack in int8 when class ids fit (widened per view
        # inside the program): a padded 4K 20-view int32 stack is ~700 MB.
        # Out-of-range ids (>= 128) would wrap, but they are ignore values
        # either way (only 0..n_classes-1 count).
        ldt = jnp.int8 if self.n_classes <= 127 else jnp.int32
        if isinstance(labels, np.ndarray):
            labels = jnp.asarray(labels.astype(ldt))  # cast host-side
        else:
            labels = jnp.asarray(labels).astype(ldt)
        n_label_rows = labels.shape[0]
        self._labels_pad = jnp.concatenate(
            [labels, jnp.full((1, h, w), -1, ldt)], axis=0
        )
        if label_index is None:
            if n_label_rows != n:
                raise ValueError(
                    f"{n_label_rows} label rows for {n} views without a "
                    "label_index"
                )
            label_index = np.arange(n)
        # view id -> label row; the pad view id (n) -> the ignore image
        self._lidx = np.concatenate(
            [np.asarray(label_index, np.int64), [n_label_rows]]
        )
        params_pad = np.concatenate(
            [np.asarray(params, np.float32), params[:1]], axis=0
        )
        params_pad[n, PROW - 1] = 0.0
        # make the pad view rasterize NOTHING under any caps: negate the
        # camera-z row of its world_to_cam so every triangle lands behind
        # the near plane and is culled at setup
        params_pad[n, 8:12] = -params_pad[n, 8:12]
        self._params_pad = jnp.asarray(params_pad)

        self._programs = []
        for bucket in plan.buckets:
            g = min(self.group, len(bucket.view_indices))
            self._programs.append((self._build_step(bucket.config, g), g, bucket))

    def _build_step(self, config, g: int):
        """The bucket's grouped program for this aggregator's semantics."""
        plan = self.plan
        build = (
            _build_group_step_weighted if self.weighted
            else _build_group_step_counts
        )
        return build(
            config, g, plan.image_w, plan.image_h, plan.n_faces,
            self.n_classes, plan.use_dist,
        )

    def _init_accs(self):
        plan = self.plan
        acc = jnp.zeros((plan.n_faces, self.n_classes), jnp.float32)
        if self.weighted:
            return (acc, jnp.zeros((plan.n_faces,), jnp.float32))
        return (acc,)

    @staticmethod
    def _apply_step(step, tri_soa, params_g, labels_g, accs):
        """Dispatch one group; returns (new accs tuple, overflow)."""
        out = step(tri_soa, params_g, labels_g, *accs)
        return out[:-1], out[-1]

    def _groups(self, idxs, g):
        n = self.plan.n_views
        padded = list(idxs) + [n] * (-len(idxs) % g)
        return [padded[i:i + g] for i in range(0, len(padded), g)]

    def _label_sel(self, idx):
        """View ids -> the group's (g, H, W) label rows via label_index."""
        return self._labels_pad[
            jnp.asarray([int(self._lidx[i]) for i in idx], jnp.int32)
        ]

    # -- execution ---------------------------------------------------------

    def run(self, positions: typing.Optional[typing.Sequence[int]] = None):
        """Dispatch every group of every bucket; returns the device
        accumulator (callers time this + one sync).  Per-group overflow
        scalars are retained (device) for :meth:`finalize`.  ``positions``
        restricts to those bucket indices (per-bucket attribution)."""
        accs = self._init_accs()
        self._group_overs = []  # (bucket_pos, idx, over)
        for pos, (step, g, bucket) in enumerate(self._programs):
            if positions is not None and pos not in positions:
                continue
            for idx in self._groups(bucket.view_indices, g):
                sel = jnp.asarray(idx, jnp.int32)
                accs, over = self._apply_step(
                    step, self.tri_soa, self._params_pad[sel],
                    self._label_sel(idx), accs,
                )
                self._group_overs.append((pos, idx, over))
        self._accs = accs
        return accs[0]

    def finalize(self):
        """Fetch overflow flags; re-census + re-size + re-run any
        overflowed groups (their contributions were gated to zero), then
        return the (n_faces, n_classes) numpy counts — or, when
        ``weighted``, the ``(value_sum, view_count)`` numpy pair."""
        plan = self.plan
        retries = 0
        while True:
            bad: dict = {}
            for pos, idx, over in self._group_overs:
                if int(np.asarray(over)):
                    bad.setdefault(pos, []).extend(
                        i for i in idx if i < plan.n_views
                    )
            if not bad:
                break
            if retries >= self.max_retries:
                raise RuntimeError(
                    "aggregation overflow persisted after "
                    f"{self.max_retries} resize retries (buckets "
                    f"{[self._programs[p][2].config.caps for p in bad]})"
                )
            retries += 1
            self.resizes += len(bad)
            new_overs = []
            for pos, views in bad.items():
                _step, g, bucket = self._programs[pos]
                logger.warning(
                    "bucket %s: %d views overflowed their binning caps; "
                    "re-censusing and re-running them",
                    bucket.config.caps, len(views),
                )
                sub_params = np.asarray(
                    self._params_pad[jnp.asarray(views)], np.float32
                )
                sub_plan = plan_aggregation(
                    self.tri_soa, sub_params, bucket.config,
                    plan.image_h, plan.image_w, plan.n_faces,
                    use_dist=plan.use_dist, max_buckets=1,
                    cap_margin=1.25 * self.retry_margin,
                )
                g2 = min(g, len(views))
                step2 = self._build_step(sub_plan.buckets[0].config, g2)
                # map survey view ids through the retry's local params;
                # local id len(views) is the culled pad view
                sub_params = jnp.asarray(
                    np.concatenate(
                        [sub_params, np.asarray(self._params_pad[-1:])],
                        axis=0,
                    )
                )
                local_pad = len(views)
                for lo in range(0, len(views), g2):
                    lidx = list(range(lo, min(lo + g2, len(views))))
                    lidx = lidx + [local_pad] * (g2 - len(lidx))
                    gidx = [
                        views[i] if i < local_pad else plan.n_views
                        for i in lidx
                    ]
                    self._accs, over = self._apply_step(
                        step2, self.tri_soa,
                        sub_params[jnp.asarray(lidx, jnp.int32)],
                        self._label_sel(gidx), self._accs,
                    )
                    new_overs.append((pos, gidx, over))
            # only the re-run groups can still overflow
            self._group_overs = new_overs
        if self.weighted:
            return np.asarray(self._accs[0]), np.asarray(self._accs[1])
        return np.asarray(self._accs[0])

    def close(self) -> None:
        """Release this aggregator's device buffers (padded label stack,
        params, accumulators).  A runner that builds several aggregators
        back-to-back (the benchmark's suites, a multi-survey batch) should
        close each one so the label stacks do not accumulate in device
        memory."""
        for name in ("_labels_pad", "_params_pad"):
            arr = getattr(self, name, None)
            if arr is not None:
                try:
                    arr.delete()
                except Exception:  # already donated/deleted
                    pass
                setattr(self, name, None)
        for arr in getattr(self, "_accs", None) or ():
            try:
                arr.delete()
            except Exception:
                pass
        self._accs = None
        self._group_overs = []
        self._programs = None
        self.tri_soa = None  # shared with the caller: drop the ref only


def aggregate_counts_planned(
    tri_soa,
    params: np.ndarray,
    labels,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
    *,
    use_dist: bool = False,
    max_buckets: int = 4,
    group: int = 20,
    census_sample: typing.Optional[int] = None,
    plan: typing.Optional[AggregationPlan] = None,
    label_index=None,
) -> typing.Tuple[np.ndarray, AggregationPlan]:
    """One-call planned aggregation: census -> buckets -> grouped programs
    -> overflow-checked (n_faces, n_classes) pixel counts.

    The single-call convenience over :func:`plan_aggregation` +
    :class:`PlannedAggregator`; pass ``plan`` to reuse a previous survey's
    plan (identical cameras/shapes)."""
    if plan is None:
        plan = plan_aggregation(
            tri_soa, params, config, image_h, image_w, n_faces,
            use_dist=use_dist, max_buckets=max_buckets,
            census_sample=census_sample,
        )
    agg = PlannedAggregator(plan, n_classes, group=group)
    agg.prepare(tri_soa, params, labels, label_index=label_index)
    agg.run()
    return agg.finalize(), plan


def aggregate_projected_planned(
    tri_soa,
    params: np.ndarray,
    labels,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
    *,
    use_dist: bool = False,
    max_buckets: int = 4,
    group: int = 20,
    census_sample: typing.Optional[int] = None,
    plan: typing.Optional[AggregationPlan] = None,
    label_index=None,
) -> typing.Tuple[np.ndarray, np.ndarray, AggregationPlan]:
    """One-call VIEW-WEIGHTED planned aggregation.

    The reference's ``aggregate_projected_images`` semantics
    (meshes.py:2016-2051: per view, per-face class distribution
    counts/total; averaged over the views that saw the face) at the
    census-bucketed rate.  Returns ``(value_sum (F, C), view_count (F,),
    plan)`` — the average is ``value_sum / view_count`` (NaN where
    unseen), exactly ``ops.aggregate.finalize_aggregation``."""
    if plan is None:
        plan = plan_aggregation(
            tri_soa, params, config, image_h, image_w, n_faces,
            use_dist=use_dist, max_buckets=max_buckets,
            census_sample=census_sample,
        )
    agg = PlannedAggregator(plan, n_classes, group=group, weighted=True)
    agg.prepare(tri_soa, params, labels, label_index=label_index)
    agg.run()
    value_sum, view_count = agg.finalize()
    return value_sum, view_count, plan
