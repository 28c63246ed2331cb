"""Triangle rasterizer producing pix-to-face maps.

This single component replaces BOTH rasterization backends of the reference:
the VTK base-256 color-encoding renderer (meshes/meshes.py:1749-1803) and the
optional PyTorch3D CUDA ``MeshRasterizer`` (meshes/derived_meshes.py:642-737).
It produces, for each camera, an ``(H, W) int32`` map of the mesh face id
visible at each pixel (-1 = background), occlusion-correct by construction
and deterministic: exact depth ties break toward the lowest face id within
a binning level's candidate list, and by the fixed level order
(L0, L1, L2, global) across levels — the same inputs always produce the
same map (unlike the reference's last-drawn-wins scatter).

Pipeline:

1. **Setup**: triangles are pre-gathered to ``(9, F)`` coordinate rows
   once per mesh, so the per-view path is pure elementwise math (no
   per-view gathers).  Vertices are transformed to the camera frame and
   projected with the *ideal* pinhole model (no principal point — matching
   the reference's VTK camera which only sets a vertical FOV,
   cameras.py:446-463; principal point + lens distortion are applied by the
   distortion warp stage).
2. **Binning**: each triangle is assigned to the finest level of a 3-level
   tile hierarchy whose tile window covers its screen bbox, emitting a few
   (tile-key, unit-id) pairs.  One stable sort of the pairs yields
   contiguous per-tile candidate lists.  Oversize triangles land in a
   global list; nothing is dropped silently (overflow counts are
   returned).
3. **Resolve**: per (8 x 128) pixel tile, the 3 edge functions and the
   1/z depth plane of every candidate are evaluated at the pixel centres,
   followed by a masked depth-argmax.  :func:`resolve_tiles` picks the
   implementation by platform: a Triton kernel on the GPU
   (ops/pallas_raster.py), which walks each tile's true candidate count
   with its state in registers, and the XLA reference
   (:func:`_raster_tiles_xla`), which scans candidate chunks, on the CPU.

Depth is interpolated perspective-correctly: 1/z is affine in screen space,
so each triangle carries an affine "w-plane"; the visible face maximizes w.
Coverage uses inclusive edge tests on both windings (no backface culling,
matching VTK's default) with deterministic lowest-face-id tie-breaking,
fixing the reference's acknowledged nondeterminism (meshes.py:1965-1967).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration (hashable; used as a jit static arg)."""

    tile_h: int = 8
    tile_w: int = 128
    # tile-size multipliers for levels 0..2; level 3 is the whole image
    level_scales: Tuple[int, int, int] = (1, 4, 16)
    # per-tile candidate capacity for levels 0..3
    caps: Tuple[int, int, int, int] = (256, 96, 48, 32)
    # candidate chunk size for the XLA scan kernel
    chunk: int = 16
    znear: float = 1e-6
    # faces binned per candidate unit.  With spatially-sorted faces
    # (scanline order) a tile's candidates are contiguous id RUNS, so
    # binning BLOCKS of bin_block consecutive faces shrinks the sort and
    # the two big binning gathers by ~bin_block while adding only a few
    # percent of ride-along faces to the resolve (the dominant tile-row
    # straddle duplication is granularity-independent).  caps then count
    # BLOCKS per tile (face capacity = caps * bin_block).
    bin_block: int = 1
    # level-0 tile window span (rows, cols) — or an int for square: a
    # candidate stays at L0 when a (wy x wx) tile window covers its bbox
    # (ancestor levels keep 2x2).  Tiles are short (8 px) and wide
    # (128 px), so oblique near-field geometry overflows ROWS first:
    # (5, 2) keeps bboxes up to 32 px tall at cheap L0 instead of
    # flooding the 16x-per-candidate L1 resolve, at up to wy*wx sort
    # pairs per unit (cheap under bin_block).
    l0_window: Union[int, Tuple[int, int]] = 2
    # First face id of the mesh's OVERSIZED-face tail (see
    # utils.geometric.partitioned_face_order): units containing any face
    # >= this id are binned to the GLOBAL level unconditionally, keeping
    # the tile-level candidate lists to spatially local id runs.  The
    # pix2face output does not depend on it.  None disables.
    global_from: Optional[int] = None

    def grids(self, image_h: int, image_w: int):
        """Tile-grid shapes (nty, ntx) for levels 0..2."""
        out = []
        for s in self.level_scales:
            th, tw = self.tile_h * s, self.tile_w * s
            out.append((-(-image_h // th), -(-image_w // tw)))
        return out


class TriangleSetup(NamedTuple):
    """Per-view screen-space triangle data."""

    planes: jax.Array  # (F, 12): 3 edge planes + w-plane, see setup_triangles
    bbox: jax.Array  # (4, F) int32 rows: first/last covered pixel row & col
    valid: jax.Array  # (F,) bool


class BinnedTriangles(NamedTuple):
    """Per-level tile candidate lists.

    ``cand[l]`` is (n_tiles_l, cap_l) int32 face ids (-1 = empty slot) and
    ``counts[l]`` the true per-tile candidate count (clipped to cap).
    Level 3 has a single global tile.
    """

    cand: Tuple[jax.Array, jax.Array, jax.Array, jax.Array]
    counts: Tuple[jax.Array, jax.Array, jax.Array, jax.Array]
    overflow: jax.Array  # () int32 candidates dropped by capacity limits


def tri_to_soa(tri_verts: jax.Array) -> jax.Array:
    """(F, 3, 3) triangles -> (9, F) coordinate ROWS (x0 y0 z0 x1 ... z2).

    All per-view geometry runs on (F,)-contiguous coordinate rows, so
    every elementwise op reads and writes contiguous memory; do this
    transpose ONCE per mesh.
    """
    f_count = tri_verts.shape[0]
    return tri_verts.reshape(f_count, 9).T


def setup_from_soa(
    tri_soa: jax.Array,
    world_to_cam: jax.Array,
    f: jax.Array,
    image_w: int,
    image_h: int,
    znear: float = 1e-6,
    distortion=None,
) -> TriangleSetup:
    """Camera transform + screen projection + raster planes, fused, on
    (9, F) coordinate rows (see :func:`tri_to_soa`).

    Returns a :class:`TriangleSetup`.  ``planes[:, 0:9]`` are edge
    coefficients (A, B, C) x 3 normalized to positive orientation;
    ``planes[:, 9:12]`` is the affine 1/z plane (WA, WB, WC).  Coverage of
    pixel (i, j) means ``E_k(j+0.5, i+0.5) >= 0`` for all k.

    ``distortion`` is an optional ``(dist8, pcx, pcy)`` Brown–Conrady
    sensor model ([k1..k4, p1, p2, b1, b2], principal-point offsets): when
    given, VERTICES are warped into the sensor's distorted pixel space and
    the mesh is rasterized there directly — pix2face (and the fused class
    counts) come out natively distortion-correct, with no NN remap of the
    rendered map (the reference's approach, meshes.py:1805-1821).  At
    survey triangle sizes (~1-4 px) the straight-edge chord error is
    sub-pixel, smaller than the reference's nearest-neighbor warp error.
    Triangles outside the distortion polynomial's injective domain
    (beyond ~1.3x the image corner radius) are dropped — the polynomial
    can fold far-outside geometry back onto the image.

    Deviation from the reference's VTK renderer: triangles STRADDLING the
    near plane (some vertices behind the camera) are dropped rather than
    clipped into sub-triangles.  Aerial-survey cameras never intersect the
    terrain, so this only affects degenerate oblique captures; triangles
    fully in front are unaffected.
    """
    ftype = tri_soa.dtype
    rot = world_to_cam[:3, :3]
    t = world_to_cam[:3, 3]
    if distortion is not None:
        from geograypher_tpu.cameras.distortion import distort_normalized

        dist8, pcx, pcy = distortion
        dist8 = jnp.asarray(dist8, ftype)
        # injective-domain bound: ideal radius of the image corner + 30%
        r2_lim = (
            (image_w / 2.0 + jnp.abs(pcx)) ** 2
            + (image_h / 2.0 + jnp.abs(pcy)) ** 2
        ) / (f * f) * 1.69
        in_domain = None

    sx, sy, w_rows, zs = [], [], [], []
    for v in range(3):
        wx, wy, wz = tri_soa[3 * v], tri_soa[3 * v + 1], tri_soa[3 * v + 2]
        # elementwise 3x3 rotate: exact f32 FMAs, no matmul precision
        # mode involved (K=3 has no use for a matrix unit)
        cx = rot[0, 0] * wx + rot[0, 1] * wy + rot[0, 2] * wz + t[0]
        cy = rot[1, 0] * wx + rot[1, 1] * wy + rot[1, 2] * wz + t[1]
        cz = rot[2, 0] * wx + rot[2, 1] * wy + rot[2, 2] * wz + t[2]
        safe_z = jnp.where(cz > znear, cz, jnp.asarray(1.0, ftype))
        inv_z = 1.0 / safe_z
        xn = cx * inv_z
        yn = cy * inv_z
        if distortion is None:
            sx.append(xn * f + image_w / 2.0)
            sy.append(yn * f + image_h / 2.0)
        else:
            xd, yd = distort_normalized(xn, yn, dist8)
            sx.append(
                image_w / 2.0 + pcx + xd * (f + dist8[6]) + yd * dist8[7]
            )
            sy.append(image_h / 2.0 + pcy + yd * f)
            ok_v = xn * xn + yn * yn <= r2_lim
            in_domain = ok_v if in_domain is None else (in_domain & ok_v)
        w_rows.append(inv_z)
        zs.append(cz)

    in_front = (
        (zs[0] > znear) & (zs[1] > znear) & (zs[2] > znear)
    )
    if distortion is not None:
        in_front = in_front & in_domain
    x0, x1, x2 = sx
    y0, y1, y2 = sy

    def edge(xa, ya, xb, yb):
        # E(x, y) = (xb-xa)(y-ya) - (yb-ya)(x-xa)
        a = -(yb - ya)
        b = xb - xa
        c = (yb - ya) * xa - (xb - xa) * ya
        return a, b, c

    # Edge k is opposite vertex k; E_k(v_k) = 2 * signed area
    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    area2 = a0 * x0 + b0 * y0 + c0
    sign = jnp.where(area2 < 0, jnp.asarray(-1.0, ftype), jnp.asarray(1.0, ftype))
    nondegenerate = jnp.abs(area2) > 1e-12
    inv_area2 = sign / jnp.where(nondegenerate, jnp.abs(area2), 1.0)

    wa = (a0 * w_rows[0] + a1 * w_rows[1] + a2 * w_rows[2]) * inv_area2
    wb = (b0 * w_rows[0] + b1 * w_rows[1] + b2 * w_rows[2]) * inv_area2
    wc = (c0 * w_rows[0] + c1 * w_rows[1] + c2 * w_rows[2]) * inv_area2

    # one layout pass at the end: full-lane rows -> (F, 12) gather rows
    planes = jnp.stack(
        [
            a0 * sign, b0 * sign, c0 * sign,
            a1 * sign, b1 * sign, c1 * sign,
            a2 * sign, b2 * sign, c2 * sign,
            wa, wb, wc,
        ],
        axis=1,
    )

    # Pixel-center bbox: pixel j is covered only if j + 0.5 in [xmin, xmax]
    xmin = jnp.minimum(jnp.minimum(x0, x1), x2)
    xmax = jnp.maximum(jnp.maximum(x0, x1), x2)
    ymin = jnp.minimum(jnp.minimum(y0, y1), y2)
    ymax = jnp.maximum(jnp.maximum(y0, y1), y2)
    # clamp BEFORE the int32 cast: near-znear geometry can project past
    # 2^31 px and an out-of-range f32->int32 cast is implementation-
    # defined (a screen-covering triangle could silently cull)
    big = jnp.float32(2**30)
    px0 = jnp.ceil(jnp.clip(xmin - 0.5, -big, big)).astype(jnp.int32)
    px1 = jnp.floor(jnp.clip(xmax - 0.5, -big, big)).astype(jnp.int32)
    py0 = jnp.ceil(jnp.clip(ymin - 0.5, -big, big)).astype(jnp.int32)
    py1 = jnp.floor(jnp.clip(ymax - 0.5, -big, big)).astype(jnp.int32)
    nonempty = (px1 >= px0) & (py1 >= py0)
    on_screen = (px1 >= 0) & (px0 < image_w) & (py1 >= 0) & (py0 < image_h)
    px0 = jnp.clip(px0, 0, image_w - 1)
    px1 = jnp.clip(px1, 0, image_w - 1)
    py0 = jnp.clip(py0, 0, image_h - 1)
    py1 = jnp.clip(py1, 0, image_h - 1)

    valid = in_front & nondegenerate & nonempty & on_screen
    # Invalid faces get the coverage-false sentinel plane row so they are
    # inert even when a candidate unit references them (block-granular
    # binning evaluates whole id blocks; ride-along invalid faces must
    # never cover a pixel).  Sentinel: all three edge tests always fail.
    sentinel = jnp.asarray(
        [0.0, 0.0, -1.0, 0.0, 0.0, -1.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0],
        ftype,
    )
    planes = jnp.where(valid[:, None], planes, sentinel[None, :])
    bbox = jnp.stack([py0, px0, py1, px1], axis=0)
    return TriangleSetup(planes=planes, bbox=bbox, valid=valid)


def setup_triangles(
    tri_verts_cam: jax.Array,
    f: jax.Array,
    image_w: int,
    image_h: int,
    znear: float = 1e-6,
) -> TriangleSetup:
    """Project camera-frame triangles to screen and build raster planes.

    Compatibility entry over :func:`setup_from_soa` for callers holding
    (F, 3, 3) camera-frame triangles; pays one per-view transpose.  Hot
    paths should hold ``tri_to_soa(tri)`` once and call
    :func:`setup_from_soa` (which also fuses the camera transform).

    Args:
        tri_verts_cam: (F, 3, 3) triangle vertices in the camera frame
            (x right, y down, z forward).
        f: scalar focal length in pixels.
        image_w, image_h: target image size in pixels.
    """
    eye = jnp.eye(4, dtype=tri_verts_cam.dtype)
    return setup_from_soa(
        tri_to_soa(tri_verts_cam), eye, f, image_w, image_h, znear
    )


def expand_block_ids(cand: jax.Array, block: int) -> jax.Array:
    """(..., C) BLOCK-id candidate lists -> (..., C*block) face ids.

    Empty slots (< 0) expand to -1.  Identity when ``block == 1``.  Face
    ids within a block stay ascending, preserving the in-tile ordering
    the resolve tie-break relies on.
    """
    if block == 1:
        return cand
    offs = jnp.arange(block, dtype=jnp.int32)
    face = cand[..., None] * block + offs
    face = jnp.where((cand >= 0)[..., None], face, -1)
    return face.reshape(cand.shape[:-1] + (cand.shape[-1] * block,))


def bin_triangles(
    setup: TriangleSetup,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    return_census: bool = False,
):
    """Assign triangles to tile candidate lists via one stable sort.

    Each candidate unit goes to the finest hierarchy level where a 2x2
    tile window covers its bbox (level 3 = single global list), emitting
    <= 4 (key, unit) pairs.  Sorting the pairs groups them per tile;
    stable sort keeps ids ascending within a tile, which the raster
    kernel relies on for deterministic tie-breaking.

    With ``config.bin_block > 1`` the unit is a BLOCK of bin_block
    consecutive faces (bbox = union of its valid members): the sort and
    the candidate gathers shrink ~bin_block-fold while the resolve
    pays only the blocks' ride-along faces (inert via sentinel planes).
    ``cand`` then holds block ids — expand with :func:`expand_block_ids`.
    """
    f_count = setup.valid.shape[0]
    grids = config.grids(image_h, image_w)
    py0, px0, py1, px1 = (setup.bbox[k] for k in range(4))
    valid = setup.valid
    bb = config.bin_block
    if bb > 1:
        if f_count % bb:
            raise ValueError(
                f"face count {f_count} not a multiple of bin_block {bb}; "
                "pad the mesh bucket accordingly"
            )
        big = jnp.asarray(INT32_MAX, jnp.int32)
        py0 = jnp.min(jnp.where(valid, py0, big).reshape(-1, bb), axis=1)
        px0 = jnp.min(jnp.where(valid, px0, big).reshape(-1, bb), axis=1)
        py1 = jnp.max(jnp.where(valid, py1, -1).reshape(-1, bb), axis=1)
        px1 = jnp.max(jnp.where(valid, px1, -1).reshape(-1, bb), axis=1)
        valid = jnp.any(valid.reshape(-1, bb), axis=1)
        f_count = f_count // bb

    level_base = []
    base = 0
    for (nty, ntx) in grids:
        level_base.append(base)
        base += nty * ntx
    base3 = base
    total_tiles = base + 1

    # Tile coordinates and fit test per level, then assign each unit to
    # the finest level whose window covers it (level 3 = global
    # fallback).  Level 0 uses the (wy x wx) l0_window; ancestors 2x2.
    w0 = config.l0_window
    wy0, wx0 = (w0, w0) if isinstance(w0, int) else w0
    wy0, wx0 = max(2, int(wy0)), max(2, int(wx0))
    per_level = []  # (ty0, ty1, tx0, tx1, fits) per level
    for lvl, (scale, (nty, ntx)) in enumerate(
        zip(config.level_scales, grids)
    ):
        th, tw = config.tile_h * scale, config.tile_w * scale
        ty0, ty1 = py0 // th, py1 // th
        tx0, tx1 = px0 // tw, px1 // tw
        wy, wx = (wy0, wx0) if lvl == 0 else (2, 2)
        fits = (ty1 - ty0 < wy) & (tx1 - tx0 < wx)
        per_level.append((ty0, ty1, tx0, tx1, fits))

    fits0, fits1, fits2 = (pl[4] for pl in per_level)
    if config.global_from is not None:
        # units holding any oversized-tail face go global unconditionally
        unit_last = (
            jnp.arange(f_count, dtype=jnp.int32) * bb + (bb - 1)
        )
        small = unit_last < config.global_from
        fits0, fits1, fits2 = fits0 & small, fits1 & small, fits2 & small
    level = jnp.where(fits0, 0, jnp.where(fits1, 1, jnp.where(fits2, 2, 3)))

    def pick(field_idx):
        # elementwise 3-way select over the per-level fields
        a, b, c = (pl[field_idx] for pl in per_level)
        return jnp.where(fits0, a, jnp.where(fits1, b, c))

    ty0_s, ty1_s, tx0_s, tx1_s = (pick(i) for i in range(4))
    lb = level_base
    base_s = jnp.where(
        fits0, lb[0], jnp.where(fits1, lb[1], lb[2])
    ).astype(jnp.int32)
    ntx_s = jnp.where(
        fits0, grids[0][1], jnp.where(fits1, grids[1][1], grids[2][1])
    ).astype(jnp.int32)
    at_l3 = level == 3

    # <= wy*wx (key, unit) pairs per unit: the window cells at its level
    # (ancestor-level units never reach cells >= 2 — their fit test
    # bounds the bbox to 2x2), or a single global-list entry for level 3
    keys = []
    for dy in range(wy0):
        for dx in range(wx0):
            ty = ty0_s + dy
            tx = tx0_s + dx
            in_window = (ty <= ty1_s) & (tx <= tx1_s)
            key = base_s + ty * ntx_s + tx
            if dy == 0 and dx == 0:
                key = jnp.where(at_l3, base3, key)
                ok = valid & (in_window | at_l3)
            else:
                ok = valid & in_window & ~at_l3
            keys.append(jnp.where(ok, key, INT32_MAX))

    face_ids = jnp.arange(f_count, dtype=jnp.int32)
    # flat (wy*wx*F,) pair layout; sorting with num_keys=2 (key, then
    # face) restores ascending face ids within each tile, which the
    # resolve's lowest-id tie-break relies on
    key_flat = jnp.concatenate(keys, axis=0).astype(jnp.int32)
    face_flat = jnp.concatenate([face_ids] * (wy0 * wx0), axis=0)

    sorted_keys, sorted_faces = jax.lax.sort(
        (key_flat, face_flat), num_keys=2
    )

    # Per-tile ranges via searchsorted on the sorted keys
    tile_ids = jnp.arange(total_tiles + 1, dtype=jnp.int32)
    starts = jnp.searchsorted(sorted_keys, tile_ids, side="left").astype(jnp.int32)
    tile_counts = starts[1:] - starts[:-1]

    if return_census:
        # exact per-level max tile occupancy (units = bin_block faces),
        # independent of the configured caps — size caps from the WORST
        # view of a survey instead of guessing (cf. check_raster_capacity)
        maxes = []
        for lvl in range(3):
            nty_l, ntx_l = grids[lvl]
            n_l = nty_l * ntx_l
            maxes.append(
                jnp.max(tile_counts[level_base[lvl]:level_base[lvl] + n_l])
            )
        maxes.append(tile_counts[base3])
        return jnp.stack(maxes)

    def gather_level(base, n_tiles_l, cap):
        st = starts[base + jnp.arange(n_tiles_l, dtype=jnp.int32)]
        cnt = tile_counts[base + jnp.arange(n_tiles_l, dtype=jnp.int32)]
        offs = jnp.arange(cap, dtype=jnp.int32)
        idx = st[:, None] + offs[None, :]
        ok = offs[None, :] < cnt[:, None]
        vals = sorted_faces[jnp.clip(idx, 0, sorted_faces.shape[0] - 1)]
        over = jnp.sum(jnp.maximum(cnt - cap, 0))
        return jnp.where(ok, vals, -1), jnp.minimum(cnt, cap), over

    cands, cnts, overs = [], [], []
    for lvl in range(3):
        nty_l, ntx_l = grids[lvl]
        cap_l = config.caps[lvl]
        n_l = nty_l * ntx_l
        c, n, o = gather_level(level_base[lvl], n_l, cap_l)
        cands.append(c)
        cnts.append(n)
        overs.append(o)
    c3, n3, o3 = gather_level(base3, 1, config.caps[3])
    cands.append(c3)
    cnts.append(n3)
    overs.append(o3)

    overflow = (overs[0] + overs[1] + overs[2] + o3).astype(jnp.int32)
    return BinnedTriangles(
        cand=tuple(cands), counts=tuple(cnts), overflow=overflow
    )


def concat_candidates_for_tiles(
    binned: BinnedTriangles,
    config: RasterConfig,
    image_h: int,
    image_w: int,
) -> jax.Array:
    """(n_tiles0, Ctot) candidate lists for the XLA kernel: each L0 tile's
    own list followed by its ancestors' lists and the global list.  The
    Triton kernel instead reads each level's list in place."""
    grids = config.grids(image_h, image_w)
    (nty0, ntx0) = grids[0]
    bb = config.bin_block
    ty, tx = jnp.meshgrid(
        jnp.arange(nty0, dtype=jnp.int32),
        jnp.arange(ntx0, dtype=jnp.int32),
        indexing="ij",
    )
    ty, tx = ty.reshape(-1), tx.reshape(-1)
    parts = [expand_block_ids(binned.cand[0], bb)]
    for lvl in (1, 2):
        s = config.level_scales[lvl]
        nty_l, ntx_l = grids[lvl]
        parent = jnp.minimum(ty // s, nty_l - 1) * ntx_l + jnp.minimum(
            tx // s, ntx_l - 1
        )
        parts.append(expand_block_ids(binned.cand[lvl][parent], bb))
    parts.append(
        jnp.broadcast_to(
            expand_block_ids(binned.cand[3], bb),
            (ty.shape[0], config.caps[3] * bb),
        )
    )
    return jnp.concatenate(parts, axis=1)


def _raster_tiles_xla(
    cand: jax.Array,
    planes: jax.Array,
    config: RasterConfig,
    image_h: int,
    image_w: int,
) -> jax.Array:
    """Evaluate per-tile candidates and z-resolve: XLA reference kernel.

    Scans candidate chunks to bound the live intermediate to
    (n_tiles, pixels, chunk, 4).
    """
    th, tw = config.tile_h, config.tile_w
    nty, ntx = -(-image_h // th), -(-image_w // tw)
    n_tiles, ctot = cand.shape
    chunk = config.chunk
    pad = (-ctot) % chunk
    if pad:
        cand = jnp.pad(cand, ((0, 0), (0, pad)), constant_values=-1)
        ctot += pad
    n_chunks = ctot // chunk

    # (n_tiles, pixels, 3) pixel-center homogeneous coords
    ty = (jnp.arange(n_tiles, dtype=jnp.int32) // ntx)[:, None]
    tx = (jnp.arange(n_tiles, dtype=jnp.int32) % ntx)[:, None]
    ys = ty * th + jnp.arange(th, dtype=jnp.int32)[None, :]
    xs = tx * tw + jnp.arange(tw, dtype=jnp.int32)[None, :]
    pxy = jnp.stack(
        [
            jnp.broadcast_to(xs[:, None, :], (n_tiles, th, tw)).reshape(n_tiles, -1)
            + 0.5,
            jnp.broadcast_to(ys[:, :, None], (n_tiles, th, tw)).reshape(n_tiles, -1)
            + 0.5,
            jnp.ones((n_tiles, th * tw), planes.dtype),
        ],
        axis=-1,
    )  # (n_tiles, P, 3)

    neg = jnp.asarray(-jnp.inf, planes.dtype)

    def step(carry, cand_chunk):
        best_w, best_face = carry  # (n_tiles, P)
        ids = cand_chunk  # (n_tiles, chunk)
        p = planes[jnp.clip(ids, 0, None)]  # (n_tiles, chunk, 12)
        e = p.reshape(n_tiles, chunk, 4, 3)
        # (n_tiles, P, chunk, 4)
        vals = jnp.einsum(
            "tpk,tcek->tpce", pxy, e, precision=jax.lax.Precision.HIGHEST
        )
        covered = jnp.all(vals[..., :3] >= 0, axis=-1) & (ids >= 0)[:, None, :]
        wv = jnp.where(covered, vals[..., 3], neg)
        # best within chunk (first max wins -> lowest face id given sorting)
        arg = jnp.argmax(wv, axis=-1)  # (n_tiles, P)
        w_new = jnp.take_along_axis(wv, arg[..., None], axis=-1)[..., 0]
        f_new = jnp.take_along_axis(ids[:, None, :], arg[..., None], axis=-1)[..., 0]
        upd = w_new > best_w
        return (
            jnp.where(upd, w_new, best_w),
            jnp.where(upd, f_new, best_face),
        ), None

    init = (
        jnp.full((n_tiles, th * tw), neg, planes.dtype),
        jnp.full((n_tiles, th * tw), -1, jnp.int32),
    )
    (best_w, best_face), _ = jax.lax.scan(
        step, init, cand.reshape(n_tiles, n_chunks, chunk).transpose(1, 0, 2)
    )
    face_img = best_face.reshape(nty, ntx, th, tw).transpose(0, 2, 1, 3)
    face_img = face_img.reshape(nty * th, ntx * tw)
    return face_img[:image_h, :image_w]


def resolve_tiles(
    binned: BinnedTriangles,
    planes: jax.Array,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    interpret: bool = False,
) -> jax.Array:
    """Per-tile z-buffer resolve -> ``(image_h, image_w)`` int32 pix2face.

    The implementation is chosen by the platform the program is lowered
    for: the Triton kernel (:mod:`ops.pallas_raster`) on CUDA GPUs, the
    plain XLA reference (:func:`_raster_tiles_xla`) on the CPU; any other
    platform fails to lower.  ``interpret=True`` runs the Triton kernel
    through the Pallas interpreter on any platform (tests).
    """
    from geograypher_tpu.ops.pallas_raster import raster_tiles_triton

    def kernel(binned, planes):
        return raster_tiles_triton(
            binned, planes, config, image_h, image_w, interpret=interpret
        )

    if interpret:
        return kernel(binned, planes)

    def reference(binned, planes):
        cand = concat_candidates_for_tiles(binned, config, image_h, image_w)
        return _raster_tiles_xla(cand, planes, config, image_h, image_w)

    return jax.lax.platform_dependent(
        binned, planes, cpu=reference, cuda=kernel
    )


def rasterize_setup(
    setup: TriangleSetup,
    config: RasterConfig,
    image_h: int,
    image_w: int,
):
    """Bin + resolve prepared triangles -> (pix2face, BinnedTriangles)."""
    binned = bin_triangles(setup, config, image_h, image_w)
    pix2face = resolve_tiles(binned, setup.planes, config, image_h, image_w)
    return pix2face, binned


def rasterize_and_count(
    setup: TriangleSetup,
    class_image: jax.Array,
    config: RasterConfig,
    image_h: int,
    image_w: int,
    n_faces: int,
    n_classes: int,
) -> Tuple[jax.Array, jax.Array]:
    """One view's per-face per-class pixel counts: bin, resolve, then one
    segment-sum over (face, class) ids (reference meshes.py:1961-1968 +
    2016-2051).

    Returns ((n_faces, n_classes) float32 counts, () int32 candidates
    dropped by the binning caps).  Callers wanting the fail-loudly
    contract must check the overflow.
    """
    from geograypher_tpu.ops.aggregate import project_image_class_counts

    p2f, binned = rasterize_setup(setup, config, image_h, image_w)
    counts = project_image_class_counts(
        p2f, class_image, n_faces=n_faces, n_classes=n_classes
    )
    return counts, binned.overflow


@functools.partial(
    jax.jit,
    static_argnames=(
        "image_w", "image_h", "config", "n_faces", "n_classes", "use_dist"
    ),
)
def fused_view_class_counts(
    tri_soa: jax.Array,
    world_to_cam: jax.Array,
    f: jax.Array,
    dist8: jax.Array,
    pcx: jax.Array,
    pcy: jax.Array,
    class_image: jax.Array,
    image_w: int,
    image_h: int,
    config: RasterConfig,
    n_faces: int,
    n_classes: int,
    use_dist: bool,
) -> Tuple[jax.Array, jax.Array]:
    """One view's (counts, binning overflow) in ONE program: camera
    transform + triangle setup + binning + resolve + class counts.
    ``use_dist`` rasterizes directly in the sensor's distorted pixel space.

    ``overflow > 0`` means ``config.caps`` is undersized for this view and
    counts were dropped — callers must fail loudly.
    """
    setup = setup_from_soa(
        tri_soa, world_to_cam, f, image_w, image_h, config.znear,
        distortion=(dist8, pcx, pcy) if use_dist else None,
    )
    return rasterize_and_count(
        setup, class_image, config, image_h, image_w, n_faces, n_classes
    )


@functools.partial(
    jax.jit,
    static_argnames=("image_w", "image_h", "config", "return_overflow"),
)
def rasterize_triangles(
    tri_verts_cam: jax.Array,
    f: jax.Array,
    image_w: int,
    image_h: int,
    config: RasterConfig = RasterConfig(),
    return_overflow: bool = False,
):
    """One-view pix2face from camera-frame triangles.

    Args:
        tri_verts_cam: (F, 3, 3) triangle vertices in the camera frame.
        f: scalar focal length (pixels).

    Returns:
        (image_h, image_w) int32 face ids, -1 for background; with
        ``return_overflow`` also the () int32 count of candidates the
        binning caps dropped.
    """
    setup = setup_triangles(tri_verts_cam, f, image_w, image_h, config.znear)
    pix2face, binned = rasterize_setup(setup, config, image_h, image_w)
    return (pix2face, binned.overflow) if return_overflow else pix2face


def transform_to_camera(tri_verts: jax.Array, world_to_cam: jax.Array) -> jax.Array:
    """(F, 3, 3) local-frame triangles -> camera frame via one 4x4."""
    rot = world_to_cam[:3, :3]
    t = world_to_cam[:3, 3]
    flat = tri_verts.reshape(-1, 3)
    # Elementwise 3x3 rotate: exact f32 FMAs, no matmul precision mode
    # involved (K=3 has no use for a matrix unit).
    x, y, z = flat[:, 0], flat[:, 1], flat[:, 2]
    out = jnp.stack(
        [
            rot[0, 0] * x + rot[0, 1] * y + rot[0, 2] * z + t[0],
            rot[1, 0] * x + rot[1, 1] * y + rot[1, 2] * z + t[1],
            rot[2, 0] * x + rot[2, 1] * y + rot[2, 2] * z + t[2],
        ],
        axis=1,
    )
    return out.reshape(tri_verts.shape)


def rasterize_batch(
    tri_verts: jax.Array,
    world_to_cam: jax.Array,
    f: jax.Array,
    image_w: int,
    image_h: int,
    config: RasterConfig = RasterConfig(),
) -> jax.Array:
    """pix2face for a batch of cameras (N, H, W).

    Views are processed under ``lax.map`` (sequentially) because each view
    already exposes ample tile-level parallelism; batching views would
    multiply peak memory by the batch size for no throughput gain.  The
    (9, F) coordinate-row transpose happens ONCE for the batch; per-view
    work runs the fused full-lane setup (tri_to_soa's measured ~10x rule).
    """
    soa = tri_to_soa(tri_verts)

    def one(args):
        w2c, focal = args
        setup = setup_from_soa(
            soa, w2c, focal, image_w, image_h, config.znear
        )
        pix2face, _binned = rasterize_setup(setup, config, image_h, image_w)
        return pix2face

    return jax.lax.map(one, (world_to_cam, f))
