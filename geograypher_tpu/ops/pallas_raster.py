"""Pallas kernel (Triton route) for the per-tile z-buffer resolve.

The GPU counterpart of ``ops.rasterize._raster_tiles_xla``.  One program
per level-0 tile (``tile_h x tile_w`` pixels):

* it reads its own candidate count at each level (L0 tile, the L1 and L2
  parents, the global list) and walks exactly that many candidate faces
  in a ``fori_loop`` — no scan up to the static capacity;
* per candidate it loads the face's 12 plane coefficients as scalars and
  evaluates the 3 edge planes and the 1/z plane for every pixel of the
  tile as float32 FMAs (K=3 has no use for tensor cores);
* ``best_w`` / ``best_face`` for the tile's pixels stay in registers, and
  the tile writes 4 bytes per pixel once.

The XLA reference materializes an ``(n_tiles, pixels, chunk, 4)`` float32
intermediate per scan step instead; this kernel moves only the candidate
ids, the plane rows and the output.

Tie rule (identical to the reference): candidates are visited in level
order L0, L1, L2, global and, within a level, in ascending unit id (the
binning sort's order); a candidate replaces the winner only when its depth
plane is STRICTLY greater, so exact depth ties keep the earliest candidate
— the lowest face id within a level.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _make_kernel(th, tw, ntx0, grids, scales, bb):
    (nty1, ntx1), (nty2, ntx2) = grids[1], grids[2]
    s1, s2 = scales[1], scales[2]
    npix = th * tw

    def kernel(cnt0, cnt1, cnt2, cnt3, cand0, cand1, cand2, cand3, planes,
               out_ref):
        t = pl.program_id(0)
        # lax.div / lax.rem: operands are non-negative, so truncation is
        # floor division without jnp's sign fix-ups
        div, rem = jax.lax.div, jax.lax.rem
        ty = div(t, ntx0)
        tx = rem(t, ntx0)
        pix = jax.lax.broadcasted_iota(jnp.int32, (npix,), 0)
        px = (tx * tw + rem(pix, tw)).astype(jnp.float32) + 0.5
        py = (ty * th + div(pix, tw)).astype(jnp.float32) + 0.5

        def walk(cand_ref, row, n_units, carry):
            def body(s, carry):
                best_w, best_f = carry
                unit = cand_ref[row, div(s, bb)]
                face = unit * bb + rem(s, bb)
                c = [planes[face, k] for k in range(12)]
                e0 = c[0] * px + c[1] * py + c[2]
                e1 = c[3] * px + c[4] * py + c[5]
                e2 = c[6] * px + c[7] * py + c[8]
                wv = c[9] * px + c[10] * py + c[11]
                upd = (
                    (jnp.minimum(jnp.minimum(e0, e1), e2) >= 0.0)
                    & (wv > best_w)
                )
                return (
                    jnp.where(upd, wv, best_w),
                    jnp.where(upd, face, best_f),
                )

            return jax.lax.fori_loop(0, n_units * bb, body, carry)

        carry = (
            jnp.full((npix,), -jnp.inf, jnp.float32),
            jnp.full((npix,), -1, jnp.int32),
        )
        carry = walk(cand0, t, cnt0[t], carry)
        p1 = jnp.minimum(div(ty, s1), nty1 - 1) * ntx1 + jnp.minimum(
            div(tx, s1), ntx1 - 1
        )
        carry = walk(cand1, p1, cnt1[p1], carry)
        p2 = jnp.minimum(div(ty, s2), nty2 - 1) * ntx2 + jnp.minimum(
            div(tx, s2), ntx2 - 1
        )
        carry = walk(cand2, p2, cnt2[p2], carry)
        carry = walk(cand3, 0, cnt3[0], carry)
        out_ref[...] = carry[1]

    return kernel


@functools.partial(
    jax.jit, static_argnames=("config", "image_h", "image_w", "interpret")
)
def raster_tiles_triton(binned, planes, config, image_h: int, image_w: int,
                        interpret: bool = False) -> jax.Array:
    """Resolve binned candidates -> ``(image_h, image_w)`` int32 pix2face.

    ``binned`` is a :class:`ops.rasterize.BinnedTriangles` and ``planes``
    the ``(F, 12)`` plane rows of :class:`ops.rasterize.TriangleSetup`.
    Compiles for the GPU only; ``interpret=True`` runs the same kernel
    through the Pallas interpreter (tests on the CPU).
    """
    th, tw = config.tile_h, config.tile_w
    npix = th * tw
    if npix & (npix - 1):
        raise ValueError(
            f"tile {th}x{tw}: the Triton resolve needs a power-of-two "
            "pixel count per tile"
        )
    grids = config.grids(image_h, image_w)
    nty0, ntx0 = grids[0]
    n_tiles = nty0 * ntx0
    kernel = _make_kernel(
        th, tw, ntx0, grids, config.level_scales, config.bin_block
    )
    tiles = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n_tiles, npix), jnp.int32),
        grid=(n_tiles,),
        in_specs=[pl.no_block_spec] * 9,
        out_specs=pl.BlockSpec((None, npix), lambda t: (t, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="raster_resolve",
    )(*binned.counts, *binned.cand, planes)
    img = tiles.reshape(nty0, ntx0, th, tw).transpose(0, 2, 1, 3)
    return img.reshape(nty0 * th, ntx0 * tw)[:image_h, :image_w]
