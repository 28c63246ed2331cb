"""Tests that need an NVIDIA GPU: the compiled Triton resolve against the
XLA reference, and class counts against np.bincount, at a realistic size.

Run on a machine with a card:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

Everywhere else they skip (the CPU suite covers the kernel through the
Pallas interpreter in tests/test_pallas_raster.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu

# a quarter of the benchmark scene: 250k faces, 1920x1080 views
SIZE = cs.Size(grid_n=354, height=1080, width=1920, n_views=2,
               focals=(1000.0, 1300.0))


@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX runs on {dev.platform}")
    return dev


def test_gpu_resolve_matches_reference(gpu):
    out = cs.resolve_parity(SIZE)
    for res in out.values():
        assert res["flip_share_vs_cpu_ref"] <= cs.MAX_FLIP_SHARE
        assert abs(res["distinct_ids"] - res["distinct_ids_cpu_ref"]) <= (
            res["flipped_px_vs_cpu_ref"]
        )


def test_gpu_class_counts_match_bincount(gpu):
    from geograypher_tpu.ops.rasterize import fused_view_class_counts
    from geograypher_tpu.parallel.planner import pack_view_params

    verts, faces = cs.make_mesh(SIZE)
    tri_soa = cs.tri_soa_of(verts, faces)
    c2ws, focals, _ = cs.make_views(SIZE)
    for k in range(SIZE.n_views):
        params = pack_view_params(
            np.linalg.inv(c2ws[k])[None].astype(np.float32),
            np.asarray([focals[k]], np.float32),
        )
        config = cs.census_config(tri_soa, params, SIZE, cs.bench_config())
        row = jnp.asarray(params[0])
        planes, binned = cs._setup_bin(
            tri_soa, row, config, SIZE.height, SIZE.width, False
        )
        from geograypher_tpu.ops.rasterize import resolve_tiles

        p2f = np.asarray(resolve_tiles(
            binned, planes, config, SIZE.height, SIZE.width
        ))
        labels = np.random.default_rng(k).integers(
            0, SIZE.n_classes, (SIZE.height, SIZE.width)
        ).astype(np.int32)
        counts, over = fused_view_class_counts(
            tri_soa, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
            row[26], jnp.asarray(labels), SIZE.width, SIZE.height, config,
            int(tri_soa.shape[1]), SIZE.n_classes, False,
        )
        ok = p2f >= 0
        ref = np.bincount(
            p2f[ok].astype(np.int64) * SIZE.n_classes + labels[ok],
            minlength=int(tri_soa.shape[1]) * SIZE.n_classes,
        ).reshape(-1, SIZE.n_classes)
        assert int(over) == 0
        np.testing.assert_array_equal(np.asarray(counts), ref)
