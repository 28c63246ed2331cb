"""Smoke run of the main path on an NVIDIA GPU, at the benchmark's full size.

    python chip_smoke.py                # one card: the phases below
    python chip_smoke.py --four-cards   # only the four-card pipeline phase

The scene is the benchmark's: the 999,698-face grid mesh, 20 mixed nadir /
oblique 3840x2160 views (15-35 deg off nadir, focal lengths 2000 and 2600)
and 10 classes, with weights-free random labels made from a seed.

Phases, in order:

1. device: the card JAX sees, and its name and power limit;
2. resolve parity: the Triton resolve kernel against the XLA reference,
   on the GPU and on the CPU, for an oblique, a nadir and a Brown-Conrady
   distorted view;
3. aggregate: a survey on disk (PLY, Metashape XML, .npy labels) through
   ``entrypoints.aggregate_images``, checked against ``np.bincount`` of the
   per-view pix2face;
4. render: ``TexturedMesh.save_renders`` to .npy, checked against a
   texture gather through the reference pix2face.

``--four-cards`` runs the distributed pipeline over four cards against the
same survey aggregated on one card.  Each phase prints its wall time,
compile seconds, peak device memory and parity numbers; the last line of
standard output is one JSON object.  A failed check raises (non-zero exit);
nothing falls back to the CPU or to interpret mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parent
# pix2face may differ from the reference on at most this share of covered
# pixels: FMA contraction and summation order can flip pixel centres that
# lie exactly on a shared edge or at a depth tie
MAX_FLIP_SHARE = 1e-4


@dataclasses.dataclass(frozen=True)
class Size:
    grid_n: int = 708  # -> 999,698 faces
    height: int = 2160
    width: int = 3840
    n_views: int = 20
    focals: tuple = (2000.0, 2600.0)
    n_classes: int = 10


FULL = Size()
# the same framing at a size the CPU runs in seconds (tests)
TINY = Size(grid_n=24, height=72, width=128, n_views=4, focals=(67.0, 87.0))


class Phase:
    """Context manager printing one line per phase: wall seconds, backend
    compile seconds (JAX's own compile events), peak device memory and
    the numbers the phase recorded in ``self.out``."""

    _compile_s = 0.0
    _listening = False

    def __init__(self, name: str, card: str = ""):
        self.name, self.card, self.out = name, card, {}

    @classmethod
    def _listen(cls):
        if cls._listening:
            return

        def on_event(event, duration, **_kw):
            if event == "/jax/core/compile/backend_compile_duration":
                cls._compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(on_event)
        cls._listening = True

    def __enter__(self):
        self._listen()
        self.t0, self.c0 = time.perf_counter(), Phase._compile_s
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is not None:
            return False
        stats = jax.devices()[0].memory_stats() or {}
        fields = {
            "wall_s": round(time.perf_counter() - self.t0, 3),
            "compile_s": round(Phase._compile_s - self.c0, 3),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            **self.out,
        }
        body = " ".join(f"{k}={v}" for k, v in fields.items())
        card = "; ".join(self.card.splitlines())  # one entry per card
        print(f"phase {self.name}: {body} card=\"{card}\"", flush=True)
        return False


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


def make_mesh(size: Size):
    from geograypher_tpu.utils.fixtures import make_grid_mesh

    return make_grid_mesh(
        n=size.grid_n, size=4.0,
        z_fn=lambda x, y: 0.1 * np.sin(3 * x) * np.cos(3 * y),
    )


def make_views(size: Size):
    """(cam_to_worlds, focal per view, sensor index per view): even views
    translated nadir passes, odd views an oblique orbit at 15-35 deg."""
    from geograypher_tpu.utils.fixtures import nadir_camera, oblique_camera

    rng = np.random.default_rng(0)
    c2ws, focals, sensor_ids = [], [], []
    for k in range(size.n_views):
        si = k % len(size.focals)
        focal = size.focals[si]
        if k % 2 == 0:
            c2w = nadir_camera(4.0, focal, size.width)
            c2w[0, 3] += rng.uniform(-0.3, 0.3)
            c2w[1, 3] += rng.uniform(-0.3, 0.3)
            c2w[2, 3] += rng.uniform(0.0, 0.3)
        else:
            c2w = oblique_camera(
                4.0, focal, size.width,
                pitch_deg=float(rng.uniform(15.0, 35.0)),
                azimuth_deg=float(360.0 * k / size.n_views),
            )
        c2ws.append(c2w)
        focals.append(focal)
        sensor_ids.append(si)
    return c2ws, focals, sensor_ids


def tri_soa_of(verts, faces, block: int = 8):
    """(9, F_pad) device coordinate rows, padded to a ``block`` multiple
    with faces every view culls."""
    from geograypher_tpu.ops.rasterize import tri_to_soa

    tv = np.asarray(verts, np.float32)[faces]
    pad = (-tv.shape[0]) % block
    if pad:
        tv = np.concatenate([tv, np.zeros((pad, 3, 3), np.float32)])
    return jnp.asarray(tri_to_soa(tv))


def bench_config():
    """The benchmark's binning geometry (caps are censused per view)."""
    from geograypher_tpu.ops.rasterize import RasterConfig

    return RasterConfig(caps=(8, 8, 8, 8), bin_block=8, l0_window=(5, 2))


def census_config(tri_soa, params, size: Size, base, use_dist: bool = False):
    """``base`` with binning caps that cover every view in ``params`` (the
    planner's exact census)."""
    from geograypher_tpu.parallel.planner import plan_aggregation

    plan = plan_aggregation(
        tri_soa, params, base, size.height, size.width,
        int(tri_soa.shape[1]), use_dist=use_dist, max_buckets=1,
    )
    return plan.cover_config


@functools.partial(
    jax.jit, static_argnames=("config", "h", "w", "use_dist")
)
def _setup_bin(tri_soa, row, config, h, w, use_dist):
    from geograypher_tpu.ops.rasterize import bin_triangles, setup_from_soa
    from geograypher_tpu.parallel.planner import unpack_row

    w2c, f, dist, _ = unpack_row(row, use_dist)
    setup = setup_from_soa(tri_soa, w2c, f, w, h, config.znear,
                           distortion=dist)
    return setup.planes, bin_triangles(setup, config, h, w)


@functools.partial(jax.jit, static_argnames=("config", "h", "w"))
def _reference_resolve(planes, binned, config, h, w):
    from geograypher_tpu.ops.rasterize import (
        _raster_tiles_xla,
        concat_candidates_for_tiles,
    )

    cand = concat_candidates_for_tiles(binned, config, h, w)
    return _raster_tiles_xla(cand, planes, config, h, w)


def flip_share(a: np.ndarray, ref: np.ndarray) -> float:
    return float((a != ref).sum()) / max(int((ref >= 0).sum()), 1)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def resolve_parity(size: Size, interpret: bool = False) -> dict:
    """Phase 2: the kernel against the XLA reference on the default device
    and on the CPU, for an oblique, a nadir and a distorted view."""
    from geograypher_tpu.ops.pallas_raster import raster_tiles_triton
    from geograypher_tpu.parallel.planner import pack_view_params

    h, w = size.height, size.width
    verts, faces = make_mesh(size)
    tri_soa = tri_soa_of(verts, faces)
    c2ws, focals, _ = make_views(size)
    dist8 = np.array([0.02, -0.01, 0.0, 0.0, 1e-3, 0.0, 0.0, 0.0], np.float32)
    cases = {  # name -> (view index, Brown-Conrady coefficients)
        "oblique": (1, None), "nadir": (0, None), "distorted": (0, dist8),
    }
    cpu = jax.devices("cpu")[0]
    out = {}
    for name, (k, dist) in cases.items():
        params = pack_view_params(
            np.linalg.inv(c2ws[k])[None].astype(np.float32),
            np.asarray([focals[k]], np.float32),
            distortion=None if dist is None else dist[None],
        )
        use_dist = dist is not None
        config = census_config(
            tri_soa, params, size, bench_config(), use_dist
        )
        planes, binned = _setup_bin(
            tri_soa, jnp.asarray(params[0]), config, h, w, use_dist
        )
        if int(binned.overflow):
            raise RuntimeError(f"{name}: census caps overflowed")
        t0 = time.perf_counter()
        kernel = np.asarray(jax.block_until_ready(raster_tiles_triton(
            binned, planes, config, h, w, interpret=interpret
        )))
        first_s = time.perf_counter() - t0
        ref_dev = np.asarray(_reference_resolve(planes, binned, config, h, w))
        ref_cpu = np.asarray(_reference_resolve(
            jax.device_put(planes, cpu), jax.device_put(binned, cpu),
            config, h, w,
        ))
        ids_kernel = len(np.unique(kernel[kernel >= 0]))
        ids_cpu = len(np.unique(ref_cpu[ref_cpu >= 0]))
        res = {
            "covered_px": int((ref_cpu >= 0).sum()),
            "flip_share_vs_device_ref": flip_share(kernel, ref_dev),
            "flip_share_vs_cpu_ref": flip_share(kernel, ref_cpu),
            "flipped_px_vs_cpu_ref": int((kernel != ref_cpu).sum()),
            "distinct_ids": ids_kernel,
            "distinct_ids_device_ref": len(np.unique(ref_dev[ref_dev >= 0])),
            "distinct_ids_cpu_ref": ids_cpu,
            "kernel_first_call_s": round(first_s, 3),
        }
        out[name] = res
        print(f"  resolve {name}: {res}", flush=True)
        if kernel.shape != (h, w):
            raise RuntimeError(f"{name}: pix2face shape {kernel.shape}")
        if max(res["flip_share_vs_device_ref"],
               res["flip_share_vs_cpu_ref"]) > MAX_FLIP_SHARE:
            raise RuntimeError(f"{name}: pix2face parity failed: {res}")
        # a collapse of face ids (reduced-precision id or plane math) loses
        # most of them; a knife-edge flip can add or drop at most one id
        if abs(ids_kernel - ids_cpu) > res["flipped_px_vs_cpu_ref"]:
            raise RuntimeError(f"{name}: distinct face ids differ: {res}")
    return out


def write_survey(size: Size, folder: Path) -> dict:
    """Survey on disk: mesh.ply (local frame), cameras.xml (Metashape,
    one sensor per focal length), labels/*.npy and placeholder image files
    (the look-up segmentor reads only the labels)."""
    from geograypher_tpu.utils.example_data import (
        local_to_ecef_frame,
        make_metashape_xml,
    )
    from geograypher_tpu.utils.meshio import save_mesh

    verts, faces = make_mesh(size)
    c2ws, _focals, sensor_ids = make_views(size)
    names = [f"img_{k:04d}.png" for k in range(size.n_views)]
    (folder / "images").mkdir(parents=True, exist_ok=True)
    (folder / "labels").mkdir(parents=True, exist_ok=True)
    save_mesh(folder / "mesh.ply", verts, faces)
    (folder / "cameras.xml").write_text(make_metashape_xml(
        c2ws, names, local_to_ecef_frame(36.0, -119.0), list(size.focals),
        size.width, size.height, sensor_ids=sensor_ids,
    ))
    rng = np.random.default_rng(7)
    for name in names:
        (folder / "images" / name).write_bytes(b"")
        labels = rng.integers(
            0, size.n_classes, (size.height, size.width), dtype=np.uint8
        )
        np.save(folder / "labels" / Path(name).with_suffix(".npy"), labels)
    return {
        "mesh_file": folder / "mesh.ply",
        "cameras_file": folder / "cameras.xml",
        "image_folder": folder / "images",
        "label_folder": folder / "labels",
        "names": names,
    }


def load_survey(survey: dict):
    """(TexturedMesh, MetashapeCameraSet) exactly as the entry point
    builds them."""
    from geograypher_tpu.cameras.metashape import MetashapeCameraSet
    from geograypher_tpu.meshes.mesh import TexturedMesh

    cams = MetashapeCameraSet(
        survey["cameras_file"], survey["image_folder"], validate_images=True
    )
    mesh = TexturedMesh(
        survey["mesh_file"], transform_filename=survey["cameras_file"]
    )
    return mesh, cams


def survey_pix2face(mesh, cams, size: Size):
    """Per-view pix2face of the survey through the resolve the platform
    selects, from the mesh's own device geometry and binning geometry
    (census caps), so tie order matches the entry point's run."""
    from geograypher_tpu.ops.rasterize import resolve_tiles
    from geograypher_tpu.parallel.planner import pack_camera_batch

    tri_soa = mesh._tri_soa_device(cams)
    params = pack_camera_batch(
        cams.get_camera_batch(), np.ones(len(cams), np.float32)
    )
    config = census_config(tri_soa, params, size, mesh.raster_config)
    resolve = jax.jit(resolve_tiles, static_argnums=(2, 3, 4))
    for k in range(len(cams)):
        planes, binned = _setup_bin(
            tri_soa, jnp.asarray(params[k]), config, size.height,
            size.width, False,
        )
        if int(binned.overflow):
            raise RuntimeError(f"view {k}: census caps overflowed")
        yield k, np.asarray(
            resolve(binned, planes, config, size.height, size.width)
        ), (tri_soa, params, config, planes, binned)


def reference_fractions(mesh, cams, survey: dict, size: Size):
    """(fraction sums, view counts, pix2face of view 0) from np.bincount
    of the per-view pix2face: the reference's view-weighted semantics."""
    n_faces, c = mesh.n_faces, size.n_classes
    fracs = np.zeros((n_faces, c), np.float32)
    views = np.zeros(n_faces, np.float32)
    for k, p2f, _ in survey_pix2face(mesh, cams, size):
        labels = np.load(
            survey["label_folder"]
            / Path(survey["names"][k]).with_suffix(".npy")
        ).astype(np.int64)
        ok = p2f >= 0
        counts = np.bincount(
            p2f[ok].astype(np.int64) * c + labels[ok],
            minlength=n_faces * c,
        )[: n_faces * c].reshape(n_faces, c).astype(np.float32)
        tot = counts.sum(axis=1)
        seen = tot > 0
        fracs[seen] += counts[seen] / tot[seen, None]
        views += seen
    return fracs, views


def aggregate_phase(size: Size, survey: dict) -> dict:
    """Phase 3: ``aggregate_images`` on a survey on disk
    (:func:`write_survey`), against the bincount reference; plus one
    view's class counts exactly."""
    from geograypher_tpu.entrypoints.aggregate_images import (
        aggregate_images,
    )
    from geograypher_tpu.meshes.mesh import TexturedMesh
    from geograypher_tpu.ops.rasterize import fused_view_class_counts

    px = size.n_views * size.height * size.width
    route = (
        "planned" if px >= TexturedMesh._PLANNED_MIN_PIXELS else "streaming"
    )
    _pred, avg = aggregate_images(
        survey["mesh_file"], survey["cameras_file"], survey["image_folder"],
        survey["label_folder"], take_every_nth_camera=None,
        n_classes=size.n_classes,
    )
    mesh, cams = load_survey(survey)
    fracs, views = reference_fractions(mesh, cams, survey, size)
    seen = views > 0
    if not np.array_equal(np.isfinite(avg).all(axis=1), seen):
        raise RuntimeError("faces seen by the entry point != reference")
    with np.errstate(invalid="ignore"):
        ref_avg = fracs / views[:, None]
    max_err = float(np.abs(avg[seen] - ref_avg[seen]).max())
    if max_err > 1e-5:
        raise RuntimeError(f"aggregate fractions differ by {max_err}")

    # one view's class counts equal the bincount of its pix2face exactly
    (k, p2f, (tri_soa, params, config, _p, _b)) = next(
        survey_pix2face(mesh, cams, size)
    )
    labels = np.load(
        survey["label_folder"] / Path(survey["names"][k]).with_suffix(".npy")
    )
    row = jnp.asarray(params[k])
    counts, over = fused_view_class_counts(
        tri_soa, row[:16].reshape(4, 4), row[16], row[17:25], row[25],
        row[26], jnp.asarray(labels.astype(np.int32)), size.width,
        size.height, config, int(tri_soa.shape[1]), size.n_classes, False,
    )
    ok = p2f >= 0
    ref_counts = np.bincount(
        p2f[ok].astype(np.int64) * size.n_classes + labels[ok],
        minlength=int(tri_soa.shape[1]) * size.n_classes,
    ).reshape(-1, size.n_classes)
    if int(over) or not np.array_equal(np.asarray(counts), ref_counts):
        raise RuntimeError("class counts differ from np.bincount")
    return {
        "route": route, "faces_seen": int(seen.sum()),
        "max_fraction_err": max_err, "counts_exact": True,
        "counted_px": int(ref_counts.sum()),
    }


def render_phase(size: Size, survey: dict, folder: Path,
                 n_render: int = 2) -> dict:
    """Phase 4: ``save_renders`` (.npy) into ``folder`` for a nadir and an
    oblique view of the survey, against a texture gather through the
    reference pix2face."""
    from geograypher_tpu.parallel.planner import pack_camera_batch

    mesh, cams = load_survey(survey)
    cams = cams.get_subset_cameras(list(range(n_render)))
    tex = np.random.default_rng(3).integers(
        0, size.n_classes, mesh.n_faces
    ).astype(np.float64)
    mesh.set_texture(tex, is_vertex=False)
    tri_soa = mesh._tri_soa_device(cams)
    params = pack_camera_batch(
        cams.get_camera_batch(), np.ones(n_render, np.float32)
    )
    mesh.raster_config = census_config(
        tri_soa, params, size, mesh.raster_config
    )
    mesh.save_renders(
        cams, output_folder=folder / "renders", output_extension=".npy"
    )
    out = {}
    for k in range(n_render):
        got = np.load(folder / "renders" / Path(
            survey["names"][k]).with_suffix(".npy"))
        planes, binned = _setup_bin(
            tri_soa, jnp.asarray(params[k]), mesh.raster_config,
            size.height, size.width, False,
        )
        ref_p2f = np.asarray(_reference_resolve(
            planes, binned, mesh.raster_config, size.height, size.width
        ))
        ref = np.where(
            ref_p2f >= 0, tex[np.clip(ref_p2f, 0, None)], np.nan
        ).astype(got.dtype)
        if got.shape != ref.shape:
            raise RuntimeError(f"render {k}: shape {got.shape}")
        differ = ~((got == ref) | (np.isnan(got) & np.isnan(ref)))
        share = float(differ.sum()) / max(int((ref_p2f >= 0).sum()), 1)
        out[f"view{k}_differ_share"] = share
        if share > MAX_FLIP_SHARE:
            raise RuntimeError(f"render {k}: {share} of pixels differ")
    return out


def four_card_phase(size: Size, survey: dict, devices) -> dict:
    """Phase 5: the distributed pipeline over ``devices`` against the
    same survey aggregated on the first device alone."""
    from geograypher_tpu.cameras.segmentor_set import SegmentorCameraSet
    from geograypher_tpu.parallel.pipeline import (
        aggregate_class_images_distributed,
    )
    from geograypher_tpu.parallel.sharding import make_view_mesh
    from geograypher_tpu.predictors.segmentors import LookUpSegmentor

    mesh, cams = load_survey(survey)
    seg = SegmentorCameraSet(cams, LookUpSegmentor(
        survey["image_folder"], survey["label_folder"],
        num_classes=size.n_classes,
    ))
    label_files = [
        survey["label_folder"] / Path(n).with_suffix(".npy")
        for n in survey["names"]
    ]

    def labels(i):  # the segmentor's argmax, without the one-hot detour
        return np.load(label_files[i]).astype(np.int32)

    results = {}
    for name, devs in (("many", devices), ("one", devices[:1])):
        t0 = time.perf_counter()
        results[name] = aggregate_class_images_distributed(
            mesh, seg, size.n_classes, class_image_provider=labels,
            device_mesh=make_view_mesh(devs),
        )
        print(f"  pipeline on {len(devs)} device(s): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    (f_many, v_many), (f_one, v_one) = results["many"], results["one"]
    if not np.array_equal(v_many, v_one):
        raise RuntimeError("per-face view counts differ across cards")
    err = float(np.abs(f_many - f_one).max())
    if err > 1e-5:
        raise RuntimeError(f"fractions differ by {err} across cards")
    return {
        "devices": len(devices), "faces_seen": int((v_one > 0).sum()),
        "views_counts_equal": True, "max_fraction_err": err,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card distributed pipeline phase",
    )
    args = parser.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    from geograypher_tpu.utils.device import card_line, use_compile_cache

    use_compile_cache(jax, REPO)
    card = card_line()
    with Phase("device", card) as ph:
        ph.out.update(kind=f"\"{dev.device_kind}\"", count=len(devices))
    print(card, flush=True)

    if args.four_cards and len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with Phase("write_survey", card):
            survey = write_survey(FULL, tmp / "survey")
        if args.four_cards:
            with Phase("four_cards", card) as ph:
                ph.out.update(four_card_phase(FULL, survey, devices[:4]))
        else:
            with Phase("resolve_parity", card) as ph:
                resolve_parity(FULL)
            with Phase("aggregate", card) as ph:
                ph.out.update(aggregate_phase(FULL, survey))
            with Phase("render", card) as ph:
                ph.out.update(render_phase(FULL, survey, tmp / "renders"))
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
