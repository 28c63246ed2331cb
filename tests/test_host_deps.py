"""The main path runs with JAX, numpy and scipy alone: optional host
packages (cv2, pandas, PIL, imageio, ...) are imported only by the
features that need them, and device sizing reads the device itself."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from geograypher_tpu.utils.image import resize_nearest

REPO = Path(__file__).resolve().parent.parent
OPTIONAL = (
    "cv2", "pandas", "PIL", "imageio", "sklearn", "networkx", "matplotlib",
)


@pytest.mark.parametrize(
    "src, dst", [((7, 5), (16, 9)), ((64, 48), (21, 30)), ((10, 10), (10, 10))]
)
def test_resize_nearest_matches_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.arange(src[0] * src[1], dtype=np.float32).reshape(src)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(img, *dst), ref)


def test_main_path_imports_without_optional_packages():
    """The entry points, the mesh and the parallel engines import with
    every optional host package blocked."""
    code = (
        "import sys, importlib.abc\n"
        f"BLOCK = set({OPTIONAL!r})\n"
        "class B(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        "import geograypher_tpu.entrypoints.aggregate_images\n"
        "import geograypher_tpu.entrypoints.render_labels\n"
        "import geograypher_tpu.cameras.colmap\n"
        "import geograypher_tpu.parallel.pipeline\n"
        "import chip_smoke\n"
        "print('IMPORTS OK')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(REPO), "HOME": str(REPO)},
    )
    assert "IMPORTS OK" in r.stdout, r.stderr[-2000:]


def _block_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError


def test_lookup_segmentor_resizes_without_cv2(tmp_path, monkeypatch):
    from geograypher_tpu.predictors.segmentors import LookUpSegmentor

    _block_cv2(monkeypatch)
    labels = np.random.default_rng(0).integers(0, 3, (40, 60)).astype(np.uint8)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "labels").mkdir()
    np.save(tmp_path / "labels" / "a.npy", labels)
    seg = LookUpSegmentor(tmp_path / "imgs", tmp_path / "labels", 3)
    out = seg.segment_image(
        None, filename=tmp_path / "imgs" / "a.png", image_scale=0.5
    )
    assert out.shape == (20, 30, 3)
    np.testing.assert_array_equal(
        np.argmax(out, axis=-1), resize_nearest(labels, 20, 30)
    )


def test_save_renders_npy_without_cv2(tmp_path, monkeypatch):
    """.npy mask output (with a native-resolution resize) needs no cv2."""
    from geograypher_tpu.cameras.core import CameraSet
    from geograypher_tpu.meshes.mesh import TexturedMesh
    from geograypher_tpu.ops.rasterize import RasterConfig
    from geograypher_tpu.utils.fixtures import make_grid_mesh, nadir_camera

    verts, faces = make_grid_mesh(n=9, size=4.0)
    mesh = TexturedMesh(
        (verts, faces), raster_config=RasterConfig(caps=(256, 64, 32, 16))
    )
    mesh.set_texture(np.arange(mesh.n_faces, dtype=float), is_vertex=False)
    cams = CameraSet(
        [nadir_camera(4.0, 40.0, 80)],
        {0: {"f": 40.0, "cx": 0.0, "cy": 0.0,
             "image_width": 80, "image_height": 64}},
        image_filenames=[tmp_path / "view.png"],
    )
    _block_cv2(monkeypatch)
    mesh.save_renders(
        cams, render_image_scale=0.5, output_folder=tmp_path / "out",
        output_extension=".npy",
    )
    out = np.load(tmp_path / "out" / "view.npy")
    assert out.shape == (64, 80)
    half = next(mesh.render_flat(cams, render_img_scale=0.5))[..., 0]
    np.testing.assert_array_equal(out, resize_nearest(half, 64, 80))


@pytest.mark.parametrize("limit", [None, 40 * 1024**3])
def test_planned_label_budget_from_device(monkeypatch, limit):
    """The planned route's label budget is a quarter of the device's
    memory limit, or the fixed default where the device reports none."""
    import geograypher_tpu.meshes.mesh as mesh_mod

    class FakeDevice:
        def memory_stats(self):
            return None if limit is None else {"bytes_limit": limit}

    monkeypatch.setattr(mesh_mod.jax, "devices", lambda: [FakeDevice()])
    budget = mesh_mod.TexturedMesh._planned_label_budget()
    if limit is None:
        assert budget == mesh_mod.TexturedMesh._PLANNED_LABEL_BUDGET
    else:
        assert budget == limit // 4
