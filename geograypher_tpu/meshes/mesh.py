"""TexturedMesh: the central multiview-projection engine.

JAX counterpart of the reference's ``TexturedPhotogrammetryMesh``
(/root/reference/geograypher/meshes/meshes.py:53-2449).  Same capabilities,
different architecture: geometry and textures are numpy on the host
(float64, ECEF internal frame exactly like the reference, meshes.py:211),
while every per-view computation — rasterization, rendering, projection,
aggregation — is jitted JAX over a pre-gathered ``(F, 3, 3)`` triangle
array in the cameras' local frame.  The VTK plotter, GEOS overlays and
pyembree of the reference are replaced by ops/rasterize, utils/vector and
ops/raycast respectively.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import typing
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from geograypher_tpu.cameras.core import CameraSet
from geograypher_tpu.cameras.distortion import DistortionEngine
from geograypher_tpu.constants import (
    CACHE_FOLDER,
    EARTH_CENTERED_EARTH_FIXED_EPSG,
    LAT_LON_EPSG,
    PATH_TYPE,
)
from geograypher_tpu.ops.aggregate import (
    accumulate_view,
    finalize_aggregation,
    init_aggregation,
    project_image_to_faces,
    render_texture,
    vert_to_face_discrete,
    vert_to_face_mean,
)
from geograypher_tpu.ops.rasterize import (
    RasterConfig,
    rasterize_triangles,
    transform_to_camera,
)
from geograypher_tpu.utils import crs as crs_utils
from geograypher_tpu.utils import geometric
from geograypher_tpu.utils.vector import (
    Polygon,
    VectorData,
    polygons_from_mask,
    rasterize_polygons,
)

logger = logging.getLogger(__name__)

DEFAULT_RASTER_CONFIG = RasterConfig(caps=(512, 128, 64, 64))


class TexturedMesh:
    """A textured triangle mesh in a geospatial frame.

    Vertices are stored float64 host-side in the ECEF frame (EPSG:4978)
    when georeferenced (matching the reference's internal frame,
    meshes.py:211), or in an arbitrary local frame when not.
    """

    def __init__(
        self,
        mesh: typing.Union[PATH_TYPE, tuple, "TexturedMesh"],
        downsample_target: float = 1.0,
        transform_filename: typing.Optional[PATH_TYPE] = None,
        texture: typing.Union[None, PATH_TYPE, np.ndarray] = None,
        texture_column_name: typing.Optional[str] = None,
        CRS: typing.Optional[int] = None,
        ROI=None,
        ROI_buffer_meters: float = 0.0,
        IDs_to_labels: typing.Optional[dict] = None,
        shift: typing.Optional[np.ndarray] = None,
        raster_config: RasterConfig = DEFAULT_RASTER_CONFIG,
        local_to_epsg_4978_transform: typing.Optional[np.ndarray] = None,
    ):
        """Load geometry + texture.

        Args:
            mesh: a mesh file (.ply/.obj/.npz), a (verts, faces) tuple, or
                another TexturedMesh to share geometry with.
            downsample_target: fraction of faces to keep (vertex-clustering
                decimation, reference meshes.py:219-225).
            transform_filename: Metashape camera XML providing the
                local->ECEF transform, or mesh-metadata XML with CRS+shift.
            texture: np array (per-vert or per-face), .npy file, vector
                file (labels by ``texture_column_name``), or raster file.
            CRS: EPSG code the mesh vertices are in (None = local frame).
            ROI: vector data / file / Polygon to crop the mesh to.
            shift: (3,) added to vertices at load (Metashape SRSOrigin).
        """
        self.raster_config = raster_config
        self.IDs_to_labels = dict(IDs_to_labels) if IDs_to_labels else None
        self.vertex_texture: typing.Optional[np.ndarray] = None
        self.face_texture: typing.Optional[np.ndarray] = None
        self._tri_verts_cache: dict = {}
        self._local_transform = None  # set when georeferenced
        self.distortion_engine = DistortionEngine()

        # -- geometry -------------------------------------------------------
        if isinstance(mesh, TexturedMesh):
            self.verts = mesh.verts
            self.faces = mesh.faces
            self.CRS = mesh.CRS
            self._local_transform = mesh._local_transform
        elif isinstance(mesh, (tuple, list)):
            verts, faces = mesh
            self.verts = np.asarray(verts, dtype=np.float64)
            self.faces = np.asarray(faces, dtype=np.int32)
            self.CRS = CRS
        else:
            from geograypher_tpu.utils.meshio import load_mesh

            self.verts, self.faces, attrs = load_mesh(mesh)
            self.CRS = CRS
            # keep named per-vertex scalars for load_texture's
            # texture-on-the-mesh fallback (reference meshes.py:589-596)
            self._mesh_attrs = dict(attrs)
            if "colors" in attrs:
                self.vertex_texture = attrs["colors"].astype(np.float64)

        # Metashape transform / metadata (reference meshes.py:157-215)
        if transform_filename is not None:
            self._apply_transform_file(transform_filename)
        if local_to_epsg_4978_transform is not None:
            self._set_local_transform(np.asarray(local_to_epsg_4978_transform))
        if shift is not None:
            self.verts = self.verts + np.asarray(shift, dtype=np.float64)

        # Reproject to the internal ECEF frame when georeferenced
        if self.CRS is not None and self.CRS != EARTH_CENTERED_EARTH_FIXED_EPSG:
            self.verts = crs_utils.transform_points(
                self.verts, self.CRS, EARTH_CENTERED_EARTH_FIXED_EPSG
            )
            self.CRS = EARTH_CENTERED_EARTH_FIXED_EPSG

        if ROI is not None:
            self.select_mesh_ROI(ROI, ROI_buffer_meters, inplace=True)

        if downsample_target < 1.0:
            self.downsample(downsample_target, inplace=True)

        # -- texture ----------------------------------------------------------
        if texture is not None:
            self.load_texture(texture, texture_column_name)

    # -- transforms -----------------------------------------------------------

    def _apply_transform_file(self, transform_filename: PATH_TYPE):
        from geograypher_tpu.utils.parsing import (
            crs_from_srs_text,
            parse_metashape_mesh_metadata,
            parse_transform_metashape,
        )

        transform_filename = Path(transform_filename)
        if transform_filename.suffix.lower() == ".xml":
            try:
                t = parse_transform_metashape(transform_filename)
                if t is not None:
                    # mesh verts are in the local chunk frame -> ECEF
                    hom = np.concatenate(
                        [self.verts, np.ones((len(self.verts), 1))], axis=1
                    )
                    self.verts = (t @ hom.T).T[:, :3]
                    self.CRS = EARTH_CENTERED_EARTH_FIXED_EPSG
                    self._set_local_transform(t)
                    return
            except (AssertionError, AttributeError):
                pass
            crs_text, shift = parse_metashape_mesh_metadata(transform_filename)
            epsg = crs_from_srs_text(crs_text)
            if shift is not None:
                self.verts = self.verts + shift
            if epsg is not None:
                self.CRS = epsg

    def _set_local_transform(self, t: np.ndarray):
        self._local_transform = t

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    @property
    def n_verts(self) -> int:
        return int(self.verts.shape[0])

    def get_mesh_hash(self) -> str:
        hasher = hashlib.sha256()
        hasher.update(np.ascontiguousarray(self.verts).tobytes())
        hasher.update(np.ascontiguousarray(self.faces).tobytes())
        return hasher.hexdigest()

    def spatial_sort_faces(self) -> np.ndarray:
        """Reorder faces in serpentine scanline order (y rows, x reversed on
        odd rows) over ground-plane centroids, with oversized faces packed
        into their own trailing id blocks.

        Spatially coherent face ids make each raster tile's candidate list
        a narrow id band of contiguous runs, which block binning
        (``RasterConfig.bin_block``) exploits.  Raster tiles are wide and
        short (128 x 8 px), so scanline order bounds
        every tile's id band by ~(rows spanned) x (faces per row) —
        UNIFORMLY, unlike Hilbert/Morton orders whose bands explode for
        tiles straddling top-level curve boundaries (measured: mean band
        28k/max 799k Hilbert vs mean 2.8k row-major on the 1M-face bench
        mesh).  Oversized faces (Delaunay hull slivers, holes — present in
        any real photogrammetry TIN, reference meshes.py:157-229) are
        packed separately so one giant face never drags 7 neighbors to the
        global binning level (utils.geometric.partitioned_face_order).
        Per-face textures are permuted consistently; face INDICES visible
        to callers change (the mesh hash changes with them, invalidating
        pix2face caches).

        Returns the permutation applied (new_order[i] = old face index).
        """
        try:
            crs = self.get_working_projected_CRS()
            verts2d = self.get_vertices_in_CRS(crs)[:, :2]
        except ValueError:
            verts2d = self.verts[:, :2]
        order, n_regular = geometric.partitioned_face_order(
            verts2d[self.faces], return_split=True
        )
        self.faces = self.faces[order]
        if self.face_texture is not None:
            self.face_texture = self.face_texture[order]
        # pin the oversized tail (if any) to the global binning level —
        # see RasterConfig.global_from
        self.raster_config = dataclasses.replace(
            self.raster_config,
            global_from=n_regular if n_regular < len(order) else None,
        )
        self._invalidate_geometry_caches()
        return order

    def get_vertices_in_CRS(self, output_CRS: typing.Optional[int]) -> np.ndarray:
        """Vertices in the requested CRS (reference meshes.py:751-774)."""
        if output_CRS is None or self.CRS is None or output_CRS == self.CRS:
            return self.verts.copy()
        return crs_utils.transform_points(self.verts, self.CRS, output_CRS)

    def get_working_projected_CRS(self) -> int:
        """A projected (UTM) CRS for 2D geospatial math near the mesh."""
        if self.CRS is None:
            raise ValueError("Mesh is not georeferenced")
        lla = crs_utils.transform_points(
            self.verts[:1], self.CRS, LAT_LON_EPSG
        )
        return crs_utils.utm_epsg_for(lla[0, 0], lla[0, 1])

    def get_verts_in_local_frame(
        self, cameras: typing.Union[CameraSet, np.ndarray, None]
    ) -> np.ndarray:
        """Vertices in the camera set's local frame (reference
        get_mesh_in_cameras_coords, meshes.py:1608-1643), float64 host-side
        so ECEF magnitudes never hit f32."""
        if cameras is None:
            return self.verts
        t = (
            cameras.get_local_to_epsg_4978_transform()
            if isinstance(cameras, CameraSet)
            else np.asarray(cameras)
        )
        if t is None or self.CRS is None:
            return self.verts
        inv = np.linalg.inv(t)
        hom = np.concatenate([self.verts, np.ones((len(self.verts), 1))], axis=1)
        return (inv @ hom.T).T[:, :3]

    @staticmethod
    def _face_bucket(n: int) -> int:
        """Round a face count up to a shape bucket (1.25x geometric steps)
        so meshes/chunks of similar size share jit compilations
        (SURVEY.md §7: pad-to-bucket against ROI-crop recompiles)."""
        bucket = 1024
        while bucket < n:
            bucket = int(bucket * 1.25) // 256 * 256 + 256
        return bucket

    def _invalidate_geometry_caches(self) -> None:
        """Drop every geometry-derived device cache after a geometry edit
        (crop/sort/downsample): the (F, 3, 3) and (9, F) triangle caches
        AND the census plans sized from them — stale SOA triangles or caps
        from the old face order yield silently wrong aggregation counts."""
        self._tri_verts_cache.clear()
        for name in (
            "_tri_soa_cache", "_pipeline_cfg_cache", "_agg_plan_cache",
        ):
            cache = getattr(self, name, None)
            if cache is not None:
                cache.clear()

    def get_tri_verts_device(
        self, cameras: typing.Union[CameraSet, None]
    ) -> jax.Array:
        """(F_pad, 3, 3) float32 triangle vertices in the local frame,
        cached on device per camera frame (the rasterizer's mesh
        representation).  Padded to a shape bucket with behind-camera
        degenerate triangles, which every view culls."""
        key = None
        if isinstance(cameras, CameraSet):
            t = cameras.get_local_to_epsg_4978_transform()
            key = None if t is None else hashlib.sha256(t.tobytes()).hexdigest()
        if key not in self._tri_verts_cache:
            local = self.get_verts_in_local_frame(cameras)
            tri = local[self.faces]
            pad = self._face_bucket(self.n_faces) - self.n_faces
            if pad:
                center = local.mean(axis=0) if len(local) else np.zeros(3)
                filler = np.broadcast_to(center, (pad, 3, 3))
                tri = np.concatenate([tri, filler], axis=0)
            self._tri_verts_cache[key] = jnp.asarray(tri, jnp.float32)
        return self._tri_verts_cache[key]

    # -- geometry edits ---------------------------------------------------

    def select_mesh_ROI(
        self,
        ROI,
        buffer_meters: float = 0.0,
        inplace: bool = False,
        default_CRS: typing.Optional[int] = None,
    ):
        """Crop to faces whose vertices fall inside the (buffered) ROI
        (reference meshes.py:645-749)."""
        if isinstance(ROI, (str, Path)):
            ROI = VectorData.read_file(ROI)
        elif isinstance(ROI, Polygon):
            ROI = VectorData([ROI], epsg=default_CRS)

        if ROI.epsg is not None and self.CRS is not None:
            ROI = ROI.ensure_projected()
            verts2d = crs_utils.transform_points(self.verts, self.CRS, ROI.epsg)[
                :, :2
            ]
        else:
            verts2d = self.verts[:, :2]
        polys = [g for g in ROI.geometries if isinstance(g, Polygon)]
        if buffer_meters:
            from geograypher_tpu.utils.vector import buffer_polygons

            polys = buffer_polygons(polys, buffer_meters)
        inside = np.zeros(len(verts2d), dtype=bool)
        for p in polys:
            inside |= p.contains_points(verts2d)
        return self._keep_vertices(inside, inplace=inplace)

    def _keep_vertices(self, vert_mask: np.ndarray, inplace: bool):
        keep_face = vert_mask[self.faces].all(axis=1)
        return self._keep_faces(keep_face, inplace=inplace)

    def _keep_faces(self, face_mask: np.ndarray, inplace: bool):
        new_faces = self.faces[face_mask]
        used = np.zeros(len(self.verts), dtype=bool)
        used[new_faces.reshape(-1)] = True
        remap = np.cumsum(used) - 1
        out_verts = self.verts[used]
        out_faces = remap[new_faces].astype(np.int32)
        if inplace:
            self.verts = out_verts
            self.faces = out_faces
            if self.vertex_texture is not None:
                self.vertex_texture = self.vertex_texture[used]
            if self.face_texture is not None:
                self.face_texture = self.face_texture[face_mask]
            self._invalidate_geometry_caches()
            return self, face_mask
        sub = TexturedMesh(
            (out_verts, out_faces),
            CRS=self.CRS,
            IDs_to_labels=self.IDs_to_labels,
            raster_config=self.raster_config,
        )
        sub._local_transform = self._local_transform
        if self.vertex_texture is not None:
            sub.vertex_texture = self.vertex_texture[used]
        if self.face_texture is not None:
            sub.face_texture = self.face_texture[face_mask]
        return sub, face_mask

    def downsample(self, target: float, inplace: bool = False):
        """Vertex-clustering decimation to ~``target`` fraction of faces,
        with KDTree texture transfer (reference meshes.py:219-225, 287-334).
        """
        from scipy.spatial import cKDTree

        # cluster cell size from target face ratio: faces ~ verts * 2 on
        # meshes; cell count ~ verts * target
        bbox = self.verts.max(0) - self.verts.min(0)
        vol = np.prod(np.maximum(bbox[:2], 1e-9)) * max(bbox[2], bbox[:2].mean() * 0.01)
        n_cells = max(int(self.n_verts * target), 8)
        cell = (vol / n_cells) ** (1 / 3)
        keys = np.floor((self.verts - self.verts.min(0)) / cell).astype(np.int64)
        _, first_idx, inv = np.unique(
            keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791,
            return_index=True,
            return_inverse=True,
        )
        # representative vertex = centroid of cluster
        n_new = first_idx.shape[0]
        sums = np.zeros((n_new, 3))
        np.add.at(sums, inv, self.verts)
        counts = np.bincount(inv, minlength=n_new)
        new_verts = sums / counts[:, None]
        new_faces = inv[self.faces]
        nondegenerate = (
            (new_faces[:, 0] != new_faces[:, 1])
            & (new_faces[:, 1] != new_faces[:, 2])
            & (new_faces[:, 0] != new_faces[:, 2])
        )
        new_faces = new_faces[nondegenerate].astype(np.int32)

        old = self
        new_vertex_texture = None
        if old.vertex_texture is not None:
            tree = cKDTree(old.verts)
            _, nearest = tree.query(new_verts)
            new_vertex_texture = old.vertex_texture[nearest]
        if inplace:
            self.verts = new_verts
            self.faces = new_faces
            self.vertex_texture = new_vertex_texture
            self.face_texture = None
            self._invalidate_geometry_caches()
            return self
        sub = TexturedMesh(
            (new_verts, new_faces),
            CRS=self.CRS,
            IDs_to_labels=self.IDs_to_labels,
            raster_config=self.raster_config,
        )
        sub._local_transform = self._local_transform
        sub.vertex_texture = new_vertex_texture
        return sub

    # -- textures ----------------------------------------------------------

    def set_texture(
        self,
        texture_array: np.ndarray,
        is_vertex: typing.Optional[bool] = None,
        IDs_to_labels: typing.Optional[dict] = None,
    ):
        """Install a texture, inferring vertex- vs face-alignment by length
        (reference meshes.py:475-530)."""
        texture_array = np.asarray(texture_array, dtype=np.float64)
        if texture_array.ndim == 1:
            texture_array = texture_array[:, None]
        if is_vertex is None:
            if texture_array.shape[0] == self.n_verts:
                is_vertex = True
            elif texture_array.shape[0] == self.n_faces:
                is_vertex = False
            else:
                raise ValueError(
                    f"Texture length {texture_array.shape[0]} matches neither "
                    f"verts ({self.n_verts}) nor faces ({self.n_faces})"
                )
        if is_vertex:
            self.vertex_texture = texture_array
            self.face_texture = None
        else:
            self.face_texture = texture_array
            self.vertex_texture = None
        if IDs_to_labels is not None:
            self.IDs_to_labels = dict(IDs_to_labels)

    def get_texture(
        self,
        request_vertex_texture: typing.Optional[bool] = None,
        try_verts_faces_conversion: bool = True,
    ) -> typing.Optional[np.ndarray]:
        """Fetch the texture in the requested alignment, converting if
        allowed (reference meshes.py:336-380)."""
        if request_vertex_texture is None:
            return (
                self.vertex_texture
                if self.vertex_texture is not None
                else self.face_texture
            )
        if request_vertex_texture:
            if self.vertex_texture is not None:
                return self.vertex_texture
            if self.face_texture is not None and try_verts_faces_conversion:
                from geograypher_tpu.ops.aggregate import face_to_vert_texture

                return np.asarray(
                    face_to_vert_texture(
                        jnp.asarray(self.faces),
                        jnp.asarray(self.face_texture, jnp.float32),
                        self.n_verts,
                    )
                )
            return None
        if self.face_texture is not None:
            return self.face_texture
        if self.vertex_texture is not None and try_verts_faces_conversion:
            return self.vert_to_face_texture()
        return None

    def vert_to_face_texture(self) -> np.ndarray:
        """Vertex texture -> face texture: mode vote for discrete data,
        mean otherwise (reference meshes.py:928-969)."""
        if self.vertex_texture is None:
            raise ValueError("No vertex texture")
        tex = self.vertex_texture
        if self.is_discrete_texture(tex):
            finite = tex[np.isfinite(tex[:, 0]), 0]
            n_classes = int(finite.max()) + 1 if finite.size else 1
            out = np.asarray(
                vert_to_face_discrete(
                    jnp.asarray(self.faces),
                    jnp.asarray(tex[:, 0], jnp.float32),
                    n_classes,
                )
            )[:, None]
        else:
            out = np.asarray(
                vert_to_face_mean(
                    jnp.asarray(self.faces), jnp.asarray(tex, jnp.float32)
                )
            )
        return out.astype(np.float64)

    @staticmethod
    def is_discrete_texture(tex: np.ndarray) -> bool:
        finite = tex[np.isfinite(tex)]
        return finite.size == 0 or bool(
            np.allclose(finite, np.round(finite))
        )

    def load_texture(
        self,
        texture: typing.Union[PATH_TYPE, np.ndarray],
        texture_column_name: typing.Optional[str] = None,
    ):
        """Texture loading fallback chain (reference meshes.py:532-643):
        array -> named mesh scalar -> .npy -> vector file -> raster file."""
        if isinstance(texture, np.ndarray):
            self.set_texture(texture)
            return
        # a named per-vertex scalar already on the mesh (e.g. a PLY
        # property), like the reference's pyvista_mesh[texture] branch
        mesh_attrs = getattr(self, "_mesh_attrs", None) or {}
        if str(texture) in mesh_attrs:
            vals = np.asarray(mesh_attrs[str(texture)], dtype=np.float64)
            if vals.shape[0] == self.n_verts:
                self.set_texture(vals, is_vertex=True)
            else:
                self.set_texture(vals, is_vertex=False)
            return
        path = Path(texture)
        suffix = path.suffix.lower()
        if suffix == ".npy":
            self.set_texture(np.load(path))
        elif suffix in (".geojson", ".json", ".gpkg", ".shp"):
            labels, ids_to_labels = self.get_values_for_verts_from_vector(
                path, texture_column_name
            )
            self.set_texture(labels, is_vertex=True, IDs_to_labels=ids_to_labels)
        elif suffix in (".tif", ".tiff"):
            vals = self.get_values_for_verts_from_raster(path)
            self.set_texture(vals, is_vertex=True)
        else:
            raise ValueError(f"Cannot load texture from {path}")

    def remap_texture(self, labels_to_IDs: dict):
        """String/label texture values -> integer IDs (reference
        meshes.py:382-473).

        Textures are stored numerically (set_texture coerces to float),
        so string labels resolve through the mesh's current
        ``IDs_to_labels`` mapping (texture id -> label -> new ID);
        numeric keys match texture values directly.
        """
        tex = self.get_texture()
        out = np.full_like(tex, np.nan, dtype=np.float64)
        if any(isinstance(k, str) for k in labels_to_IDs):
            if not self.IDs_to_labels:
                raise ValueError(
                    "remap_texture got string labels but the mesh has no "
                    "IDs_to_labels mapping to resolve them against"
                )
            for old_id, label in self.IDs_to_labels.items():
                if label in labels_to_IDs:
                    out[tex == float(old_id)] = labels_to_IDs[label]
        else:
            for label, ID in labels_to_IDs.items():
                out[tex == label] = ID
        self.set_texture(out)
        self.IDs_to_labels = {v: k for k, v in labels_to_IDs.items()}

    # -- geospatial sampling ------------------------------------------------

    def get_verts_vector(self, crs: typing.Optional[int] = None) -> VectorData:
        """Vertices as a point VectorData (reference get_verts_geodataframe,
        meshes.py:776-801)."""
        if crs is None and self.CRS is not None:
            crs = self.get_working_projected_CRS()
        verts = self.get_vertices_in_CRS(crs)
        if crs == 4326:
            pts = [np.array([v[1], v[0]]) for v in verts]  # lon, lat
        else:
            pts = [v[:2].copy() for v in verts]
        return VectorData(pts, {"vert_ID": list(range(len(pts)))}, epsg=crs)

    def get_face_area_ratios(self) -> np.ndarray:
        """Per-face (2D z-projected area) / (3D area): ~1 for flat ground,
        ->0 for steep faces (reference meshes.py:881-911); used to
        down-weight steep faces in polygon-label voting."""
        from geograypher_tpu.utils.numeric import (
            compute_3D_triangle_area_vectorized,
        )

        crs = (
            self.get_working_projected_CRS() if self.CRS is not None else None
        )
        verts = self.get_vertices_in_CRS(crs) if crs else self.verts
        corners = verts[self.faces].transpose(1, 0, 2)  # (3, F, 3)
        area3d, area2d = compute_3D_triangle_area_vectorized(corners)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = area2d / area3d
        return np.nan_to_num(ratio, nan=0.0)

    def get_values_for_verts_from_vector(
        self,
        vector: typing.Union[PATH_TYPE, VectorData],
        column_name: typing.Optional[str] = None,
    ):
        """Per-vertex class from polygon containment (reference
        meshes.py:971-1086: gpd.overlay of verts x polygons)."""
        if not isinstance(vector, VectorData):
            vector = VectorData.read_file(vector)
        if self.CRS is not None and vector.epsg is not None:
            vector = vector.ensure_projected()
            verts2d = crs_utils.transform_points(
                self.verts, self.CRS, vector.epsg
            )[:, :2]
        else:
            verts2d = self.verts[:, :2]
        poly_idx = vector.contains_points(verts2d)

        if column_name is not None and column_name in vector.attributes:
            col = vector.attributes[column_name]
            classes = sorted({v for v in col if v is not None}, key=str)
            label_to_id = {c: i for i, c in enumerate(classes)}
            ids = np.full(len(verts2d), np.nan)
            hit = poly_idx >= 0
            ids[hit] = [
                label_to_id.get(col[i], np.nan) for i in poly_idx[hit]
            ]
            ids_to_labels = {i: c for c, i in label_to_id.items()}
            return ids, ids_to_labels
        ids = np.where(poly_idx >= 0, poly_idx.astype(float), np.nan)
        return ids, {i: i for i in range(len(vector))}

    def get_values_for_verts_from_raster(
        self, raster_file: PATH_TYPE, method: str = "nearest"
    ) -> np.ndarray:
        """Sample a georeferenced raster at each vertex (reference
        meshes.py:1425-1472)."""
        from geograypher_tpu.utils.raster import read_geotiff

        raster = read_geotiff(raster_file)
        epsg = raster.epsg if raster.epsg is not None else self.CRS
        verts = self.get_vertices_in_CRS(epsg)
        if epsg == LAT_LON_EPSG:
            xs, ys = verts[:, 1], verts[:, 0]  # lon, lat
        else:
            xs, ys = verts[:, 0], verts[:, 1]
        return raster.sample(xs, ys, method=method)

    def get_height_above_ground(
        self, DTM_file: PATH_TYPE, threshold: typing.Optional[float] = None
    ) -> np.ndarray:
        """Per-vertex height above a digital terrain model (reference
        meshes.py:1474-1502); thresholded to a bool mask if requested."""
        dtm_heights = self.get_values_for_verts_from_raster(DTM_file)
        if dtm_heights.ndim > 1:
            dtm_heights = dtm_heights[..., 0]
        vert_alt = crs_utils.transform_points(
            self.verts, self.CRS, LAT_LON_EPSG
        )[:, 2]
        hag = vert_alt - dtm_heights
        if threshold is not None:
            return hag < threshold
        return hag

    def label_ground_class(
        self,
        DTM_file: PATH_TYPE,
        height_above_ground_threshold: float = 2.0,
        labels: typing.Optional[np.ndarray] = None,
        only_label_existing_labels: typing.Optional[bool] = None,
        ground_class_name: str = "ground",
        ground_ID: typing.Optional[int] = None,
        set_mesh_texture: bool = True,
        only_label_existing: typing.Optional[bool] = None,
    ):
        """Relabel near-ground vertices (or faces) to the ground class
        (reference meshes.py:1504-1596).

        ``labels`` may be a vertex- or face-aligned array to relabel;
        when omitted the mesh's vertex texture is used (and
        ``set_mesh_texture`` defaults to installing the result, unlike
        the reference's False default).  ``only_label_existing`` is a
        backwards-compatible alias of ``only_label_existing_labels``.
        Returns ``(labels, ground_ID)``.
        """
        if only_label_existing_labels is None:
            only_label_existing_labels = (
                True if only_label_existing is None else only_label_existing
            )
        use_vertex = True
        if labels is not None:
            labels = np.asarray(labels, dtype=np.float64)
            if labels.ndim == 1:
                labels = labels[:, None]
            if labels.shape[0] == self.n_verts:
                use_vertex = True
            elif labels.shape[0] == self.n_faces:
                use_vertex = False
            else:
                raise ValueError(
                    "labels match neither the vertex nor the face count"
                )
            labels = labels.copy()
        else:
            tex = self.get_texture(request_vertex_texture=True)
            labels = (
                np.full((self.n_verts, 1), np.nan) if tex is None
                else tex.copy()
            )
        ground = self.get_height_above_ground(
            DTM_file, threshold=height_above_ground_threshold
        )
        if not use_vertex:
            # majority vote of the face's vertices (the reference's
            # vert_to_face mode vote on a binary mask)
            ground = ground[self.faces].mean(axis=1) >= 0.5
        mask = ground.copy()
        if only_label_existing_labels:
            mask &= np.isfinite(labels[:, 0])
        if ground_ID is None:
            ids = self.IDs_to_labels or {}
            labels_to_ids = {v: k for k, v in ids.items()}
            if ground_class_name in labels_to_ids:
                ground_ID = labels_to_ids[ground_class_name]
            else:
                finite = labels[np.isfinite(labels)]
                ground_ID = int(finite.max()) + 1 if finite.size else 0
        labels[mask, 0] = ground_ID
        if set_mesh_texture and use_vertex:
            ids = dict(self.IDs_to_labels or {})
            if np.isfinite(ground_ID):
                ids[ground_ID] = ground_class_name
            self.set_texture(labels, is_vertex=True, IDs_to_labels=ids)
        return labels, ground_ID

    # -- rasterization / rendering / aggregation -----------------------------

    def _resolve_distortion(
        self,
        cameras: CameraSet,
        index: int,
        apply_distortion: typing.Optional[bool],
    ) -> bool:
        """None = auto: warp whenever the camera's sensor carries distortion
        parameters, matching the reference's always-on post-warp for
        calibrated sensors (meshes.py:1805-1821)."""
        if apply_distortion is not None:
            return apply_distortion
        sensor = cameras.sensors[cameras.sensor_IDs[index]]
        return bool(sensor.get("distortion_params"))

    def _distortion_map_device(
        self, cameras: CameraSet, index: int, image_scale: float
    ):
        """Device-resident warped->ideal sampling map for a camera's sensor
        (None when the sensor is undistorted)."""
        sensor = cameras.sensors[cameras.sensor_IDs[index]]
        dist = sensor.get("distortion_params") or {}
        if not dist:
            return None
        from geograypher_tpu.cameras.core import distortion_dict_to_vector

        vec = distortion_dict_to_vector(dist)
        key = (
            "w2i_dev",
            self.distortion_engine.key(
                vec,
                sensor["f"],
                sensor.get("cx", 0.0),
                sensor.get("cy", 0.0),
                sensor["image_width"],
                sensor["image_height"],
                image_scale,
            ),
        )
        if key not in self._tri_verts_cache:
            _, w2i = self.distortion_engine.get_maps(
                sensor["f"],
                sensor.get("cx", 0.0),
                sensor.get("cy", 0.0),
                sensor["image_width"],
                sensor["image_height"],
                vec,
                image_scale,
            )
            self._tri_verts_cache[key] = jnp.asarray(w2i)
        return self._tri_verts_cache[key]

    def check_raster_capacity(
        self,
        cameras: CameraSet,
        index: int = 0,
        render_img_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
    ) -> int:
        """Number of candidate entries dropped by the rasterizer's static
        per-tile capacities for one representative view (0 = lossless).

        Run this once per survey configuration; if nonzero, raise the
        ``caps`` in :class:`RasterConfig` (cost is linear in ``caps[0]``).
        The rasterizer itself never checks (it would force a device sync
        per view); capacities are a static contract.
        """
        from geograypher_tpu.ops.rasterize import (
            bin_triangles,
            setup_triangles,
        )

        config = config or self.raster_config
        batch = cameras.get_camera_batch([index], image_scale=render_img_scale)
        tri = self.get_tri_verts_device(cameras)
        setup = setup_triangles(
            transform_to_camera(tri, batch.world_to_cam[0]),
            batch.f[0],
            batch.image_width,
            batch.image_height,
        )
        binned = bin_triangles(
            setup, config, batch.image_height, batch.image_width
        )
        overflow = int(binned.overflow)
        if overflow:
            logger.warning(
                "rasterizer capacity overflow: %d candidate entries dropped "
                "for view %d; increase RasterConfig.caps", overflow, index,
            )
        return overflow

    def _pix2face_device(
        self,
        cameras: CameraSet,
        index: int,
        render_img_scale: float = 1.0,
        apply_distortion: typing.Optional[bool] = None,
        config: typing.Optional[RasterConfig] = None,
        save_to_cache: bool = False,
        cache_folder: typing.Optional[PATH_TYPE] = None,
        return_overflow: bool = False,
    ):
        """One camera's pix2face as a DEVICE array (no host round trip);
        distortion warping runs on-device via NN remap (default: whenever
        the sensor is calibrated with distortion, like the reference).
        With caching requested, delegates to the host-side cached path.
        ``return_overflow`` also returns the () int32 count of candidates
        the binning caps dropped (0 for maps read from the cache, which
        keeps no such record)."""
        apply_distortion = self._resolve_distortion(
            cameras, index, apply_distortion
        )
        if save_to_cache:
            p2f = jnp.asarray(
                self.pix2face(
                    cameras,
                    [index],
                    render_img_scale=render_img_scale,
                    apply_distortion=apply_distortion,
                    config=config,
                    save_to_cache=True,
                    cache_folder=cache_folder,
                )[0]
            )
            return (p2f, jnp.zeros((), jnp.int32)) if return_overflow else p2f
        config = config or self.raster_config
        batch = cameras.get_camera_batch([index], image_scale=render_img_scale)
        tri = self.get_tri_verts_device(cameras)
        p2f, overflow = rasterize_triangles(
            transform_to_camera(tri, batch.world_to_cam[0]),
            batch.f[0],
            image_w=batch.image_width,
            image_h=batch.image_height,
            config=config,
            return_overflow=True,
        )
        if apply_distortion:
            w2i = self._distortion_map_device(cameras, index, render_img_scale)
            if w2i is not None:
                from geograypher_tpu.cameras.distortion import remap_image_jax

                p2f = remap_image_jax(p2f, w2i, fill_value=-1)
        return (p2f, overflow) if return_overflow else p2f

    def pix2face(
        self,
        cameras: CameraSet,
        indices: typing.Optional[typing.Sequence[int]] = None,
        render_img_scale: float = 1.0,
        apply_distortion: typing.Optional[bool] = None,
        config: typing.Optional[RasterConfig] = None,
        save_to_cache: bool = False,
        cache_folder: typing.Optional[PATH_TYPE] = None,
    ) -> np.ndarray:
        """(N, H, W) pixel->face-id maps for the given cameras (reference
        meshes.py:1645-1823, minus the VTK color-encoding hack).

        ``apply_distortion=None`` (the default) warps whenever the sensor
        carries distortion parameters; True/False force it.  The warp maps
        the pinhole render to the real (distorted) image geometry with
        nearest-neighbor resampling, exactly like the reference's pix2face
        post-warp (meshes.py:1809-1821).  ``save_to_cache`` persists maps
        keyed by
        (mesh hash, camera hash, scale) like the reference's ubelt cache
        (meshes.py:1726-1737), RLE-compressed.
        """
        config = config or self.raster_config
        if indices is None:
            indices = list(range(len(cameras)))
        cache_key = None
        if save_to_cache:
            from geograypher_tpu.constants import CACHE_FOLDER
            from geograypher_tpu.utils import cache as p2f_cache

            cache_folder = cache_folder or CACHE_FOLDER
            mesh_hash = self.get_mesh_hash()
        out = []
        for k, i in enumerate(indices):
            distort_i = self._resolve_distortion(cameras, i, apply_distortion)
            if save_to_cache:
                cam_hash = cameras.get_subset_cameras([i]).get_camera_hash()
                # the config is part of the key: maps rendered under
                # overflowing (lossy) capacities must not be reused after
                # the user raises caps
                cache_key = [
                    mesh_hash, cam_hash, render_img_scale, distort_i,
                    repr(config),
                ]
                cached = p2f_cache.load_pix2face(
                    "pix2face", cache_key, cache_folder
                )
                if cached is not None:
                    out.append(cached)
                    continue
            p2f = np.asarray(
                self._pix2face_device(
                    cameras,
                    i,
                    render_img_scale=render_img_scale,
                    apply_distortion=distort_i,
                    config=config,
                )
            )
            if save_to_cache:
                p2f_cache.save_pix2face(
                    p2f, "pix2face", cache_key, cache_folder
                )
            out.append(p2f)
        return np.stack(out, axis=0)

    def render_flat(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        render_img_scale: float = 1.0,
        return_camera: bool = False,
        **pix2face_kwargs,
    ):
        """Generator of per-camera rendered texture images (reference
        meshes.py:1825-1909)."""
        face_tex = self.get_texture(
            request_vertex_texture=False, try_verts_faces_conversion=True
        )
        if face_tex is None:
            raise ValueError("Mesh has no texture to render")
        tex_dev = jnp.asarray(face_tex, jnp.float32)
        for i in range(len(cameras)):
            p2f = self._pix2face_device(
                cameras, i, render_img_scale=render_img_scale,
                **pix2face_kwargs,
            )
            img = np.asarray(render_texture(p2f, tex_dev))
            if return_camera:
                yield img, cameras.get_subset_cameras([i])
            else:
                yield img

    @staticmethod
    def _as_class_image(img: np.ndarray) -> typing.Optional[np.ndarray]:
        """int32 class-index image when ``img`` is an exact one-hot stack
        (segmentor output: finite rows are 0/1 summing to 1; all-NaN rows
        are unlabeled), else None.  Gates the fused count path — soft or
        continuous images must keep full per-channel mean semantics."""
        img = np.asarray(img)
        if img.ndim != 3 or img.shape[-1] < 2:
            return None
        finite = np.isfinite(img)
        rows_f = finite.all(axis=-1)
        if not np.array_equal(rows_f, finite.any(axis=-1)):
            return None  # mixed-finite rows: not a one-hot stack
        vals = img[rows_f]
        if vals.size and (
            ((vals != 0) & (vals != 1)).any()
            or (vals.sum(axis=-1) != 1).any()
        ):
            return None
        cls = np.full(img.shape[:2], -1, np.int32)
        cls[rows_f] = np.argmax(img[rows_f], axis=-1)
        return cls

    def _tri_soa_device(self, cameras) -> jax.Array:
        """(9, F_pad) coordinate-row triangles (see ops/rasterize.tri_to_soa),
        cached on device alongside the (F, 3, 3) form."""
        from geograypher_tpu.ops.rasterize import tri_to_soa

        key = None
        if isinstance(cameras, CameraSet):
            t = cameras.get_local_to_epsg_4978_transform()
            key = None if t is None else hashlib.sha256(t.tobytes()).hexdigest()
        cache = getattr(self, "_tri_soa_cache", None)
        if cache is None:
            cache = self._tri_soa_cache = {}
        if key not in cache:
            cache[key] = jnp.asarray(
                tri_to_soa(self.get_tri_verts_device(cameras))
            )
        return cache[key]

    def project_images(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        aggregate_img_scale: float = 1.0,
        check_null_image: bool = False,
        **pix2face_kwargs,
    ):
        """Generator of per-view per-face (mean values, pixel counts)
        (reference meshes.py:1911-1969; see ops/aggregate.py for the
        deliberate last-pixel-wins -> per-face-mean semantics fix).

        One-hot segmentor images are counted per class with one
        segment-sum over (face, class) ids; continuous/soft images keep the
        general per-channel mean path.  Both rasterize through
        :meth:`_pix2face_device`, so lens distortion is applied by the
        reference's NN remap of the rendered map (meshes.py:1805-1821), the
        same geometry ``render_flat`` produces.  Binning-cap overflow raises
        (after the last view) instead of returning wrong counts.
        """
        from geograypher_tpu.ops.aggregate import project_image_class_counts

        n_bucket = self._face_bucket(self.n_faces)
        overflow_acc = None
        for i in range(len(cameras)):
            img = cameras.get_image_by_index(i, aggregate_img_scale)
            if check_null_image and not np.any(np.isfinite(img)):
                yield None
                continue
            p2f, over = self._pix2face_device(
                cameras, i, render_img_scale=aggregate_img_scale,
                return_overflow=True, **pix2face_kwargs,
            )
            overflow_acc = (
                over if overflow_acc is None
                else jnp.maximum(overflow_acc, over)
            )
            cls = self._as_class_image(img)
            if cls is not None:
                counts = project_image_class_counts(
                    p2f, jnp.asarray(cls), n_faces=n_bucket,
                    n_classes=img.shape[-1],
                )[: self.n_faces]
                face_total = jnp.sum(counts, axis=1)
                yield counts, jnp.broadcast_to(
                    face_total[:, None], counts.shape
                )
                continue
            # bucketized segment count shares the jit across mesh chunks
            sums, counts = project_image_to_faces(
                p2f, jnp.asarray(img, jnp.float32), n_bucket
            )
            # device arrays: downstream accumulation stays on device; callers
            # wanting numpy can np.asarray (tiny (F, C) transfers)
            yield sums[: self.n_faces], counts[: self.n_faces]
        if overflow_acc is not None:
            worst = int(np.asarray(overflow_acc))
            if worst:
                raise RuntimeError(
                    f"rasterizer capacity overflow: a view dropped {worst} "
                    "candidate entries; counts were lost. Pass a "
                    "RasterConfig with larger caps (check_raster_capacity)."
                )

    # auto-route aggregate_projected_images to the planned path only when
    # the survey is big enough to amortize the planner's fixed costs
    # (census ~18 ms/view + per-bucket program compiles): total label
    # pixels across views.  20 4K views = 166M; tiny test scenes never hit.
    _PLANNED_MIN_PIXELS = 32 * 1024 * 1024
    # device budget for the planner's int32 label stack when the device
    # reports no memory limit (the CPU); see _planned_label_budget
    _PLANNED_LABEL_BUDGET = 4 * 1024**3

    @classmethod
    def _planned_label_budget(cls) -> int:
        """Bytes of int32 label stack the planned route accepts: a quarter
        of the device's memory limit (the per-view resolve buffers and the
        mesh accumulators need the rest), or ``_PLANNED_LABEL_BUDGET``
        where the device reports none."""
        stats = jax.devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        return int(limit) // 4 if limit else cls._PLANNED_LABEL_BUDGET

    def aggregate_projected_images(
        self,
        cameras: CameraSet,
        batch_size: int = 1,
        aggregate_img_scale: float = 1.0,
        return_all: bool = False,
        use_planned="auto",
        **kwargs,
    ):
        """Average projections across views (reference meshes.py:1971-2052).

        ``use_planned``: route through the census-bucketed planner
        (:meth:`aggregate_projected_images_planned` — the flagship rate
        with identical view-weighted semantics) when the views are exact
        one-hot class stacks.  ``"auto"`` (default)
        routes surveys past ``_PLANNED_MIN_PIXELS`` total label pixels;
        ``True`` forces it (raises with the reason when impossible);
        ``False`` keeps the per-view streaming loop.

        Returns (average_projections (F, C), additional_information dict).
        """
        if use_planned is not False and not return_all:
            routed = self._route_projected_planned(
                cameras, aggregate_img_scale, kwargs,
                strict=(use_planned is True),
            )
            if routed is not None:
                return routed
        n_channels = None
        state = None
        all_projections = []
        for proj in self.project_images(
            cameras,
            batch_size=batch_size,
            aggregate_img_scale=aggregate_img_scale,
            **kwargs,
        ):
            if proj is None:
                continue
            sums, counts = proj
            if state is None:
                n_channels = sums.shape[1]
                state = init_aggregation(self.n_faces, n_channels)
            state = accumulate_view(state, sums, counts)
            if return_all:
                s, c = np.asarray(sums), np.asarray(counts)
                with np.errstate(invalid="ignore"):
                    all_projections.append(
                        np.where(c > 0, s / np.maximum(c, 1), np.nan)
                    )
        if state is None:
            raise ValueError("No images to aggregate")
        avg = np.asarray(finalize_aggregation(state))
        additional = {
            "projection_counts": np.asarray(state.view_count),
            "summed_projections": np.asarray(state.value_sum),
        }
        if return_all:
            additional["all_projections"] = all_projections
        return avg, additional

    def _route_projected_planned(
        self, cameras, aggregate_img_scale: float, kwargs: dict,
        strict: bool,
    ):
        """Try to serve :meth:`aggregate_projected_images` through the
        planned weighted path; return its (avg, additional) or None with
        the fallback reason logged (raised when ``strict``)."""
        reason = None
        extra = set(kwargs) - {"config", "apply_distortion"}
        batch = None
        if extra:
            reason = f"unsupported project_images kwargs {sorted(extra)}"
        else:
            batch = cameras.get_camera_batch(
                image_scale=aggregate_img_scale
            )
            px = len(cameras) * batch.image_height * batch.image_width
            if not strict and px < self._PLANNED_MIN_PIXELS:
                reason = (
                    f"survey too small to amortize planning "
                    f"({px} label pixels < {self._PLANNED_MIN_PIXELS})"
                )
            elif px * 4 > self._planned_label_budget():
                reason = (
                    f"label stack ({px * 4 / 1e9:.1f} GB int32) exceeds "
                    "the device budget; streaming instead"
                )
        labels, n_classes = [], None
        if reason is None:
            for i in range(len(cameras)):
                img = np.asarray(
                    cameras.get_image_by_index(i, aggregate_img_scale)
                )
                cls = self._as_class_image(img)
                if cls is None:
                    reason = f"view {i} is not an exact one-hot class stack"
                    break
                if n_classes is None:
                    n_classes = img.shape[-1]
                elif img.shape[-1] != n_classes:
                    reason = f"view {i} channel count changed"
                    break
                if cls.shape != (batch.image_height, batch.image_width):
                    reason = f"view {i} image size differs from the batch"
                    break
                labels.append(cls)
        if reason is not None:
            if strict:
                raise ValueError(
                    f"use_planned=True but the planned path cannot serve "
                    f"this call: {reason}"
                )
            logger.debug(
                "aggregate_projected_images: streaming (%s)", reason
            )
            return None
        logger.info(
            "aggregate_projected_images: routing %d views through the "
            "planned weighted path", len(cameras),
        )
        return self.aggregate_projected_images_planned(
            cameras, n_classes,
            aggregate_img_scale=aggregate_img_scale,
            config=kwargs.get("config"),
            apply_distortion=kwargs.get("apply_distortion"),
            labels=np.stack(labels, axis=0),
        )

    def aggregate_class_images_planned(
        self,
        cameras: CameraSet,
        n_classes: int,
        class_image_provider: typing.Optional[
            typing.Callable[[int], np.ndarray]
        ] = None,
        aggregate_img_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
        apply_distortion: typing.Optional[bool] = None,
        max_buckets: int = 4,
        group: int = 20,
        census_sample: typing.Optional[int] = None,
        label_index=None,
        labels=None,
    ):
        """Census-bucketed pooled pixel-count aggregation — the flagship
        multi-view rate, reachable through the library API (the reference
        keeps all its performance behind ``aggregate_projected_images``,
        meshes.py:1971; this is the rebuild's fast equivalent).

        Views are individually censused, bucketed by rounded capacity
        caps, and each bucket runs a statically-shaped grouped program
        (``parallel/planner.py``); capacity overflows gate the group's
        contribution to zero and are re-censused + re-run, never raised
        after partial work.  The plan is cached on the mesh per
        (cameras, scale, config) — repeated surveys skip the census.

        Semantics: POOLED pixel counts (sum over views of per-face
        per-class pixel counts).  For the reference's view-weighted
        average use :meth:`aggregate_projected_images` (streaming) or
        ``parallel.pipeline.aggregate_class_images_distributed``; for
        discrete labeling the per-face argmax of pooled counts matches
        the view-weighted argmax wherever views agree.

        Args:
            labels: optional pre-built (M, H, W) integer class stack on
                host or device.  Defaults to stacking
                ``class_image_provider(i)`` (or argmaxed segmentor
                images) for every view — pass ``label_index`` mapping
                view id -> row of ``labels`` when views share label
                images.

        Returns (counts (n_faces, n_classes) float32 numpy,
        :class:`~geograypher_tpu.parallel.planner.AggregationPlan`).
        """
        from geograypher_tpu.parallel import planner as _planner

        (tri_soa, params, labels, h, w, use_dist, key, cache) = (
            self._planned_inputs(
                cameras, class_image_provider, aggregate_img_scale,
                config, apply_distortion, max_buckets, census_sample,
                labels,
            )
        )
        config = config or self.raster_config
        counts, plan = _planner.aggregate_counts_planned(
            tri_soa, params, labels, config, h, w,
            self._face_bucket(self.n_faces), n_classes,
            use_dist=use_dist, max_buckets=max_buckets, group=group,
            census_sample=census_sample, plan=cache.get(key),
            label_index=label_index,
        )
        cache[key] = plan
        return counts[: self.n_faces], plan

    def _planned_inputs(
        self, cameras, class_image_provider, aggregate_img_scale,
        config, apply_distortion, max_buckets, census_sample, labels,
    ):
        """Shared prep for the planned aggregation paths: packed view
        params, stacked label images, and the mesh-resident plan cache."""
        from geograypher_tpu.parallel import planner as _planner

        config = config or self.raster_config
        batch = cameras.get_camera_batch(image_scale=aggregate_img_scale)
        h, w = batch.image_height, batch.image_width
        n = len(cameras)
        use_dist = bool(
            (apply_distortion is None or apply_distortion)
            and (
                np.any(np.asarray(batch.distortion))
                or np.any(np.asarray(batch.cx))
                or np.any(np.asarray(batch.cy))
            )
        )
        tri_soa = self._tri_soa_device(cameras)
        params = _planner.pack_camera_batch(batch, np.ones(n, np.float32))

        if labels is None:
            if class_image_provider is None:

                def class_image_provider(i: int) -> np.ndarray:
                    img = np.asarray(
                        cameras.get_image_by_index(i, aggregate_img_scale)
                    )
                    if img.ndim == 3:
                        finite = np.isfinite(img).all(axis=-1)
                        cls = np.argmax(np.nan_to_num(img), axis=-1)
                        return np.where(finite, cls, -1).astype(np.int32)
                    return np.nan_to_num(img, nan=-1).astype(np.int32)

            labels = np.stack(
                [class_image_provider(i) for i in range(n)], axis=0
            ).astype(np.int32)

        cache = getattr(self, "_agg_plan_cache", None)
        if cache is None:
            cache = self._agg_plan_cache = {}
        key = (
            config, round(aggregate_img_scale, 6), use_dist, max_buckets,
            census_sample, cameras.get_camera_hash(),
        )
        return tri_soa, params, labels, h, w, use_dist, key, cache

    def aggregate_projected_images_planned(
        self,
        cameras: CameraSet,
        n_classes: int,
        class_image_provider: typing.Optional[
            typing.Callable[[int], np.ndarray]
        ] = None,
        aggregate_img_scale: float = 1.0,
        config: typing.Optional[RasterConfig] = None,
        apply_distortion: typing.Optional[bool] = None,
        max_buckets: int = 4,
        group: int = 20,
        census_sample: typing.Optional[int] = None,
        label_index=None,
        labels=None,
    ):
        """Census-bucketed VIEW-WEIGHTED aggregation — the reference's
        ``aggregate_projected_images`` semantics (meshes.py:1971-2052:
        per view, per-face class distribution; averaged over the views
        seeing the face) at the planned flagship rate.  Each view's
        counts are normalized per face inside the bucket's grouped program
        (``parallel/planner.py`` weighted mode).

        Returns ``(average_projections (n_faces, n_classes) with NaN on
        unseen faces, additional_information dict)`` — the same shape as
        :meth:`aggregate_projected_images` for discrete class images.
        """
        from geograypher_tpu.parallel import planner as _planner

        (tri_soa, params, labels, h, w, use_dist, key, cache) = (
            self._planned_inputs(
                cameras, class_image_provider, aggregate_img_scale,
                config, apply_distortion, max_buckets, census_sample,
                labels,
            )
        )
        config = config or self.raster_config
        value_sum, view_count, plan = _planner.aggregate_projected_planned(
            tri_soa, params, labels, config, h, w,
            self._face_bucket(self.n_faces), n_classes,
            use_dist=use_dist, max_buckets=max_buckets, group=group,
            census_sample=census_sample, plan=cache.get(key),
            label_index=label_index,
        )
        cache[key] = plan
        value_sum = value_sum[: self.n_faces]
        view_count = view_count[: self.n_faces]
        with np.errstate(invalid="ignore"):
            avg = np.where(
                view_count[:, None] > 0,
                value_sum / np.maximum(view_count, 1.0)[:, None],
                np.nan,
            )
        additional = {
            "projection_counts": view_count,
            "summed_projections": value_sum,
            "plan": plan,
        }
        return avg, additional

    # -- ortho rasterization + vector export ---------------------------------

    def ortho_pix2face(
        self,
        crs: typing.Optional[int] = None,
        resolution_m: float = 0.2,
        max_pixels: int = 8192,
        max_total_pixels: int = 2 ** 28,
    ):
        """Orthographic top-down pix2face over the mesh footprint.

        The building block for vector export and polygon labeling: an
        orthographic view is a pinhole camera at a great distance with a
        long focal length (0.06% perspective error at the defaults).

        Footprints needing more than ``max_pixels`` per axis are rendered
        as a grid of TILES at the full requested resolution (one shared
        device compile; the camera translates per tile), so resolution is
        never silently degraded.  Only when the total pixel count would
        exceed ``max_total_pixels`` (host-memory guard, default 268M px =
        1 GB int32) is the resolution clamped — with a loud warning
        stating the effective resolution.

        Returns (pix2face (H, W), bounds (x0, y0, x1, y1), epsg).
        """
        if crs is None and self.CRS is not None:
            crs = self.get_working_projected_CRS()
        verts = self.get_vertices_in_CRS(crs)
        x0, y0 = verts[:, 0].min(), verts[:, 1].min()
        x1, y1 = verts[:, 0].max(), verts[:, 1].max()
        zmax = verts[:, 2].max()
        span_x = max(x1 - x0, resolution_m)
        span_y = max(y1 - y0, resolution_m)
        # One ground resolution for BOTH axes: the camera has a single focal
        # length, so the rendered pixel is square.  Returned bounds are the
        # exact footprint of the rendered image (centered on the footprint
        # centroid), so downstream pixel->CRS mapping via (bounds, shape) is
        # exact on both axes.
        res = resolution_m
        if (span_x / res) * (span_y / res) > max_total_pixels:
            scale = np.sqrt((span_x / res) * (span_y / res) / max_total_pixels)
            res = res * scale
            logger.warning(
                "ortho_pix2face: %.3g m/px over this footprint needs %.2g "
                "pixels (> max_total_pixels=%d); EFFECTIVE RESOLUTION "
                "DEGRADED to %.3g m/px — raise max_total_pixels to keep "
                "the requested resolution",
                resolution_m,
                (span_x / resolution_m) * (span_y / resolution_m),
                max_total_pixels,
                res,
            )
        w = max(int(np.ceil(span_x / res)), 1)
        h = max(int(np.ceil(span_y / res)), 1)
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        depth_range = zmax - verts[:, 2].min()
        # triangles in the footprint-centered frame, uploaded once; the
        # per-tile camera translates within this frame
        tri = jnp.asarray(
            verts[self.faces] - np.array([[cx, cy, 0.0]]), jnp.float32
        )
        x_left = cx - w * res / 2.0
        y_top = cy + h * res / 2.0

        def render(tile_w, tile_h, dx, dy):
            # Nadir camera far above the (sub-)scene: distance D, f = D/res
            dist = max(tile_w * res, tile_h * res, depth_range, 1e-6) * 40.0
            cam_z = zmax + dist
            c2w_local = np.array(
                [
                    [1.0, 0.0, 0.0, dx],
                    [0.0, -1.0, 0.0, dy],
                    [0.0, 0.0, -1.0, cam_z],
                    [0.0, 0.0, 0.0, 1.0],
                ]
            )
            w2c = jnp.asarray(np.linalg.inv(c2w_local), jnp.float32)
            return np.asarray(
                rasterize_triangles(
                    transform_to_camera(tri, w2c),
                    jnp.float32(dist / res),
                    image_w=tile_w,
                    image_h=tile_h,
                    config=self.raster_config,
                )
            )

        if w <= max_pixels and h <= max_pixels:
            p2f = render(w, h, 0.0, 0.0)
        else:
            tiles_x = -(-w // max_pixels)
            tiles_y = -(-h // max_pixels)
            tw = -(-w // tiles_x)
            th = -(-h // tiles_y)
            logger.info(
                "ortho_pix2face: tiling %dx%d px footprint into %dx%d "
                "tiles of %dx%d at the full %.3g m/px",
                w, h, tiles_x, tiles_y, tw, th, res,
            )
            p2f = np.full((h, w), -1, np.int32)
            for ti in range(tiles_y):
                for tj in range(tiles_x):
                    i0, j0 = ti * th, tj * tw
                    # every tile renders the SAME (th, tw) shape (one jit
                    # compile); edge tiles crop the paste
                    dx = (x_left + (j0 + tw / 2.0) * res) - cx
                    dy = (y_top - (i0 + th / 2.0) * res) - cy
                    tile = render(tw, th, dx, dy)
                    h_eff = min(th, h - i0)
                    w_eff = min(tw, w - j0)
                    p2f[i0:i0 + h_eff, j0:j0 + w_eff] = tile[:h_eff, :w_eff]
        # pixel (0, 0) is top-left = (cx - w*res/2, cy + h*res/2)
        bounds = (
            x_left,
            cy - h * res / 2.0,
            cx + w * res / 2.0,
            y_top,
        )
        return np.asarray(p2f), bounds, crs

    def export_face_labels_vector(
        self,
        face_labels: typing.Optional[np.ndarray] = None,
        export_file: typing.Optional[PATH_TYPE] = None,
        label_names: typing.Optional[dict] = None,
        resolution_m: float = 0.2,
        mode: str = "exact",
    ) -> VectorData:
        """Per-face labels -> geospatial polygons (reference
        meshes.py:1284-1423).

        ``mode="exact"`` (default) derives class regions combinatorially
        from shared mesh edges (utils/exact_geometry): every output
        vertex is an exact mesh vertex, matching the reference's GEOS
        union of face triangles (utils/geometric.py:13) bit-for-intent —
        sub-resolution features (seedlings, narrow crowns) survive.
        ``mode="raster"`` renders the faces orthographically at
        ``resolution_m`` and vectorizes class masks — useful for meshes
        whose top-down projection self-overlaps (bridges, dense canopy
        overhangs), where a 2.5D boundary walk is ill-defined.
        """
        if face_labels is None:
            face_labels = self.get_texture(request_vertex_texture=False)
        face_labels = np.asarray(face_labels).reshape(-1)
        if mode == "exact":
            from geograypher_tpu.utils.exact_geometry import (
                class_region_polygons,
            )

            crs = (
                self.get_working_projected_CRS()
                if self.CRS is not None
                else None
            )
            verts2d = self.get_vertices_in_CRS(crs)[:, :2]
            regions = class_region_polygons(
                verts2d, self.faces, face_labels
            )
            label_names = label_names or self.IDs_to_labels or {}
            geoms, names, ids = [], [], []
            for c in sorted(regions):
                for poly in regions[c]:
                    geoms.append(poly)
                    ids.append(int(c))
                    names.append(label_names.get(int(c), int(c)))
            out = VectorData(
                geoms,
                {"class_ID": ids, "names": [str(n) for n in names]},
                epsg=crs,
            )
            if export_file is not None:
                out.to_file(export_file)
            return out
        p2f, bounds, crs = self.ortho_pix2face(resolution_m=resolution_m)
        with np.errstate(invalid="ignore"):
            label_img = np.where(
                p2f >= 0, face_labels[np.clip(p2f, 0, None)], np.nan
            )
        classes = np.unique(label_img[np.isfinite(label_img)]).astype(int)
        geoms, names, ids = [], [], []
        label_names = label_names or self.IDs_to_labels or {}
        x0, y0, x1, y1 = bounds
        for c in classes:
            mask = label_img == c
            for poly in polygons_from_mask(mask, bounds):
                geoms.append(poly)
                ids.append(int(c))
                names.append(label_names.get(int(c), int(c)))
        out = VectorData(
            geoms,
            {"class_ID": ids, "names": [str(n) for n in names]},
            epsg=crs,
        )
        if export_file is not None:
            out.to_file(export_file)
        return out

    def label_polygons(
        self,
        face_labels: np.ndarray,
        polygons: typing.Union[PATH_TYPE, VectorData],
        face_weighting: typing.Optional[np.ndarray] = None,
        sjoin_overlay: bool = True,  # accepted for API parity; unused
        return_class_labels: bool = True,
        unknown_class_label: str = "unknown",
        resolution_m: float = 0.2,
        mode: str = "raster",
    ) -> list:
        """Assign each polygon the area-weighted dominant face class
        (reference meshes.py:1117-1282).

        ``mode="raster"`` (default) rasterizes both layers onto a common
        ortho grid; the joint histogram gives the reference's area
        weighting at ``resolution_m`` granularity — resolution-
        independent cost, right for survey-scale polygon sets.
        ``mode="exact"`` computes true triangle∩polygon intersection
        areas by convex clipping (utils/exact_geometry), matching the
        reference's GEOS overlay (meshes.py:1226-1253) with no raster
        quantization — right for small or narrow polygons.
        """
        if not isinstance(polygons, VectorData):
            polygons = VectorData.read_file(polygons)
        face_labels = np.asarray(face_labels).reshape(-1)
        if mode == "exact":
            return self._label_polygons_exact(
                face_labels, polygons, face_weighting,
                return_class_labels, unknown_class_label,
            )
        p2f, bounds, crs = self.ortho_pix2face(resolution_m=resolution_m)
        if polygons.epsg is not None and crs is not None:
            polygons = polygons.to_crs(crs)
        poly_img = rasterize_polygons(
            [g for g in polygons.geometries],
            list(range(len(polygons))),
            bounds,
            p2f.shape,
        )
        with np.errstate(invalid="ignore"):
            label_img = np.where(
                p2f >= 0, face_labels[np.clip(p2f, 0, None)], np.nan
            )
        weight_img = None
        if face_weighting is not None:
            face_weighting = np.asarray(face_weighting).reshape(-1)
            weight_img = np.where(
                p2f >= 0, face_weighting[np.clip(p2f, 0, None)], 0.0
            )
        # negative labels (e.g. -1 unlabeled sentinel) are ignored, like
        # the exact-mode sibling's face_labels >= 0 mask
        valid = (
            (poly_img >= 0)
            & np.isfinite(label_img)
            & (label_img >= 0)
        )
        n_classes = (
            int(np.nanmax(face_labels)) + 1
            if np.isfinite(face_labels).any() and np.nanmax(face_labels) >= 0
            else 1
        )
        flat_idx = poly_img[valid].astype(np.int64) * n_classes + label_img[
            valid
        ].astype(np.int64)
        weights = weight_img[valid] if weight_img is not None else None
        hist = np.bincount(
            flat_idx, weights=weights, minlength=len(polygons) * n_classes
        ).reshape(len(polygons), n_classes)
        best = np.argmax(hist, axis=1).astype(float)
        best[hist.sum(axis=1) == 0] = np.nan
        if return_class_labels:
            ids_to_labels = self.IDs_to_labels or {}
            return [
                unknown_class_label
                if np.isnan(b)
                else ids_to_labels.get(int(b), int(b))
                for b in best
            ]
        return best.tolist()

    def _label_polygons_exact(
        self,
        face_labels: np.ndarray,
        polygons: VectorData,
        face_weighting: typing.Optional[np.ndarray],
        return_class_labels: bool,
        unknown_class_label: str,
    ) -> list:
        """Exact-area polygon labeling via convex clipping (see
        label_polygons mode="exact")."""
        from geograypher_tpu.utils.exact_geometry import (
            polygon_overlay_areas,
        )

        crs = (
            self.get_working_projected_CRS()
            if self.CRS is not None
            else None
        )
        if polygons.epsg is not None and crs is not None:
            polygons = polygons.to_crs(crs)
        verts2d = self.get_vertices_in_CRS(crs)[:, :2]
        tris = verts2d[self.faces]
        finite = np.isfinite(face_labels) & (face_labels >= 0)
        n_classes = int(face_labels[finite].max()) + 1 if finite.any() else 1
        weighting = (
            np.asarray(face_weighting).reshape(-1)
            if face_weighting is not None
            else np.ones(len(face_labels))
        )
        best = np.full(len(polygons), np.nan)
        for pi, poly in enumerate(polygons.geometries):
            areas = polygon_overlay_areas(tris, poly)
            sel = (areas > 0) & finite
            if not sel.any():
                continue
            hist = np.bincount(
                face_labels[sel].astype(np.int64),
                weights=areas[sel] * weighting[sel],
                minlength=n_classes,
            )
            if hist.sum() > 0:
                best[pi] = float(np.argmax(hist))
        if return_class_labels:
            ids_to_labels = self.IDs_to_labels or {}
            return [
                unknown_class_label
                if np.isnan(b)
                else ids_to_labels.get(int(b), int(b))
                for b in best
            ]
        return best.tolist()

    # -- saving ---------------------------------------------------------------

    def save_renders(
        self,
        cameras: CameraSet,
        render_image_scale: float = 1.0,
        output_folder: PATH_TYPE = "renders",
        make_composites: bool = False,
        save_native_resolution: bool = True,
        cast_to_uint8: bool = True,
        output_extension: str = ".png",
        **render_kwargs,
    ):
        """Render per-camera label masks to disk (reference
        meshes.py:2215-2364).  Only PNG-style outputs and composites need
        the optional ``cv2``; ``.npy`` output does not."""
        from geograypher_tpu.utils.files import ensure_containing_folder
        from geograypher_tpu.utils.image import resize_nearest

        output_folder = Path(output_folder)
        for img, cam in self.render_flat(
            cameras,
            render_img_scale=render_image_scale,
            return_camera=True,
            **render_kwargs,
        ):
            fname = cam.image_filenames[0]
            rel = Path(fname.name if fname is not None else "render")
            out_path = (output_folder / rel).with_suffix(output_extension)
            ensure_containing_folder(out_path)
            data = img[..., 0] if img.shape[-1] == 1 else img
            if save_native_resolution and render_image_scale != 1.0:
                sensor = cam.sensors[cam.sensor_IDs[0]]
                data = resize_nearest(
                    data, sensor["image_height"], sensor["image_width"]
                )
            if output_extension == ".npy":
                np.save(out_path, data)
                continue
            import cv2

            if cast_to_uint8:
                out = np.where(np.isfinite(data), data, 255.0)
                out = np.clip(out, 0, 255).astype(np.uint8)
            else:
                out = data
            cv2.imwrite(str(out_path), out)
            if make_composites and fname is not None and Path(fname).exists():
                from geograypher_tpu.utils.io import read_image_or_numpy
                from geograypher_tpu.utils.visualization import (
                    create_composite,
                )

                rgb = read_image_or_numpy(fname)
                if rgb.shape[:2] != data.shape[:2]:
                    rgb = cv2.resize(rgb, (data.shape[1], data.shape[0]))
                comp = create_composite(rgb, data, self.IDs_to_labels)
                comp_path = out_path.with_name(out_path.stem + "_composite.png")
                cv2.imwrite(
                    str(comp_path),
                    (np.clip(comp, 0, 1) * 255).astype(np.uint8)[..., ::-1],
                )

    def export_covering_meshes(
        self,
        N: int,
        z_buffer: tuple = (0.0, 0.0),
        subsample: typing.Optional[int] = None,
        frame_transform: typing.Optional[np.ndarray] = None,
    ):
        """Ceiling/floor covering surfaces over the mesh footprint
        (reference meshes.py:2366-2447): an (N, N) grid of the per-cell
        max/min z, returned as (verts, faces) triangle meshes.

        ``frame_transform`` (local->ECEF 4x4) evaluates the covering in a
        camera set's local frame (the triangulation workflow's frame).

        Returns ((top_verts, top_faces), (bottom_verts, bottom_faces)).
        """
        if frame_transform is not None:
            points = self.get_verts_in_local_frame(frame_transform)
        else:
            points = self.verts
        if subsample is not None:
            points = points[::subsample]
        if len(points) == 0:
            empty = (np.zeros((0, 3)), np.zeros((0, 3), np.int32))
            return empty, empty
        x_min, y_min = points[:, 0].min(), points[:, 1].min()
        x_max, y_max = points[:, 0].max(), points[:, 1].max()
        cw = max((x_max - x_min) / (N - 1), 1e-9)
        ch = max((y_max - y_min) / (N - 1), 1e-9)
        ix = np.clip(np.round((points[:, 0] - x_min) / cw).astype(int), 0, N - 1)
        iy = np.clip(np.round((points[:, 1] - y_min) / ch).astype(int), 0, N - 1)
        cell = iy * N + ix
        z_hi = np.full(N * N, -np.inf)
        z_lo = np.full(N * N, np.inf)
        np.maximum.at(z_hi, cell, points[:, 2])
        np.minimum.at(z_lo, cell, points[:, 2])
        # Empty cells take the global extremes (conservative cover)
        z_hi[~np.isfinite(z_hi)] = points[:, 2].max()
        z_lo[~np.isfinite(z_lo)] = points[:, 2].min()
        z_hi = z_hi.reshape(N, N) + z_buffer[0]
        z_lo = z_lo.reshape(N, N) + z_buffer[1]

        xs = np.linspace(x_min, x_max, N)
        ys = np.linspace(y_min, y_max, N)
        xx, yy = np.meshgrid(xs, ys, indexing="xy")
        iy_g, ix_g = np.meshgrid(np.arange(N - 1), np.arange(N - 1), indexing="ij")
        v00 = (iy_g * N + ix_g).ravel()
        tri_a = np.stack([v00, v00 + 1, v00 + N + 1], axis=1)
        tri_b = np.stack([v00, v00 + N + 1, v00 + N], axis=1)
        faces = np.concatenate([tri_a, tri_b], axis=1).reshape(-1, 3).astype(np.int32)

        top = (
            np.stack([xx.ravel(), yy.ravel(), z_hi.ravel()], axis=1),
            faces,
        )
        bottom = (
            np.stack([xx.ravel(), yy.ravel(), z_lo.ravel()], axis=1),
            faces.copy(),
        )
        return top, bottom

    def export_html_viewer(
        self,
        path: PATH_TYPE,
        cameras: typing.Optional[CameraSet] = None,
        max_faces: int = 400_000,
        frustum_scale: typing.Optional[float] = None,
    ) -> None:
        """Write a self-contained interactive 3D viewer HTML (mesh colored
        by its texture + camera frustums).

        The headless counterpart of the reference's interactive VTK
        window (entrypoints/visualize.py:13-90, meshes.py:2054): instead
        of opening a window on a headless host, export one WebGL HTML file
        to open in any browser (see utils/html_viewer.py).
        """
        from geograypher_tpu.utils.html_viewer import (
            export_html_viewer,
            frustum_lines,
        )

        mesh = self
        if self.n_faces > max_faces:
            mesh = self.downsample(max_faces / self.n_faces)
        verts = mesh.get_verts_in_local_frame(cameras)
        tex = mesh.get_texture(
            request_vertex_texture=False, try_verts_faces_conversion=True
        )
        face_values = None
        if tex is not None:
            tex = np.asarray(tex)
            face_values = (
                np.nanargmax(np.nan_to_num(tex), axis=1).astype(float)
                if tex.ndim == 2 and tex.shape[1] > 1
                else tex.reshape(-1)
            )
        frustums = None
        if cameras is not None and len(cameras):
            span = float(
                np.abs(verts - verts.mean(axis=0)).max()
            ) or 1.0
            scale = frustum_scale or span * 0.08
            batch = cameras.get_camera_batch()
            frustums = [
                frustum_lines(
                    np.asarray(batch.cam_to_world[i]),
                    float(batch.f[i]),
                    batch.image_width,
                    batch.image_height,
                    scale=scale,
                )
                for i in range(len(cameras))
            ]
        export_html_viewer(
            path, verts, mesh.faces, face_values=face_values,
            frustums=frustums, title=str(path),
        )

    def save_mesh(self, savepath: PATH_TYPE, write_texture: bool = True):
        from geograypher_tpu.utils.meshio import save_mesh

        colors = None
        if write_texture and self.vertex_texture is not None:
            t = self.vertex_texture
            if t.shape[1] >= 3:
                colors = np.nan_to_num(t[:, :3])
            else:
                v = np.nan_to_num(t[:, 0])
                rng = v.max() - v.min() if v.size else 1.0
                g = (255 * (v - v.min()) / max(rng, 1e-9)).astype(np.uint8)
                colors = np.stack([g, g, g], axis=1)
        save_mesh(savepath, self.verts, self.faces, vert_colors=colors)
