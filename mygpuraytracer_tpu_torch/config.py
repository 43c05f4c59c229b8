"""Runtime render configuration.

The same option names and defaults as ``mygpuraytracer_tpu/config.py`` (one
options object can drive both packages in a test). Options whose meaning was
specific to the TPU keep their names. The port reads every option but
``dtype``, which the JAX package reads nowhere either: ``rng`` (threefry,
or the K6 counter stream of ``ops/prng.py``), ``bounce_megakernel`` (the K5
route for large untextured meshes), and the wavefront's ``sort_by_material``
/ ``sort_impl``, ``cache_first_bounce`` and ``dir_aov``
(``render/pathtrace.py``).
"""

from __future__ import annotations

import dataclasses

SORT_IMPLS = ("fused", "perm", "argsort")


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Feature flags for one render pipeline instance.

    Defaults match the reference build (pathtrace.cu:36-42):
    DEPTH_OF_FIELD 0, CACHE_FIRST_BOUNCE 1, SORT_BY_MATERIAL 1,
    ANTIALIASING 1, BOUNDING_BOX 0, AI_DENOISE 1, JITTERED_SAMPLING 0.
    """

    depth_of_field: bool = False
    # First-bounce cache (pathtrace.cu:586-609): with AA and DoF off the
    # primary rays are the same every iteration, so iteration 1 stores its
    # first hit and later iterations reuse it (first_bounce_cache_active).
    cache_first_bounce: bool = True
    # Material-sorted wavefront (thrust::sort_by_key, pathtrace.cu:590,612):
    # each bounce reorders the lanes by descending material id before
    # shading. The image is bitwise identical either way (random numbers
    # follow the pixel id). Off by default, as in the JAX package; the
    # kernels (K1, K5) have no lane order to sort and ignore it.
    sort_by_material: bool = False
    antialiasing: bool = True
    # Per-ray mesh-AABB pre-test; image-identical either way.
    bounding_box: bool = False
    ai_denoise: bool = True
    # SH-L1 directional lightmap AOV: the luminance-weighted mean first-bounce
    # direction, the RTLightmap directional filter's input. Wavefront only
    # (the megakernel route is skipped), and it turns the sort off.
    dir_aov: bool = False
    jittered_sampling: bool = False

    # Thin-lens parameters (pathtrace.cu:279-280).
    lens_radius: float = 0.8
    focal_distance: float = 11.0

    # Faces per chunk of the Moller-Trumbore mesh stream (the result does
    # not depend on it).
    face_chunk: int = 64
    # The trace core's dtype on the TPU, kept by name so that one options
    # object drives both packages. Read by neither package: both trace in
    # float32.
    dtype: str = "float32"
    # The wavefront's and K5's random numbers (ops/prng.py): "threefry"
    # (bit-exact with jax.random), "pallas" (the K6 counter stream, a CUDA
    # kernel on CUDA) or "auto" (pallas off the CPU); the CPU always draws
    # threefry, as the JAX package does. K1 draws threefry whatever it says.
    rng: str = "threefry"
    # Run whole iterations in the K1 CUDA kernel (render/megakernel.py) for
    # scenes it supports; others take the wavefront path.
    megakernel: bool = False
    # With megakernel: meshes of more than 256 faces (untextured) run each
    # iteration's bounce loop in one K5 launch (csrc/bounce.cu) instead of
    # the wavefront.
    bounce_megakernel: bool = False
    # Mesh tiers for meshes of more than 256 faces (ops/trace.py): one
    # nearest-face query over 128-face clusters, which runs the mesh CUDA
    # kernel on CUDA tensors and its plain version on CPU tensors. None:
    # on for CUDA, off (chunked Moller-Trumbore) on the CPU.
    mesh_pallas: bool | None = None
    # Stable reorder of the rays before the tier query, scattered back (the
    # same result): "need"/True partitions by "can reach a mesh AABB",
    # "coherence" by origin cell and direction bin, False keeps pixel order;
    # None: the Renderer picks "need" on CUDA for a mesh embedded in a room.
    mesh_sort: bool | str | None = None
    # The rows tier's winner uv/TBN table: "f32" exact, "f16" half pairs,
    # "oct" half pairs + 8-bit octahedral TBN; "auto": oct on CUDA, f32 on
    # the CPU (the Renderer resolves it).
    winner_table: str = "auto"
    # "rows" (K2), "rows_dma" (the same here), "lists" (K3), "conds" (K4):
    # the TPU's three schedules of the one query; the same image.
    mesh_tier: str = "rows"
    # The sorted bounce's form, one stable descending-material permutation
    # in each: "fused" (one sort, one gather of the 16 per-lane arrays, 22
    # when textured, the material constants rebuilt from the key), "perm"
    # (counting sort, ops/compaction.py) or "argsort"; both gather every
    # field.
    sort_impl: str = "fused"

    def __post_init__(self):
        if self.sort_impl not in SORT_IMPLS:
            raise ValueError(f"unknown sort_impl {self.sort_impl!r}")

    @property
    def first_bounce_cache_active(self) -> bool:
        """First-bounce cache is compiled out when AA or DoF perturbs primary
        rays (pathtrace.cu:586,608)."""
        return self.cache_first_bounce and not self.antialiasing and not self.depth_of_field
