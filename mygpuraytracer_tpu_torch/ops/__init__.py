from .rng import make_key, bounce_uniforms
from .intersect import (
    Intersection,
    box_intersect,
    sphere_intersect,
    mesh_intersect,
    intersect_scene,
    fetch_texel,
)
from .sampling import (
    cosine_sample_hemisphere,
    jittered_sample_hemisphere,
    concentric_sample_disk,
    reflect,
    refract,
)
from .compaction import exclusive_scan, compact, sort_by_material_key
