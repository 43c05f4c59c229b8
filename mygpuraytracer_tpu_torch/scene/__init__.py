from .structs import (
    GeomType,
    Material,
    Camera,
    Geom,
    RenderState,
    Scene,
)
from .parser import load_scene
from .device_scene import DeviceScene, build_device_scene
