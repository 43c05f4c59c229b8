"""scene.txt serialization, the inverse of parser.py.

The port's counterpart of ``mygpuraytracer_tpu/scene/writer.py``: writes a
Scene in the reference DSL (apps/src/scene.cpp grammar): MATERIAL blocks
with the fixed 7 property lines, OBJECT blocks (type, material link,
TRANS/ROTAT/SCALE), the CAMERA block.
"""

from __future__ import annotations

from .structs import GeomType, Scene


def _fmt(v) -> str:
    return " ".join(f"{float(x):g}" for x in v)


def scene_to_text(scene: Scene) -> str:
    out = []
    for i, m in enumerate(scene.materials):
        out.append(f"MATERIAL {i}")
        out.append(f"RGB         {_fmt(m.color)}")
        out.append(f"SPECEX      {m.specular_exponent:g}")
        out.append(f"SPECRGB     {_fmt(m.specular_color)}")
        out.append(f"REFL        {m.has_reflective:g}")
        out.append(f"REFR        {m.has_refractive:g}")
        out.append(f"REFRIOR     {m.index_of_refraction:g}")
        out.append(f"EMITTANCE   {m.emittance:g}")
        out.append("")

    st = scene.state
    cam = st.camera
    out.append("CAMERA")
    out.append(f"RES         {cam.resolution[0]} {cam.resolution[1]}")
    out.append(f"FOVY        {cam.fovy:g}")
    out.append(f"ITERATIONS  {st.iterations}")
    out.append(f"DEPTH       {st.trace_depth}")
    out.append(f"FILE        {st.image_name}")
    out.append(f"EYE         {_fmt(cam.position)}")
    out.append(f"LOOKAT      {_fmt(cam.look_at)}")
    out.append(f"UP          {_fmt(cam.up)}")
    out.append("")

    type_names = {
        GeomType.SPHERE: "sphere",
        GeomType.CUBE: "cube",
        GeomType.TRIANGLE: "triangle",
        GeomType.OBJ: "obj",
    }
    for i, g in enumerate(scene.geoms):
        out.append(f"OBJECT {i}")
        out.append(type_names[GeomType(g.type)])
        if g.type == GeomType.OBJ:
            out.append(getattr(g, "obj_path", "model.obj"))
        else:
            out.append(f"material {g.materialid}")
        out.append(f"TRANS       {_fmt(g.translation)}")
        out.append(f"ROTAT       {_fmt(g.rotation)}")
        out.append(f"SCALE       {_fmt(g.scale)}")
        out.append("")
    return "\n".join(out)


def save_scene(scene: Scene, path: str) -> None:
    with open(path, "w") as f:
        f.write(scene_to_text(scene))
