from .mesh import Mesh, make_mesh, make_mesh_2d
from .sharded import render_multichip_sample, sharded_render_step
