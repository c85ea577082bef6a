"""Device meshes and the row-sharded (spatially tiled) cascades."""

from .mesh import Mesh, make_mesh
from .spatial import build_tiled_slab_cascade, build_tiled_stylize_fn

__all__ = ["Mesh", "make_mesh", "build_tiled_slab_cascade", "build_tiled_stylize_fn"]
