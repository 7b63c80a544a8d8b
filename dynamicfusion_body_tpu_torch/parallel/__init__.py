"""The multi-device frame on ``torch.distributed`` — counterpart of
``dynamicfusion_body_tpu/parallel/``: the mesh (``mesh.py``), the sharded
fusion and solve (``sharded.py``), the sharded marching cubes
(``mc_sharded.py``), the sharded frame (``frame_sharded.py``), the
launcher (``launch.py``) and the whole-array rank functions
(``ranks.py``)."""

from .mesh import Mesh, make_mesh
from .sharded import (
    fuse_depth_sharded,
    solve_nonrigid_sharded,
    update_tsdf_nonrigid_sharded,
    update_tsdf_rigid_sharded,
)
