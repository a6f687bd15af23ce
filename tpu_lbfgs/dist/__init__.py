from .mesh import make_mesh, make_mesh_2d, result_shardings, state_shardings
from .multihost import global_mesh, initialize, is_coordinator
from .pallas_sharded import (
    SHARDED_PALLAS_PROBLEMS,
    shardmap_fused_tail,
    shardmap_fused_vg,
)
from .sharded import sharded_minimize, sharded_vmap_minimize
from .shardmap_vg import shardmap_value_and_grad
