from .mesh import (Mesh, Mesh2D, create_mesh, create_mesh_2d, replicate,
                   shard_batch)
from .sharded_hmm import forward_sharded
