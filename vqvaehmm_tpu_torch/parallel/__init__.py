from .mesh import Mesh, create_mesh, replicate, shard_batch
from .sharded_hmm import forward_sharded
