"""Multi-device execution over ``torch.distributed`` (counterpart of
``deepaco_tpu/parallel/``): the ``(instance, ant)`` mesh, the row-sharded GNN
forward, the sharded TSP train step, the island colony search
(``mesh.multi_colony_tsp_search``) and the multi-process runtime
(``multihost``)."""
from deepaco_tpu_torch.parallel.gnn_shard import (
    edges_per_second_bench,
    sharded_embnet_forward,
)
from deepaco_tpu_torch.parallel.mesh import (
    make_mesh,
    make_sharded_tsp_train_step,
    shard_colony_search,
)

__all__ = [
    "edges_per_second_bench",
    "make_mesh",
    "make_sharded_tsp_train_step",
    "shard_colony_search",
    "sharded_embnet_forward",
]
