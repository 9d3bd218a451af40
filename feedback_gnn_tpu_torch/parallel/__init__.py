"""Multi-device execution over ``torch.distributed``, the port of
``feedback_gnn_tpu/parallel``: the ('data', 'edge') grid of ranks
(mesh.py), the collectives with their autograd rules (collectives.py), the
edge partitioning of the Tanner graph (shard.py), the sharded evaluation
and train steps (api.py) and the launcher of worker processes (launch.py).

The decoders import ``parallel.collectives``, so ``api``'s names are loaded
at first use, not with this package.
"""

import importlib

from .mesh import Mesh, init_distributed, make_mesh
from .shard import shard_bounds, shard_quantum_graph, unstack_shard

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_bounds", "shard_quantum_graph",
           "unstack_shard", "make_sharded_eval_step", "make_sharded_train_step"]


def __getattr__(name):
    if name in ("make_sharded_eval_step", "make_sharded_train_step"):
        return getattr(importlib.import_module(".api", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
