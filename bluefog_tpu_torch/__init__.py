"""bluefog_tpu_torch: the PyTorch/CUDA port of bluefog_tpu.

Decentralized data-parallel training by neighbor averaging on the
rank-major backend: ``size`` virtual ranks along dim 0 of every tensor on
one device (the card unless the caller passes ``device="cpu"``).  Module
names follow the JAX package so each module's counterpart is easy to find.

    import bluefog_tpu_torch as bf
    bf.init(size=4)                       # cuda; raises without a card
    y = bf.neighbor_allreduce(x)          # x: [4, ...] on the card
"""

from bluefog_tpu_torch.core.basics import (
    context,
    device,
    in_neighbor_ranks,
    init,
    is_initialized,
    is_topo_weighted,
    load_topology,
    out_neighbor_ranks,
    rank,
    set_topology,
    shutdown,
    size,
)
from bluefog_tpu_torch.ops import allreduce, broadcast, neighbor_allreduce
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer,
    DistributedGradientAllreduceOptimizer,
)

__all__ = [
    "init", "shutdown", "is_initialized", "context", "size", "rank", "device",
    "set_topology", "load_topology", "in_neighbor_ranks", "out_neighbor_ranks",
    "is_topo_weighted", "allreduce", "broadcast", "neighbor_allreduce",
    "CommunicationType", "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer", "DistributedGradientAllreduceOptimizer",
]
