"""bluefog_tpu_torch: the PyTorch/CUDA port of bluefog_tpu.

Decentralized data-parallel training by neighbor averaging on the
rank-major backend: ``size`` virtual ranks along dim 0 of every tensor on
one device (the card unless the caller passes ``device="cpu"``).  Module
names follow the JAX package so each module's counterpart is easy to find.

    import bluefog_tpu_torch as bf
    bf.init(size=4)                       # cuda; raises without a card
    y = bf.neighbor_allreduce(x)          # x: [4, ...] on the card
    bf.win_create(x, "w"); bf.win_put(x, "w"); x = bf.win_update("w")
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
from bluefog_tpu_torch.algorithms import (
    DistributedEXTRAOptimizer,
    DistributedGradientTrackingOptimizer,
    DistributedPushDIGingOptimizer,
)
from bluefog_tpu_torch.ops import (
    Handle,
    allreduce,
    broadcast,
    device_sync,
    neighbor_allreduce,
    poll,
    synchronize,
    wait,
)
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DistributedAdaptThenCombineOptimizer,
    DistributedAdaptWithCombineOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedWinPutOptimizer,
    broadcast_optimizer_state,
    broadcast_parameters,
    one_peer_plan_schedule,
)
from bluefog_tpu_torch.windows import (
    degraded_update_weights,
    get_win_version,
    record_win_ops,
    turn_off_win_ops_with_associated_p,
    turn_on_win_ops_with_associated_p,
    win_accumulate,
    win_accumulate_nonblocking,
    win_associated_p,
    win_create,
    win_free,
    win_get,
    win_get_nonblocking,
    win_mutex,
    win_poll,
    win_put,
    win_put_nonblocking,
    win_put_update,
    win_set_exposed,
    win_update,
    win_update_then_collect,
    win_wait,
)

__all__ = [
    "init", "shutdown", "is_initialized", "context", "size", "rank", "device",
    "set_topology", "load_topology", "in_neighbor_ranks", "out_neighbor_ranks",
    "is_topo_weighted", "allreduce", "broadcast", "neighbor_allreduce",
    "CommunicationType", "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer", "DistributedGradientAllreduceOptimizer",
    "broadcast_parameters", "broadcast_optimizer_state",
    "Handle", "device_sync", "poll", "synchronize", "wait",
    "DistributedWinPutOptimizer", "one_peer_plan_schedule",
    "DistributedGradientTrackingOptimizer", "DistributedEXTRAOptimizer",
    "DistributedPushDIGingOptimizer",
    "win_create", "win_free", "win_put", "win_put_nonblocking", "win_get",
    "win_get_nonblocking", "win_accumulate", "win_accumulate_nonblocking",
    "win_update", "win_put_update", "win_update_then_collect", "win_wait", "win_poll",
    "win_mutex", "get_win_version", "win_associated_p", "win_set_exposed",
    "turn_on_win_ops_with_associated_p", "turn_off_win_ops_with_associated_p",
    "record_win_ops", "degraded_update_weights",
]
