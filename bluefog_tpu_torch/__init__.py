"""bluefog_tpu_torch: the PyTorch/CUDA port of bluefog_tpu.

Decentralized data-parallel training by neighbor averaging on the
rank-major backend: ``size`` virtual ranks along dim 0 of every tensor on
one device (the card unless the caller passes ``device="cpu"``).  Module
names follow the JAX package so each module's counterpart is easy to find.

    import bluefog_tpu_torch as bf
    bf.init(size=4)                       # cuda; raises without a card
    y = bf.neighbor_allreduce(x)          # x: [4, ...] on the card
    bf.win_create(x, "w"); bf.win_put(x, "w"); x = bf.win_update("w")

It exports every name of the JAX package's ``__init__`` except ``mesh``:
the sharding helpers have no counterpart on one device (see
:mod:`bluefog_tpu_torch.core.basics`).
"""

from bluefog_tpu_torch.version import __version__

from bluefog_tpu_torch.core.basics import (
    context,
    device,
    in_neighbor_machine_ranks,
    in_neighbor_ranks,
    init,
    is_initialized,
    is_machine_topo_weighted,
    is_topo_weighted,
    load_machine_topology,
    load_topology,
    local_rank,
    local_size,
    machine_rank,
    machine_size,
    out_neighbor_machine_ranks,
    out_neighbor_ranks,
    rank,
    set_machine_topology,
    set_topology,
    shutdown,
    size,
    unified_mpi_window_model_supported,
)
from bluefog_tpu_torch.algorithms import (
    DistributedEXTRAOptimizer,
    DistributedGradientTrackingOptimizer,
    DistributedPushDIGingOptimizer,
)
from bluefog_tpu_torch.ops import (
    Handle,
    allgather,
    allgather_nonblocking,
    allreduce,
    allreduce_nonblocking,
    barrier,
    broadcast,
    broadcast_nonblocking,
    device_sync,
    hierarchical_neighbor_allreduce,
    hierarchical_neighbor_allreduce_nonblocking,
    neighbor_allgather,
    neighbor_allgather_nonblocking,
    neighbor_allreduce,
    neighbor_allreduce_nonblocking,
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
from bluefog_tpu_torch.timeline import (
    timeline_context,
    timeline_end_activity,
    timeline_start_activity,
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
from bluefog_tpu_torch import topology_util

__all__ = [
    "__version__", "topology_util",
    "init", "shutdown", "is_initialized", "context", "size", "rank", "device",
    "local_size", "local_rank", "machine_size", "machine_rank",
    "set_topology", "load_topology", "set_machine_topology", "load_machine_topology",
    "in_neighbor_ranks", "out_neighbor_ranks", "in_neighbor_machine_ranks",
    "out_neighbor_machine_ranks", "is_topo_weighted", "is_machine_topo_weighted",
    "unified_mpi_window_model_supported",
    "Handle", "device_sync", "poll", "synchronize", "wait", "barrier",
    "allreduce", "allreduce_nonblocking", "broadcast", "broadcast_nonblocking",
    "allgather", "allgather_nonblocking", "neighbor_allgather",
    "neighbor_allgather_nonblocking", "neighbor_allreduce", "neighbor_allreduce_nonblocking",
    "hierarchical_neighbor_allreduce", "hierarchical_neighbor_allreduce_nonblocking",
    "CommunicationType", "DistributedAdaptThenCombineOptimizer",
    "DistributedAdaptWithCombineOptimizer", "DistributedGradientAllreduceOptimizer",
    "broadcast_parameters", "broadcast_optimizer_state",
    "DistributedWinPutOptimizer", "one_peer_plan_schedule",
    "DistributedGradientTrackingOptimizer", "DistributedEXTRAOptimizer",
    "DistributedPushDIGingOptimizer",
    "timeline_start_activity", "timeline_end_activity", "timeline_context",
    "win_create", "win_free", "win_put", "win_put_nonblocking", "win_get",
    "win_get_nonblocking", "win_accumulate", "win_accumulate_nonblocking",
    "win_update", "win_put_update", "win_update_then_collect", "win_wait", "win_poll",
    "win_mutex", "get_win_version", "win_associated_p", "win_set_exposed",
    "turn_on_win_ops_with_associated_p", "turn_off_win_ops_with_associated_p",
    "record_win_ops", "degraded_update_weights",
]
