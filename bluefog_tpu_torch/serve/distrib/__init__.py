"""Snapshot distribution plane: delta fan-out trees for replica fleets.

One quorum-fenced publisher feeds hundreds of cross-host replicas:

- :mod:`.delta` — per-chunk dirty tracking over the PR-11 wire codec
  (bf16/int8 with error-feedback residuals; canonical wire-state with
  a CRC-checked bit-identity contract; horizon-bounded deltas with
  full-buffer resync beyond it);
- :mod:`.tree` — pure bounded-degree tree placement/repair math,
  shared verbatim by the production coordinator, the sim model, and
  ``analysis/distrib_rules.py``;
- :mod:`.feed` — feed servers (publisher and relays), the tree
  coordinator, the ``_OP_CHUNK``/``_OP_COMMIT`` delta framing;
- :mod:`.sub` — :class:`~.sub.TcpSource`, the TCP-backed region twin
  a :class:`~bluefog_tpu_torch.serve.replica.Replica` attaches by
  ``host:port``.

See docs/SERVING.md ("Cross-host distribution") for the protocol and
the death matrix.
"""

from bluefog_tpu_torch.serve.distrib.delta import (ChunkMeta, ChunkStore,  # noqa: F401
                                             DeltaEncoder,
                                             distrib_chunk_kb,
                                             distrib_fanout,
                                             distrib_horizon,
                                             distrib_retries,
                                             distrib_timeout_s)
from bluefog_tpu_torch.serve.distrib.feed import (DistribPublisher,  # noqa: F401
                                            FeedServer, parse_addr)
from bluefog_tpu_torch.serve.distrib.sub import TcpSource  # noqa: F401
from bluefog_tpu_torch.serve.distrib import tree  # noqa: F401

__all__ = [
    "ChunkMeta",
    "ChunkStore",
    "DeltaEncoder",
    "DistribPublisher",
    "FeedServer",
    "TcpSource",
    "parse_addr",
    "tree",
    "distrib_fanout",
    "distrib_horizon",
    "distrib_chunk_kb",
    "distrib_timeout_s",
    "distrib_retries",
]
