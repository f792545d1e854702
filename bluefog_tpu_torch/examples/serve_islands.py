"""Train-while-serving: an islands fleet gossips one model's parameters and
publishes snapshots that inference replicas hot-swap.

Each rank is an island process started by the launcher; rank 0's window
is a torch tensor on ``--device`` (the card by default), the others' on
the CPU.  The window holds the flat parameter vector of ``--model``
(random weights from ``--seed``; each rank scales its copy by ``1 + rank``
so the gossip has something to average).  For each of ``--versions``
versions every rank takes one local step (a stand-in for training: its
vector decays toward ``rank + 1``), the fleet runs two gossip
rounds (``win_put`` + ``win_update``, barriered), then rank 0 calls
``islands.serve_publish`` and waits until each of the ``--replicas``
replicas' status pages shows that version, so every replica installs
every version; ``--hold`` keeps the fleet up a while after the last one.
Rank 0 records each published estimate's
sha256 in ``--record`` (JSON), which a caller holds against the replicas'
``--report`` files.

Run under the launcher:
  python -m bluefog_tpu_torch.run.launcher --islands 2 --serve-replicas 1 \\
      --serve-report DIR -- python -m bluefog_tpu_torch.examples.serve_islands \\
      --replicas 1 --record DIR/publisher.json
(set ``BFTPU_SERVE_DEVICE=cpu`` for the replicas and pass ``--device cpu
--model lenet5`` here for a run without a card).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import torch

from bluefog_tpu_torch import islands, topology_util
from bluefog_tpu_torch.introspect import statuspage
from bluefog_tpu_torch.progress import staging
from bluefog_tpu_torch.serve.replica import REPLICA_RANK_BASE

WINDOW = "params"
ROUNDS = 2  # gossip rounds between two publishes
REPLICA_TIMEOUT_S = 120.0  # a replica's first install waits on its start


def flat_params(model: str, seed: int) -> torch.Tensor:
    """The model's parameters (random weights from ``seed``) as one flat
    f32 vector."""
    from bluefog_tpu_torch import models

    torch.manual_seed(seed)
    if model == "resnet50":
        m = models.ResNet50(num_classes=1000)
    elif model == "lenet5":
        m = models.LeNet5()
    else:
        raise ValueError(f"unknown model {model!r} (resnet50 | lenet5)")
    return torch.cat([p.detach().reshape(-1) for p in m.parameters()])


def _replica_versions(job: str, replicas: int):
    fleet = statuspage.read_fleet(job)
    return [fleet.get(REPLICA_RANK_BASE + i, {}).get("serve", {})
            .get("version", -1) for i in range(replicas)]


def wait_for_replicas(job: str, replicas: int, version: int,
                      timeout: float) -> float:
    """Block until every replica's status page serves ``version``; returns
    the seconds waited."""
    t0 = time.monotonic()
    while True:
        got = _replica_versions(job, replicas)
        if all(v >= version for v in got):
            return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"replicas serve {got} after {timeout:g} s, "
                               f"want version {version}")
        time.sleep(0.005)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50",
                    choices=("resnet50", "lenet5"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="rank 0's window device (default: the card)")
    ap.add_argument("--versions", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=0,
                    help="replicas to wait for after each publish (the "
                    "launcher's --serve-replicas)")
    ap.add_argument("--hold", type=float, default=0.0,
                    help="seconds every rank waits after the last version "
                    "before it frees the window, so an attached monitor "
                    "still reads the fleet's last state")
    ap.add_argument("--record", default="",
                    help="rank 0 writes the published versions, their "
                    "estimates' sha256 and the publish ms here")
    args = ap.parse_args(argv)

    islands.init()
    rank, size = islands.rank(), islands.size()
    job = islands._ctx().base_job
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    x = flat_params(args.model, args.seed) * float(1 + rank)
    x = x.to(args.device if rank == 0 else "cpu")
    islands.win_create(x, WINDOW)
    islands.barrier()
    published = []
    for _ in range(args.versions):
        x = islands.win_sync(WINDOW)
        islands.win_put(x * 0.99 + 0.01 * float(1 + rank), WINDOW)
        islands.barrier()
        islands.win_update(WINDOW)
        islands.barrier()
        for _ in range(ROUNDS):
            islands.win_put(islands.win_sync(WINDOW), WINDOW)
            islands.barrier()
            islands.win_update(WINDOW)
            islands.barrier()
        if rank == 0:
            est = islands.win_sync(WINDOW)
            digest = hashlib.sha256(
                staging.host_view(est.detach().cpu().contiguous()).tobytes()
            ).hexdigest()
            t0 = time.monotonic()
            version = islands.serve_publish(WINDOW)
            pub_ms = (time.monotonic() - t0) * 1e3
            waited = wait_for_replicas(job, args.replicas, version,
                                       REPLICA_TIMEOUT_S)
            published.append({"version": version, "sha256": digest,
                              "publish_ms": pub_ms,
                              "replica_wait_ms": waited * 1e3})
        islands.barrier()
    time.sleep(args.hold)
    if rank == 0 and args.record:
        with open(args.record, "w", encoding="utf-8") as f:
            json.dump({"model": args.model, "size": size,
                       "numel": int(x.numel()), "device": str(x.device),
                       "published": published}, f)
    islands.win_free(WINDOW)
    print(json.dumps({"rank": rank, "versions": len(published),
                      "ok": True}))
    islands.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
