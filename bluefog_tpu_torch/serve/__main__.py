"""One inference replica process: ``python -m bluefog_tpu_torch.serve``.

``bftpu-run --serve-replicas K`` spawns K of these next to the training
island.  The loop is deliberately boring — poll, maybe swap, serve —
because every interesting behavior (retry, staleness, chaos) lives in
:class:`bluefog_tpu_torch.serve.replica.Replica` where tests can reach it.

``--remote host:port`` (or ``BFTPU_SERVE_REMOTE``) attaches through
the snapshot distribution tree instead of the local shm region: the
replica joins the publisher's coordinator, feeds off its assigned
parent, and relays to its own children — the cross-host read path
(docs/SERVING.md, "Cross-host distribution").

``--device`` places the snapshot (``BFTPU_SERVE_DEVICE``, else the card;
``cpu`` for a run without one), and ``--report PATH`` writes, at exit, one JSON object with
the installed versions, each install's read and host-to-device ms, the
steps served and the sha256 of the last installed snapshot's bytes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time

from bluefog_tpu_torch.serve.replica import Replica, StaleSnapshotError
from bluefog_tpu_torch.serve.snapshot import SnapshotUnavailable


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.serve",
        description="Run one inference replica against a job's "
                    "snapshot region.")
    ap.add_argument("--job", required=True, help="job name to subscribe to")
    ap.add_argument("--replica-id", type=int, default=0)
    ap.add_argument("--remote", default=os.environ.get(
        "BFTPU_SERVE_REMOTE", ""),
        help="attach over TCP through the distribution tree "
        "(publisher's host:port) instead of the local shm region")
    ap.add_argument("--no-relay", action="store_true",
                    help="remote mode: never relay to children "
                    "(leaf-only subscriber)")
    ap.add_argument("--poll-s", type=float, default=0.02,
                    help="seconds between region polls")
    ap.add_argument("--steps", type=int, default=0,
                    help="exit after N serve steps (0 = run until killed)")
    ap.add_argument("--duration-s", type=float, default=0.0,
                    help="exit after this many seconds (0 = no limit)")
    ap.add_argument("--device", default=None,
                    help="torch device the snapshot is installed on "
                    "(default: BFTPU_SERVE_DEVICE, else the card)")
    ap.add_argument("--report", default="",
                    help="write the replica's installs, steps and last "
                    "snapshot digest here as JSON at exit")
    args = ap.parse_args(argv)

    source = None
    if args.remote:
        from bluefog_tpu_torch.serve.distrib import TcpSource

        source = TcpSource(args.remote, replica_id=args.replica_id,
                           relay=not args.no_relay)
    rep = Replica(args.job, args.replica_id, source=source,
                  device=args.device)
    # the launcher stops replicas with SIGTERM: exit through the finally
    # below, so the summary line and the report are written
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    t_end = time.monotonic() + args.duration_s if args.duration_s else None
    try:
        while True:
            try:
                rep.poll_swap()
                rep.serve_step()
            except SnapshotUnavailable:
                pass  # nothing committed yet — keep polling
            except StaleSnapshotError as e:
                print(f"[serve r{args.replica_id}] refusing: {e}",
                      file=sys.stderr)
            if args.steps and rep.serve_steps >= args.steps:
                break
            if t_end is not None and time.monotonic() >= t_end:
                break
            time.sleep(args.poll_s)
    finally:
        print(f"[serve r{args.replica_id}] version={rep.version} "
              f"swaps={rep.swaps} steps={rep.serve_steps} lag={rep.lag}")
        if args.report:
            _write_report(args.report, rep)
        if source is not None:
            source.close()
        rep.close()
    return 0


def _write_report(path: str, rep: Replica) -> None:
    from bluefog_tpu_torch.progress import staging

    digest = None
    if rep.version:
        _, snap = rep.serve_step()
        digest = hashlib.sha256(
            staging.host_view(snap.detach().cpu().contiguous()).tobytes()
        ).hexdigest()
    out = {"replica": rep.replica_id, "device": str(rep.device),
           "version": rep.version, "swaps": rep.swaps,
           "served": rep.serve_steps, "installs": list(rep.installs),
           "last_sha256": digest}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(out, f)
    os.replace(tmp, path)


if __name__ == "__main__":
    sys.exit(main())
