"""The fleet-monitor CLI.

    python -m bluefog_tpu_torch.monitor --job JOB --daemon        # scrape loop
    python -m bluefog_tpu_torch.monitor --job JOB --export        # JSON dump
    python -m bluefog_tpu_torch.monitor --job JOB --export --prom # Prometheus
    python -m bluefog_tpu_torch.monitor --job JOB --serve 9099    # HTTP /metrics
    python -m bluefog_tpu_torch.monitor --report DIR [DIR...]     # attribution
    bftpu-run --attach JOB monitor [...]                    # same thing

``--export``/``--serve`` attach to the mmap'd store read-only and work
even after the monitor (or the whole job) died — the history is in the
segment, not the process.  ``--report`` joins journaled ``alert``
windows to cause events and exits nonzero when any window is
unattributed, which is the machine-checkable "every incident
explained" gate the chaos e2e relies on.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

from bluefog_tpu_torch.monitor import report as report_mod
from bluefog_tpu_torch.monitor import store as store_mod
from bluefog_tpu_torch.monitor.scraper import MonitorDaemon


def _serve(job: str, port: int) -> int:
    """Minimal stdlib exporter: ``/metrics`` (Prometheus text) and
    ``/json`` over the job's store segment."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib naming)
            try:
                if self.path.startswith("/json"):
                    body = json.dumps(store_mod.export_json(job),
                                      indent=2).encode()
                    ctype = "application/json"
                else:
                    body = store_mod.export_prometheus(job).encode()
                    ctype = "text/plain; version=0.0.4"
            except FileNotFoundError:
                self.send_error(404, f"no monitor store for job {job!r}")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet: scrape targets are chatty
            pass

    httpd = HTTPServer(("", port), Handler)
    print(f"monitor exporter for job {job!r} on :{port} "
          f"(/metrics, /json)", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bftpu-monitor",
        description="Always-on fleet monitor: passive scraper, mmap'd "
        "time-series store, declarative alerts, incident attribution.")
    parser.add_argument("--job", default=None,
                        help="island job name (BLUEFOG_ISLAND_JOB)")
    parser.add_argument("--daemon", action="store_true",
                        help="run the scrape loop until the job's pages "
                        "disappear (or SIGTERM)")
    parser.add_argument("--interval", type=float, default=None,
                        help="scrape interval in seconds "
                        "(default BFTPU_MON_SCRAPE_S, 1.0)")
    parser.add_argument("--export", action="store_true",
                        help="dump the job's retained time series and exit")
    parser.add_argument("--prom", action="store_true",
                        help="with --export: Prometheus text format "
                        "instead of JSON")
    parser.add_argument("--serve", type=int, metavar="PORT", default=None,
                        help="serve /metrics and /json over HTTP")
    parser.add_argument("--report", nargs="+", metavar="PATH", default=None,
                        help="attribution report over journal files/dirs; "
                        "exits nonzero on unattributed alert windows")
    parser.add_argument("--margin", type=float, default=2.0,
                        help="attribution join margin in seconds")
    parser.add_argument("--json", action="store_true",
                        help="with --report: machine-readable JSON "
                        "(schema bftpu-monitor-report/1)")
    args = parser.parse_args(argv)

    if args.report is not None:
        rep = report_mod.monitor_report(args.report, margin_s=args.margin)
        print(json.dumps(rep, indent=2) if args.json
              else report_mod.format_report(rep))
        return 1 if rep["unattributed"] else 0

    if args.job is None:
        parser.error("--job is required (except with --report)")

    if args.export:
        try:
            if args.prom:
                sys.stdout.write(store_mod.export_prometheus(args.job))
            else:
                print(json.dumps(store_mod.export_json(args.job), indent=2))
        except FileNotFoundError as e:
            print(f"bftpu-monitor: {e}", file=sys.stderr)
            return 1
        return 0

    if args.serve is not None:
        return _serve(args.job, args.serve)

    if args.daemon:
        daemon = MonitorDaemon(args.job, interval=args.interval)

        def _term(signum, frame):
            daemon.stop = True

        signal.signal(signal.SIGTERM, _term)
        try:
            windows = daemon.run()
        except KeyboardInterrupt:
            daemon.close()
            windows = len(daemon.engine.windows)
        print(f"monitor: {daemon.scrapes} scrape(s), "
              f"{windows} alert window(s)", file=sys.stderr)
        return 0

    parser.error("pick one of --daemon / --export / --serve / --report")
    return 2


if __name__ == "__main__":
    sys.exit(main())
