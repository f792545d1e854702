"""``bftpu-torch-run`` — the island launcher of ``bluefog_tpu_torch``
(counterpart of ``bluefog_tpu/run/launcher.py``, ``bftpu-run``).

It forks N asynchronous island processes (the ``mpirun -np N`` shape of
the reference's ``bfrun`` [U]): each gets ``BLUEFOG_ISLAND_RANK`` /
``SIZE`` / ``JOB`` and steps independently.  With ``-H`` the ranks spawn
on their hosts (fork for local ones, ssh for remote ones), the env
whitelist is forwarded, and the hostmap routes window traffic over shared
memory inside a host and TCP across hosts.  Single-host fleets are
elastic (``--self-heal``, ``--attach JOB scale +K`` over the control
socket), ``--serve-replicas K`` adds inference replicas
(``python -m bluefog_tpu_torch.serve``) that hot-swap every snapshot the
fleet publishes, and at exit the job's shm segments are reclaimed and its
telemetry and traces merged.

The reference's jax.distributed mode (``-np`` without ``--islands``,
``--coordinator``, ``--process-id``) and its ``--simulate`` CPU mesh wait
for the ``torch.distributed`` backend: asking for any of them is an
error that says so.  ``--monitor`` spawns the passive fleet monitor
(``python -m bluefog_tpu_torch.monitor --daemon``) beside the islands and
``--lab-probe`` turns on each rank's convergence probe.  Only this
package's environment is forwarded (no ``JAX_*`` / ``XLA_*`` / ``TPU_*``).

Usage:
  bftpu-torch-run --islands 4 python async_train.py  # N async islands
  bftpu-torch-run --islands 4 -H a:2,b:2 python async_train.py
                                               # islands across machines
                                               # (shm intra-host, TCP inter)
  bftpu-torch-run --islands 4 --self-heal python async_train.py
                                               # elastic fleet: signal-killed
                                               # ranks respawn as joiners
  bftpu-torch-run --islands 4 --serve-replicas 2 python async_train.py
                                               # + 2 inference replicas
                                               # hot-swapping published
                                               # weight snapshots
  bftpu-torch-run --islands 4 --monitor --lab-probe python async_train.py
                                               # + the fleet monitor and the
                                               # convergence probe
  bftpu-torch-run --attach JOB scale +2        # resize a running islands job
  bftpu-torch-run --attach JOB monitor         # the monitor's live export
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

__all__ = ["main", "build_env", "parse_hosts", "ssh_command", "env_whitelist",
           "control_sock_path"]

# Env forwarded to ssh-spawned ranks, by prefix (the reference forwards an
# explicit whitelist plus every ``-x NAME``; prefixes cover our namespaced
# config the same way).  The JAX package's launcher also forwards JAX_,
# XLA_, LIBTPU_ and TPU_, which mean nothing to this package.
_FORWARD_PREFIXES = ("BLUEFOG_", "BFTPU_", "PYTHONPATH")

_A9 = ("the jax.distributed mode has no counterpart here yet: it waits for "
       "the torch.distributed backend (ROADMAP A9); use --islands N")


def build_env(args, base_env=None) -> dict:
    """Compute the child environment (separated from exec for testability)."""
    env = dict(os.environ if base_env is None else base_env)
    if args.verbose:
        env["BLUEFOG_LOG_LEVEL"] = "debug"
    if args.timeline:
        env["BLUEFOG_TIMELINE"] = args.timeline
    if getattr(args, "adaptive", False):
        # islands mode: straggler-aware gossip (resilience/adaptive.py);
        # plain env spelling BFTPU_ADAPTIVE=1 is forwarded anyway
        env["BFTPU_ADAPTIVE"] = "1"
    if getattr(args, "lab_probe", False):
        # islands mode: per-rank convergence probe (lab/probe.py); plain
        # env spelling BFTPU_LAB_PROBE=1 is forwarded anyway
        env["BFTPU_LAB_PROBE"] = "1"
    if getattr(args, "monitor", False):
        # islands mode: spawn the passive fleet monitor next to the
        # workers (monitor/scraper.py); plain env spelling
        # BFTPU_MONITOR=1 is forwarded anyway
        env["BFTPU_MONITOR"] = "1"
    return env


def parse_hosts(spec: str) -> list:
    """``"hostA:2,hostB:4"`` -> ``[("hostA", 2), ("hostB", 4)]`` (the
    reference's ``-H``/``--hosts`` slot syntax [U]; a bare host means 1)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, slots = part.partition(":")
        if not host:
            raise ValueError(f"bad -H entry {part!r}: empty host")
        try:
            n = int(slots) if slots else 1
        except ValueError:
            raise ValueError(f"bad -H entry {part!r}: slots must be an int")
        if n < 1:
            raise ValueError(f"bad -H entry {part!r}: slots must be >= 1")
        out.append((host, n))
    if not out:
        raise ValueError(f"-H {spec!r} lists no hosts")
    return out


import functools


@functools.lru_cache(maxsize=None)
def _local_names() -> frozenset:
    # computed once: getfqdn can touch DNS
    return frozenset({"localhost", "127.0.0.1", "::1",
                      socket.gethostname(), socket.getfqdn()})


def _is_local_host(host: str) -> bool:
    """True for every name this machine answers to — including its FQDN,
    so `-H thismachine.example.com:4,...` forks locally instead of
    ssh-ing to itself."""
    return host in _local_names()


def env_whitelist(env: dict) -> dict:
    """The subset of ``env`` forwarded across ssh (prefix whitelist)."""
    return {k: v for k, v in env.items()
            if k.startswith(_FORWARD_PREFIXES)}


def ssh_command(host: str, cmd, env: dict, cwd: str,
                pidfile: str = None) -> list:
    """The ssh invocation for one remote rank: non-interactive, forwards
    the env whitelist inline (sshd's AcceptEnv cannot be assumed), recreates
    the working directory, and execs the user command.  ``pidfile`` records
    the remote shell's pid (kept by ``exec``) so teardown can kill the real
    remote process — killing the local ssh client alone would orphan it."""
    pid = f"echo $$ > {shlex.quote(pidfile)}; " if pidfile else ""
    inner = "{}cd {} && exec env {} {}".format(
        pid,
        shlex.quote(cwd),
        " ".join(f"{k}={shlex.quote(v)}" for k, v in sorted(env.items())),
        " ".join(shlex.quote(c) for c in cmd),
    )
    return ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no",
            host, inner]


class _Rank:
    """One spawned rank: the local Popen (the rank itself, or its ssh
    client) plus what remote teardown needs."""

    __slots__ = ("proc", "host", "pidfile")

    def __init__(self, proc, host, pidfile=None):
        self.proc = proc
        self.host = host
        self.pidfile = pidfile

    @property
    def remote(self):
        return self.pidfile is not None


def _spawn_rank(host: str, cmd, child_env: dict, tag: str, r: int) -> _Rank:
    """Spawn one rank: fork locally, ssh for a remote host.  Each child is
    its own process group so a launcher timeout can kill the whole tree."""
    if _is_local_host(host):
        proc = subprocess.Popen(cmd, env=child_env, start_new_session=True)
        return _Rank(proc, host)
    pidfile = f"/tmp/{tag}-r{r}.pid"
    full = ssh_command(host, cmd, env_whitelist(child_env), os.getcwd(),
                       pidfile=pidfile)
    return _Rank(subprocess.Popen(full, start_new_session=True), host, pidfile)


def _ssh_best_effort(host: str, script: str, timeout: float = 15.0):
    """Run a teardown/cleanup snippet on a remote host; failures are
    reported but never raised (the host may be unreachable already)."""
    try:
        subprocess.run(
            ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no",
             "-o", "ConnectTimeout=5", host, script],
            timeout=timeout, capture_output=True,
        )
    except Exception as e:  # noqa: BLE001
        print(f"bftpu-run: remote cleanup on {host} failed: {e!r}",
              file=sys.stderr)


def _kill_local(ranks, sig=signal.SIGTERM):
    for rk in ranks:
        if rk.proc.poll() is None:
            try:
                os.killpg(rk.proc.pid, sig)
            except (ProcessLookupError, PermissionError):
                rk.proc.send_signal(sig)


def _kill_remote(ranks, sig="TERM"):
    """Kill the real remote processes via their pidfiles (once, on
    teardown — the local ssh client's death does not reach them)."""
    for rk in ranks:
        if rk.remote and rk.proc.poll() is None:
            pf = shlex.quote(rk.pidfile)
            _ssh_best_effort(
                rk.host,
                f"test -f {pf} && kill -{sig} $(cat {pf}); rm -f {pf}",
            )


def _launch_grace_s() -> float:
    """How long surviving ranks get to finish after a sibling dies
    (``BFTPU_LAUNCH_GRACE_S``, default 5).  With the resilience layer a
    survivor can heal the topology and run to completion — killing it the
    instant a sibling fails would forfeit that; 0 restores the old
    immediate teardown."""
    try:
        return max(0.0, float(os.environ.get("BFTPU_LAUNCH_GRACE_S", "5")))
    except ValueError:
        return 5.0


def _supervise(ranks, timeout: float) -> int:
    """Poll ALL children until done: rank k can die while rank 0 blocks in
    the distributed rendezvous waiting for it — an in-order wait would only
    report the failure after a multi-minute rendezvous timeout.  On the first
    nonzero exit the survivors get a grace period (they may heal and
    finish — see docs/RESILIENCE.md), then the rest are torn down,
    including the REAL processes behind ssh clients; the FIRST failing
    exit code is what propagates.  ``--timeout`` expiry tears down
    immediately."""
    code = 0
    deadline = time.monotonic() + timeout if timeout else None
    grace_deadline = None
    live = list(ranks)

    def teardown(sig=signal.SIGTERM):
        _kill_remote(ranks)
        _kill_local(ranks, sig)

    try:
        while live:
            for rk in list(live):
                rc = rk.proc.poll()
                if rc is None:
                    continue
                live.remove(rk)
                if rc != 0 and code == 0:
                    code = rc
                    grace = _launch_grace_s()
                    if grace > 0 and live:
                        grace_deadline = time.monotonic() + grace
                        print(
                            f"bftpu-run: a rank failed (exit {rc}); "
                            f"giving {len(live)} surviving rank(s) "
                            f"{grace:g}s to finish", file=sys.stderr)
                    else:
                        teardown()
            if live and grace_deadline is not None \
                    and time.monotonic() > grace_deadline:
                print(f"bftpu-run: grace expired; killing {len(live)} "
                      f"surviving rank(s)", file=sys.stderr)
                grace_deadline = None
                teardown()
            if live and deadline is not None and time.monotonic() > deadline:
                print(f"bftpu-run: timeout after {timeout:g}s; killing "
                      f"{len(live)} live rank(s)", file=sys.stderr)
                teardown()
                time.sleep(2.0)
                _kill_local(ranks, signal.SIGKILL)
                return 124
            if live:
                time.sleep(0.05)
    except KeyboardInterrupt:
        teardown(signal.SIGINT)
        code = 130
    finally:
        # _kill_remote's rm -f only reaches STILL-LIVE ranks, so cleanly
        # exited remote ranks leaked their pidfiles on every return path
        # (incl. timeout).  Collect them here, one ssh per host (idempotent;
        # finally covers the early `return 124` too).
        by_host = {}
        for rk in ranks:
            if rk.remote:
                by_host.setdefault(rk.host, []).append(rk.pidfile)
        for host, pfs in sorted(by_host.items()):
            _ssh_best_effort(
                host, "rm -f " + " ".join(shlex.quote(p) for p in pfs))
    return code


def _supervise_islands(ranks, timeout: float, spawn_joiner, self_heal: bool,
                       state: dict) -> int:
    """:func:`_supervise`, plus the elastic behaviors of an islands run:
    a control-socket ``scale`` request spawns extra JOINER ranks
    mid-run, and with ``--self-heal`` a rank that dies BY SIGNAL
    (SIGKILL'd mid-``win_put``, OOM-killed, ...) is replaced by a fresh
    joiner — never its old global rank, per the monotone dead-set
    contract — while the survivors heal around the corpse.  A rank that
    exits nonzero on its own still fails the run (user-code bugs must
    not loop forever through respawns); the respawn budget
    (``BFTPU_MAX_RESPAWNS``) bounds the healing too."""
    code = 0
    deadline = time.monotonic() + timeout if timeout else None
    grace_deadline = None
    live = list(ranks)
    respawns_left = _respawn_budget()

    def teardown(sig=signal.SIGTERM):
        _kill_remote(ranks)
        _kill_local(ranks, sig)

    try:
        while live:
            with state["lock"]:
                todo = state["scale_requests"]
                state["scale_requests"] = 0
            for _ in range(todo):
                rk = spawn_joiner()
                ranks.append(rk)
                live.append(rk)
                with state["lock"]:
                    state["joiners"] += 1
                print(f"bftpu-run: scale request — spawned joiner "
                      f"(pid {rk.proc.pid})", file=sys.stderr)
            for rk in list(live):
                rc = rk.proc.poll()
                if rc is None:
                    continue
                live.remove(rk)
                if rc < 0 and self_heal and code == 0:
                    if respawns_left > 0:
                        respawns_left -= 1
                        nk = spawn_joiner()
                        ranks.append(nk)
                        live.append(nk)
                        with state["lock"]:
                            state["joiners"] += 1
                        print(
                            f"bftpu-run: rank died on signal {-rc}; "
                            f"self-heal spawned replacement joiner "
                            f"(pid {nk.proc.pid}, "
                            f"{respawns_left} respawn(s) left)",
                            file=sys.stderr)
                        continue
                    print("bftpu-run: respawn budget exhausted "
                          "(BFTPU_MAX_RESPAWNS)", file=sys.stderr)
                if rc != 0 and code == 0:
                    code = rc
                    grace = _launch_grace_s()
                    if grace > 0 and live:
                        grace_deadline = time.monotonic() + grace
                        print(
                            f"bftpu-run: a rank failed (exit {rc}); "
                            f"giving {len(live)} surviving rank(s) "
                            f"{grace:g}s to finish", file=sys.stderr)
                    else:
                        teardown()
            with state["lock"]:
                state["live"] = len(live)
            if live and grace_deadline is not None \
                    and time.monotonic() > grace_deadline:
                print(f"bftpu-run: grace expired; killing {len(live)} "
                      f"surviving rank(s)", file=sys.stderr)
                grace_deadline = None
                teardown()
            if live and deadline is not None and time.monotonic() > deadline:
                print(f"bftpu-run: timeout after {timeout:g}s; killing "
                      f"{len(live)} live rank(s)", file=sys.stderr)
                teardown()
                time.sleep(2.0)
                _kill_local(ranks, signal.SIGKILL)
                return 124
            if live:
                time.sleep(0.05)
    except KeyboardInterrupt:
        teardown(signal.SIGINT)
        code = 130
    return code


def control_sock_path(job: str) -> str:
    """The supervisor's control socket for an islands run — what
    ``bftpu-run --attach JOB`` dials to resize the fleet without a
    restart."""
    return os.path.join(tempfile.gettempdir(), f"bftpu-run-{job}.sock")


def _respawn_budget() -> int:
    """How many signal-killed ranks a ``--self-heal`` run will replace
    (``BFTPU_MAX_RESPAWNS``, default 2) — a budget, not a loop: a rank
    that keeps getting killed should eventually fail the run."""
    try:
        return max(0, int(os.environ.get("BFTPU_MAX_RESPAWNS", "2")))
    except ValueError:
        return 2


class _Control:
    """Line-JSON control server on a unix socket: ``scale`` enqueues
    extra joiner ranks, ``status``/``top`` report the fleet, ``trace``
    publishes the runtime trace-control word.  Handlers only
    enqueue/read — the supervisor loop owns all process state."""

    def __init__(self, job: str, state: dict):
        self.job = job
        self.path = control_sock_path(job)
        try:
            os.unlink(self.path)
        except OSError:
            pass
        self.state = state  # {"lock", "scale_requests", "live", "joiners"}
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(self.path)
        self.sock.listen(4)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        st = self.state
        if cmd == "scale":
            n = int(req.get("n", 1))
            if n < 1:
                return {"ok": False, "error": f"scale n must be >= 1, got {n}"}
            with st["lock"]:
                st["scale_requests"] += n
            return {"ok": True, "queued": n}
        if cmd == "status":
            with st["lock"]:
                return {"ok": True, "live": st["live"],
                        "joiners": st["joiners"],
                        "pending_scale": st["scale_requests"]}
        if cmd == "top":
            # launcher-side half of the bftpu-top view; the client merges
            # this with the shm status pages it reads directly
            with st["lock"]:
                return {"ok": True, "job": self.job, "live": st["live"],
                        "joiners": st["joiners"],
                        "pending_scale": st["scale_requests"]}
        if cmd == "trace":
            from bluefog_tpu_torch.introspect import statuspage as _sp

            mode = {"on": _sp.TRACE_ON, "off": _sp.TRACE_OFF,
                    "default": _sp.TRACE_DEFAULT}.get(req.get("mode"))
            if mode is None:
                return {"ok": False,
                        "error": f"trace mode must be on|off|default, "
                                 f"got {req.get('mode')!r}"}
            gen = _sp.publish_trace_control(self.job, mode)
            return {"ok": True, "mode": req["mode"], "generation": gen}
        return {"ok": False, "error": f"unknown command {cmd!r}"}

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            try:
                line = conn.makefile("r").readline()
                rep = self._handle(json.loads(line))
            except Exception as e:  # noqa: BLE001 — report, don't die
                rep = {"ok": False, "error": repr(e)}
            try:
                conn.sendall((json.dumps(rep) + "\n").encode())
            except OSError:
                pass
            conn.close()

    def stop(self):
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


def attach_main(job: str, command) -> int:
    """``bftpu-run --attach JOB [scale +K | status | top .. | trace ..]``
    — the client side of the control socket (``top`` additionally reads
    the shm status pages directly; see ``python -m
    bluefog_tpu_torch.introspect``)."""
    if not command:
        command = ["status"]
    if command[0] == "top":
        from bluefog_tpu_torch.introspect.__main__ import main as top_main

        return top_main(["--job", job] + list(command[1:]))
    if command[0] == "monitor":
        # fleet monitor: scrape daemon / store export / attribution
        # report, all over shm + journals — no control socket needed
        from bluefog_tpu_torch.monitor.__main__ import main as mon_main

        rest = list(command[1:])
        if not any(a in ("--daemon", "--export", "--serve", "--report")
                   for a in rest):
            rest = ["--daemon"] + rest
        return mon_main(["--job", job] + rest)
    if command[0] == "trace":
        if len(command) < 2 or command[1] not in ("on", "off", "default"):
            print("bftpu-run: trace needs a mode: trace on|off|default",
                  file=sys.stderr)
            return 2
        req = {"cmd": "trace", "mode": command[1]}
        path = control_sock_path(job)
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(path)
            s.sendall((json.dumps(req) + "\n").encode())
            line = s.makefile("r").readline()
            s.close()
            print(line.strip())
            return 0 if json.loads(line).get("ok") else 1
        except (OSError, ValueError):
            # no launcher (e.g. the job was spawned in-process): publish
            # the trace-control word directly — workers poll the word,
            # not the socket
            from bluefog_tpu_torch.introspect import statuspage as _sp

            mode = {"on": _sp.TRACE_ON, "off": _sp.TRACE_OFF,
                    "default": _sp.TRACE_DEFAULT}[command[1]]
            gen = _sp.publish_trace_control(job, mode)
            print(json.dumps({"ok": True, "mode": command[1],
                              "generation": gen, "via": "word"}))
            return 0
    if command[0] == "scale":
        if len(command) < 2:
            print("bftpu-run: scale needs a count: scale +K",
                  file=sys.stderr)
            return 2
        try:
            n = int(command[1].lstrip("+"))
        except ValueError:
            print(f"bftpu-run: bad scale count {command[1]!r}",
                  file=sys.stderr)
            return 2
        req = {"cmd": "scale", "n": n}
    elif command[0] == "status":
        req = {"cmd": "status"}
    else:
        print(f"bftpu-run: unknown control command {command[0]!r} "
              "(expected: scale +K, status, top, monitor, "
              "trace on|off|default)",
              file=sys.stderr)
        return 2
    path = control_sock_path(job)
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(path)
        s.sendall((json.dumps(req) + "\n").encode())
        line = s.makefile("r").readline()
        s.close()
    except OSError as e:
        print(f"bftpu-run: cannot reach {path} — is the islands run "
              f"still up? ({e})", file=sys.stderr)
        return 1
    print(line.strip())
    try:
        return 0 if json.loads(line).get("ok") else 1
    except ValueError:
        return 1


def _pick_port() -> int:
    """An ephemeral port for the rendezvous.  Bind-then-close is a TOCTOU
    (another process may grab it before the children bind), and for a
    REMOTE head host the probe says nothing at all — both launch paths
    therefore retry once with a fresh port when every child dies
    immediately (the observable signature of a rendezvous bind failure)."""
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _head_address(by_rank) -> str:
    """The rendezvous host every rank can reach.  Loopback only works when
    all ranks share this machine; a locally-spelled first host must be
    replaced with this machine's externally reachable name when any rank
    is remote."""
    if all(_is_local_host(h) for h in by_rank):
        return "127.0.0.1"
    head = by_rank[0]
    return socket.getfqdn() if _is_local_host(head) else head


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="bftpu-torch-run",
        description="Launch a bluefog_tpu_torch islands fleet (and its "
        "inference replicas).",
    )
    parser.add_argument(
        "-np",
        type=int,
        default=None,
        help="total number of processes; only the jax.distributed mode "
        "reads it, which waits for ROADMAP A9 (use --islands N)",
    )
    parser.add_argument(
        "-H", "--hosts",
        default=None,
        metavar="HOST:SLOTS,...",
        help="host list with slot counts (reference bfrun -H [U]): ranks "
        "are spawned host-major, over ssh for remote hosts.  Works with "
        "-np (counts must agree) and with --islands (sets the hostmap so "
        "window traffic rides shm intra-host and TCP inter-host)",
    )
    parser.add_argument(
        "--coordinator",
        default=None,
        help="jax.distributed coordinator (waits for ROADMAP A9)",
    )
    parser.add_argument(
        "--process-id", type=int, default=None,
        help="jax.distributed process index (waits for ROADMAP A9)"
    )
    parser.add_argument(
        "--timeout",
        type=float,
        default=0.0,
        help="kill the whole launch after this many seconds (0 = no limit); "
        "guards against a child hanging in the distributed rendezvous",
    )
    parser.add_argument(
        "--simulate",
        type=int,
        default=0,
        metavar="N",
        help="the JAX package's virtual CPU mesh (waits for ROADMAP A9; "
        "this package runs N rank-major ranks in one process with "
        "init(size=N))",
    )
    parser.add_argument(
        "--islands",
        type=int,
        default=0,
        metavar="N",
        help="spawn N asynchronous island processes (bluefog_tpu_torch.islands): "
        "each gets BLUEFOG_ISLAND_RANK/SIZE/JOB and steps independently — "
        "the direct analogue of the reference's `bfrun -np N` process model",
    )
    parser.add_argument(
        "--job",
        default=None,
        help="island job name (shared-memory namespace); default: pid-derived",
    )
    parser.add_argument(
        "--self-heal",
        action="store_true",
        help="islands mode: replace a signal-killed rank with a fresh "
        "joiner process (up to BFTPU_MAX_RESPAWNS) instead of failing "
        "the run — the survivors heal, the replacement rejoins under a "
        "new global rank",
    )
    parser.add_argument(
        "--adaptive",
        action="store_true",
        help="islands mode: enable the adaptive edge-health control loop "
        "(BFTPU_ADAPTIVE=1) — deadline-missed edges are absorbed per "
        "round and a persistently slow rank is demoted to one anchor "
        "edge instead of convoying the fleet (docs/RESILIENCE.md, "
        "'Adaptive topology')",
    )
    parser.add_argument(
        "--lab-probe",
        action="store_true",
        help="islands mode: stream the per-rank convergence probe "
        "(BFTPU_LAB_PROBE=1) — each win_update publishes the debiased "
        "consensus error to telemetry and the status page's CONV "
        "column (docs/OBSERVABILITY.md, 'Convergence observatory')",
    )
    parser.add_argument(
        "--monitor",
        action="store_true",
        help="islands mode: spawn the passive fleet monitor "
        "(BFTPU_MONITOR=1) — a scrape daemon polling every rank's "
        "status page, retaining time series in an mmap'd store and "
        "raising declarative alerts (docs/OBSERVABILITY.md, "
        "'Fleet monitor'); attach later with "
        "bftpu-run --attach JOB monitor",
    )
    parser.add_argument(
        "--serve-replicas",
        type=int,
        default=0,
        metavar="K",
        help="islands mode: spawn K inference replica processes "
        "(python -m bluefog_tpu_torch.serve; their device is "
        "BFTPU_SERVE_DEVICE, else the card) subscribed to the job's snapshot "
        "region — each hot-swaps to every version the training fleet "
        "publishes via islands.serve_publish, with zero serving "
        "downtime; replicas are torn down when the fleet exits "
        "(docs/SERVING.md)",
    )
    parser.add_argument(
        "--serve-remote",
        default=None,
        metavar="HOST:PORT",
        help="islands mode, with --serve-replicas: attach the replicas "
        "over TCP through the snapshot distribution tree rooted at the "
        "given publisher feed address, instead of the local shm region "
        "— the cross-host read path (each replica joins the tree, "
        "feeds off its assigned parent, and relays to its children; "
        "docs/SERVING.md, 'Cross-host distribution')",
    )
    parser.add_argument(
        "--serve-report",
        default=None,
        metavar="DIR",
        help="with --serve-replicas: each replica writes its installs, "
        "steps and last snapshot digest to DIR/replica-<i>.json at exit",
    )
    parser.add_argument(
        "--attach",
        default=None,
        metavar="JOB",
        help="dial a running islands job's control socket instead of "
        "launching: `bftpu-run --attach JOB scale +K` admits K extra "
        "ranks, `... status` reports the fleet, `... top` opens the "
        "live bftpu-top view, `... trace on|off` toggles tracing at "
        "runtime",
    )
    parser.add_argument("--timeline", default=None, help="write a Chrome trace here")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("command", nargs=argparse.REMAINDER, help="program to run")
    args = parser.parse_args(argv)

    if args.attach:
        cmd = args.command
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]
        return attach_main(args.attach, cmd)
    if not args.command:
        parser.error("no command given; usage: bftpu-torch-run [options] "
                     "python train.py")
    if args.simulate:
        parser.error(f"--simulate: {_A9}")
    if (args.coordinator or args.process_id is not None) and not args.islands:
        parser.error(f"--coordinator / --process-id: {_A9}")
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]

    hosts = parse_hosts(args.hosts) if args.hosts else None
    if hosts is not None:
        total = sum(s for _, s in hosts)
        if args.islands:
            if args.islands != total:
                parser.error(f"--islands {args.islands} but -H lists {total} slots")
        elif args.np is not None and args.np != total:
            parser.error(f"-np {args.np} but -H lists {total} slots")
        else:
            parser.error(f"-H without --islands: {_A9}")

    if args.serve_replicas and not args.islands:
        parser.error("--serve-replicas requires --islands (the snapshot "
                     "region is published by an islands fleet)")
    if args.monitor and not args.islands:
        parser.error("--monitor requires --islands (the scraper polls "
                     "the fleet's per-rank status pages)")
    if args.serve_remote and not args.serve_replicas:
        parser.error("--serve-remote requires --serve-replicas (it "
                     "selects how those replicas attach)")
    if not args.islands:
        parser.error(f"no --islands N given: {_A9}")
    env = build_env(args)
    if args.islands:
        return _run_islands(cmd, env, args.islands, args.job, hosts,
                            args.timeout, self_heal=args.self_heal,
                            serve_replicas=args.serve_replicas,
                            serve_remote=args.serve_remote,
                            serve_report=args.serve_report)


def _rank_hosts(hosts, nprocs: int) -> list:
    """Host of each rank, host-major (``-H a:2,b:2`` -> a,a,b,b)."""
    if hosts is None:
        return ["localhost"] * nprocs
    out = []
    for host, slots in hosts:
        out.extend([host] * slots)
    return out


def _cleanup_island_segments(job: str, by_rank) -> None:
    """Reclaim the job's shm segments on EVERY host: a later run reusing
    the job name must never attach to stale mailboxes/barrier state.
    Remote hosts get a best-effort ssh cleanup (same env whitelist, so
    PYTHONPATH reaches the package)."""
    from bluefog_tpu_torch.native import shm_native

    shm_native.unlink_all(job)
    pypath = os.environ.get("PYTHONPATH", "")
    snippet = (
        "from bluefog_tpu_torch.native import shm_native; "
        f"shm_native.unlink_all({job!r})"
    )
    for host in sorted({h for h in by_rank if not _is_local_host(h)}):
        _ssh_best_effort(
            host,
            "env PYTHONPATH={} {} -c {}".format(
                shlex.quote(pypath), shlex.quote(sys.executable or "python3"),
                shlex.quote(snippet),
            ),
        )


def _collect_telemetry(env: dict, job: str) -> None:
    """Best-effort cross-rank aggregation: merge the per-rank snapshot
    files the ranks wrote at exit into one summary (JSON + Prometheus
    text).  No-op when BFTPU_TELEMETRY is off; never fails the run."""
    try:
        from bluefog_tpu_torch.telemetry.merge import merge_job_snapshots

        out = merge_job_snapshots(env.get("BFTPU_TELEMETRY"), job)
        if out:
            print(f"bftpu-run: telemetry merged -> {out}", file=sys.stderr)
    except Exception as e:  # telemetry must never mask the run's exit code
        print(f"bftpu-run: telemetry merge failed: {e}", file=sys.stderr)


def _collect_traces(env: dict, job: str) -> None:
    """Best-effort trace post-processing: convert flight rings left by
    ranks that died without dumping (SIGKILL), then stitch the per-rank
    span buffers into one merged Chrome trace.  No-op when BFTPU_TRACING
    is off; never fails the run."""
    raw = env.get("BFTPU_TRACING", "")
    if not raw or raw == "0":
        return
    try:
        from bluefog_tpu_torch import tracing as _tracing
        from bluefog_tpu_torch.tracing.tracer import _DEFAULT_DIR

        d = _DEFAULT_DIR if raw == "1" else raw
        if not d or not os.path.isdir(d):
            return
        converted = _tracing.convert_flight_rings(job, d, reason="launcher")
        for p in converted:
            print(f"bftpu-run: flight ring recovered -> {p}",
                  file=sys.stderr)
        traces = []
        for p in _tracing.find_traces([d]):
            try:
                t = _tracing.load_trace(p)
            except (OSError, ValueError):
                continue
            if t is not None and t.get("job") == job:
                traces.append(t)
        if not traces:
            return
        merged = _tracing.merge_traces(traces)
        out = os.path.join(d, f"merged-trace-{job}.json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(merged, f)
            f.write("\n")
        print(f"bftpu-run: traces merged ({len(traces)} ranks) -> {out}",
              file=sys.stderr)
    except Exception as e:  # tracing must never mask the run's exit code
        print(f"bftpu-run: trace merge failed: {e}", file=sys.stderr)


def _run_islands(cmd, env, nranks: int, job, hosts, timeout: float,
                 self_heal: bool = False, serve_replicas: int = 0,
                 serve_remote=None, serve_report=None) -> int:
    """Fork N island processes (the `mpirun -np N` shape of the reference's
    launcher [U]).  With ``-H``, ranks spawn on their hosts over ssh and
    the hostmap/coordinator env is set so window traffic rides shared
    memory intra-host and TCP inter-host (routed transport).  Returns the
    first nonzero child exit code, tearing the others down on failure.

    Single-host runs are ELASTIC: a control socket
    (:func:`control_sock_path`) accepts ``scale`` requests from
    ``bftpu-run --attach JOB scale +K``, and ``--self-heal`` replaces
    signal-killed ranks with fresh joiner processes
    (``BLUEFOG_ISLAND_JOINER=1`` routes ``islands.init`` to
    ``islands.join``).  Multi-host fleets keep the fixed-size
    supervisor — cross-host respawn placement is not implemented."""
    job = job or f"bfrun{os.getpid()}"
    by_rank = _rank_hosts(hosts, nranks)
    multi_host = hosts is not None and len(set(by_rank)) > 1
    tag = f"bfrun-{os.getpid()}-{int(time.time())}"
    code = 1

    def spawn_joiner() -> _Rank:
        jc = dict(env)
        jc.pop("BLUEFOG_ISLAND_RANK", None)
        jc["BLUEFOG_ISLAND_JOINER"] = "1"
        jc["BLUEFOG_ISLAND_SIZE"] = str(nranks)
        jc["BLUEFOG_ISLAND_JOB"] = job
        spawn_joiner.idx += 1
        return _spawn_rank("localhost", cmd, jc, tag,
                           10000 + spawn_joiner.idx)

    spawn_joiner.idx = 0

    for attempt in (0, 1):
        coord = (f"{_head_address(by_rank)}:{_pick_port()}"
                 if multi_host else None)
        t0 = time.monotonic()
        ranks = []
        for r in range(nranks):
            child_env = dict(env)
            child_env["BLUEFOG_ISLAND_RANK"] = str(r)
            child_env["BLUEFOG_ISLAND_SIZE"] = str(nranks)
            child_env["BLUEFOG_ISLAND_JOB"] = job
            if multi_host:
                child_env["BLUEFOG_ISLAND_HOSTMAP"] = ",".join(by_rank)
                child_env["BLUEFOG_ISLAND_COORD"] = coord
                # EVERY rank must advertise an address its remote peers
                # can dial: remote ranks their host name, locally-forked
                # ranks this machine's reachable name — never the
                # loopback the transport would otherwise default to
                child_env["BLUEFOG_ISLAND_HOST"] = (
                    socket.getfqdn() if _is_local_host(by_rank[r])
                    else by_rank[r])
            ranks.append(_spawn_rank(by_rank[r], cmd, child_env, tag, r))
        # serving fleet: local replica processes subscribed to the
        # job's snapshot region.  They poll until the first publish
        # lands, hot-swap each version, and are torn down with the
        # fleet — a replica exiting never fails the training run.
        serve_procs = []
        for i in range(serve_replicas):
            rc = dict(env)
            rc["BFTPU_SERVE_REPLICAS"] = str(serve_replicas)
            serve_cmd = [sys.executable, "-m", "bluefog_tpu_torch.serve",
                         "--job", job, "--replica-id", str(i)]
            if serve_report:
                serve_cmd += ["--report", os.path.join(
                    serve_report, f"replica-{i}.json")]
            if serve_remote:
                # cross-host attach: feed through the distribution
                # tree rooted at the publisher's feed address instead
                # of the local shm region
                rc["BFTPU_SERVE_REMOTE"] = serve_remote
                serve_cmd += ["--remote", serve_remote]
            serve_procs.append(subprocess.Popen(serve_cmd, env=rc))
        # fleet monitor: one passive scrape daemon per job.  It only
        # reads seqlock'd pages and journals, exits on its own once the
        # fleet's pages are reclaimed, and is SIGTERMed with the serve
        # procs — a monitor dying never fails the training run.
        if env.get("BFTPU_MONITOR", "0") not in ("", "0"):
            mc = dict(env)
            mc["BLUEFOG_ISLAND_JOB"] = job
            serve_procs.append(subprocess.Popen(
                [sys.executable, "-m", "bluefog_tpu_torch.monitor",
                 "--job", job, "--daemon"], env=mc))
        control = None
        try:
            if multi_host:
                code = _supervise(ranks, timeout)
            else:
                state = {"lock": threading.Lock(), "scale_requests": 0,
                         "live": len(ranks), "joiners": 0}
                try:
                    control = _Control(job, state)
                except OSError as e:
                    print(f"bftpu-run: control socket unavailable ({e}); "
                          "run is not resizable", file=sys.stderr)
                code = _supervise_islands(ranks, timeout, spawn_joiner,
                                          self_heal, state)
        finally:
            if control is not None:
                control.stop()
            for p in serve_procs:
                if p.poll() is None:
                    p.terminate()
            for p in serve_procs:
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    p.kill()
            _cleanup_island_segments(job, by_rank)
            _collect_telemetry(env, job)
            _collect_traces(env, job)
        if (code not in (0, 124, 130) and multi_host and attempt == 0
                and time.monotonic() - t0 < 20.0):
            # same fast-failure signature as _run_multiprocess: the TCP
            # rendezvous port may not have been free on the head host
            print("bftpu-run: islands launch failed fast; retrying with a "
                  "fresh rendezvous port", file=sys.stderr)
            continue
        return code
    return code


if __name__ == "__main__":
    sys.exit(main())
