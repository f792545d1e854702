"""Interactive multi-rank island sessions — the ``ibfrun`` twin for the
multi-process island runtime (counterpart of
``bluefog_tpu/run/interactive_islands.py``).

N persistent OS processes, each owning its island runtime (windows,
mailboxes, mutexes stay ALIVE between cells), driven from the notebook one
task at a time:

    from bluefog_tpu_torch.run.interactive_islands import IslandSession

    sess = IslandSession(4)                    # cell 1: spawn the workers
    sess.run(lambda rank, size: islands_setup(...))
    sess.run(step_fn, lr=0.1)                  # cell 2..n: live gossip
    sess.shutdown()                            # last cell

Each ``run`` broadcasts one callable ``fn(rank, size, *args, **kwargs)`` to
every worker and returns the per-rank results in rank order; an exception
on any rank is re-raised in the driving process with the worker's
traceback attached.

Functions are shipped with the standard library's :mod:`pickle` (no
cloudpickle):

- an importable function (a module's top-level ``def``) goes by
  reference, as pickle always sends it;
- any other function — a lambda, a closure, a ``def`` nested in another
  function or typed into a notebook cell (``__main__``) — goes as its
  source text (:func:`inspect.getsource`, which IPython's ``linecache``
  entries serve for notebook cells) together with its closure cells'
  values, its defaults and the global names its code uses, all pickled by
  value (helper functions among them by the same rule; modules by their
  name, imported again in the worker).  The worker
  compiles the source again inside a factory whose parameters are the
  free variables, so the new function closes over the shipped values.

Limits of the source route: the function is rebuilt without its
decorators; a lambda must be the only lambda with its argument names on
its source line; a class defined in ``__main__`` cannot be sent (pickle
sends classes by reference); a closure sees a copy of its cells, so
rebinding a captured variable in the notebook does not reach the
workers.  A function that cannot be shipped raises :class:`TypeError` in
the driving process before anything is sent.
"""

from __future__ import annotations

import ast
import builtins
import importlib
import inspect
import io
import itertools
import linecache
import os
import pickle
import sys
import textwrap
import types
from typing import Any, Dict, List, Optional

__all__ = ["IslandSession", "dumps_cell", "loads_cell"]

_session_counter = itertools.count()
_cell_counter = itertools.count()


# ---------------------------------------------------------------------------
# shipping functions with the standard library
# ---------------------------------------------------------------------------


def _by_reference(fn: types.FunctionType) -> bool:
    """True when pickle can send ``fn`` by reference: its module is
    importable by name and ``module.qualname`` is ``fn`` itself."""
    mod = getattr(fn, "__module__", None)
    if mod in (None, "__main__", "__mp_main__") or "<" in fn.__qualname__:
        return False
    obj = sys.modules.get(mod)
    for part in fn.__qualname__.split("."):
        obj = getattr(obj, part, None)
    return obj is fn


def _code_names(code: types.CodeType) -> set:
    """Global (and attribute) names used by ``code`` and its nested code."""
    names = set(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            names |= _code_names(const)
    return names


def _argnames(code: types.CodeType) -> List[str]:
    return list(code.co_varnames[:code.co_argcount + code.co_kwonlyargcount])


def _function_node(tree: ast.AST, name: str, argnames: List[str]):
    """The def (by name) or lambda (by argument names) in parsed source."""
    if name != "<lambda>":
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return node
        raise TypeError(f"no def of {name!r} in its source")
    found = [n for n in ast.walk(tree) if isinstance(n, ast.Lambda)
             and [a.arg for a in n.args.args + n.args.kwonlyargs] == argnames]
    if len(found) != 1:
        raise TypeError(f"{len(found)} lambdas with arguments {argnames} on "
                        "its source line; give the cell a name with def")
    return found[0]


def _source_of(fn: types.FunctionType) -> str:
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError) as exc:
        raise TypeError(f"its source is not available ({exc})") from None
    src = textwrap.dedent(src)
    try:
        ast.parse(src)
    except SyntaxError:
        # a lambda in the middle of an expression: getsource returns its
        # whole line(s); parse them as one parenthesized expression
        src = "(\n" + src.strip().rstrip(",;\\") + "\n)"
    return src


def _function_spec(fn: types.FunctionType) -> Dict[str, Any]:
    """What the worker needs to compile ``fn`` again (see the module
    docstring); every value in it is pickled by value."""
    if fn.__code__.co_freevars and "__class__" in fn.__code__.co_freevars:
        raise TypeError("a method that uses super() (a __class__ cell)")
    src = _source_of(fn)
    argnames = _argnames(fn.__code__)
    _function_node(ast.parse(src), fn.__name__, argnames)  # fail here
    cells = [c.cell_contents for c in (fn.__closure__ or ())]
    glb = fn.__globals__
    names = sorted(n for n in _code_names(fn.__code__) if n in glb
                   and n not in fn.__code__.co_freevars)
    return {
        "name": fn.__name__, "qualname": fn.__qualname__, "source": src,
        "argnames": argnames,
        "freevars": list(fn.__code__.co_freevars), "cells": cells,
        "globals": {n: glb[n] for n in names},
        "defaults": fn.__defaults__, "kwdefaults": fn.__kwdefaults__,
        "module": fn.__module__, "doc": fn.__doc__,
    }


def _rebuild_function(spec: Dict[str, Any]) -> types.FunctionType:
    """Compile a shipped function again in this process."""
    filename = f"<island cell {next(_cell_counter)}: {spec['qualname']}>"
    src = spec["source"]
    linecache.cache[filename] = (len(src), None, src.splitlines(True), filename)
    tree = ast.parse(src, filename)
    node = _function_node(tree, spec["name"], spec["argnames"])
    if spec["name"] == "<lambda>":
        body = [ast.Return(value=node)]
    else:
        node.decorator_list = []
        body = [node, ast.Return(value=ast.Name(id=spec["name"], ctx=ast.Load()))]
    # defaults are set from the shipped values, not evaluated again
    node.args.defaults = []
    node.args.kw_defaults = [None] * len(node.args.kwonlyargs)
    factory = ast.FunctionDef(
        name="__island_cell_factory__",
        args=ast.arguments(posonlyargs=[], args=[ast.arg(arg=v) for v in spec["freevars"]],
                           vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
                           defaults=[]),
        body=body, decorator_list=[], returns=None, type_params=[])
    module = ast.fix_missing_locations(ast.Module(body=[factory], type_ignores=[]))
    namespace = {"__builtins__": builtins, "__name__": spec["module"]}
    namespace.update(spec["globals"])
    exec(compile(module, filename, "exec"), namespace)
    fn = namespace.pop("__island_cell_factory__")(*spec["cells"])
    fn.__defaults__ = spec["defaults"]
    fn.__kwdefaults__ = spec["kwdefaults"]
    fn.__qualname__ = spec["qualname"]
    fn.__doc__ = spec["doc"]
    return fn


class _CellPickler(pickle.Pickler):
    """pickle, with functions that cannot go by reference sent as source."""

    def reducer_override(self, obj):
        if isinstance(obj, types.ModuleType):  # imported again by name
            return importlib.import_module, (obj.__name__,)
        if isinstance(obj, types.FunctionType) and not _by_reference(obj):
            try:
                spec = _function_spec(obj)
            except TypeError as exc:
                raise TypeError(
                    f"cannot ship {obj.__qualname__!r} to the island "
                    f"workers: {exc}") from None
            return _rebuild_function, (spec,)
        return NotImplemented


def dumps_cell(fn, args=(), kwargs=None) -> bytes:
    """The bytes that ship ``(fn, args, kwargs)`` to a worker; raises
    :class:`TypeError` when something in it cannot be shipped."""
    buf = io.BytesIO()
    try:
        _CellPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(
            (fn, tuple(args), dict(kwargs or {})))
    except (pickle.PicklingError, AttributeError, ValueError,
            RecursionError) as exc:
        raise TypeError(f"cannot ship the cell to the island workers: "
                        f"{exc}") from exc
    return buf.getvalue()


def loads_cell(blob: bytes):
    """``(fn, args, kwargs)`` from :func:`dumps_cell`'s bytes."""
    return pickle.loads(blob)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------


def _worker_loop(rank: int, size: int, job: str, conn) -> None:
    """One persistent island worker: init once, serve tasks until the
    shutdown sentinel, then tear down collectively."""
    try:
        from bluefog_tpu_torch import islands

        islands.init(rank, size, job)
        conn.send(("ready", rank))
    except Exception as e:  # noqa: BLE001
        import traceback

        conn.send(("error", f"{e}\n{traceback.format_exc()}"))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            # the driving process died or the session was GC'd without shutdown():
            # treat like the sentinel so teardown/unlink still runs
            msg = None
        if msg is None:  # shutdown sentinel
            break
        try:
            fn, args, kwargs = loads_cell(msg)
            out = fn(rank, size, *args, **kwargs)
            conn.send(("ok", out))
        except Exception as e:  # noqa: BLE001
            import traceback

            conn.send(("error", f"{e}\n{traceback.format_exc()}"))
    try:
        islands.barrier()
        islands.shutdown(unlink=(rank == 0))
    except Exception:  # noqa: BLE001 — peers may already be gone
        pass
    conn.send(("bye", rank))


class IslandSession:
    """N persistent island processes driven from this (notebook) process.

    State persists across ``run`` calls: a window created in one cell is
    live in the next — the property ``ibfrun`` exists for.
    """

    def __init__(self, nranks: int, job: Optional[str] = None,
                 timeout: float = 300.0):
        import multiprocessing as mp

        self.nranks = nranks
        self.timeout = timeout
        self.job = job or (
            f"ibf{os.getpid()}_{next(_session_counter)}"
        )
        ctx = mp.get_context("spawn")  # fresh interpreters (own CUDA context)
        self._conns = []
        self._procs = []
        for r in range(nranks):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_worker_loop, args=(r, nranks, self.job, child),
                daemon=True,
            )
            p.start()
            self._conns.append(parent)
            self._procs.append(p)
        for r, conn in enumerate(self._conns):
            self._expect(conn, r, ("ready",))
        self._alive = True

    def _expect(self, conn, rank, kinds):
        if not conn.poll(self.timeout):
            self.terminate()
            raise TimeoutError(
                f"island worker {rank} did not answer within "
                f"{self.timeout:g}s"
            )
        try:
            kind, payload = conn.recv()
        except EOFError:
            self.terminate()
            raise RuntimeError(
                f"island worker {rank} exited before it answered") from None
        if kind == "error":
            self.terminate()
            raise RuntimeError(f"island worker {rank} failed:\n{payload}")
        if kind not in kinds:
            self.terminate()
            raise RuntimeError(
                f"island worker {rank}: unexpected reply {kind!r}")
        return payload

    def _collect(self, kinds) -> List[Any]:
        """One reply per rank, polled ACROSS ranks: a failure on any rank
        surfaces immediately with its real traceback, even while other
        ranks block in a collective waiting for the failed one."""
        import time as _time

        results: dict = {}
        deadline = _time.monotonic() + self.timeout
        while len(results) < self.nranks:
            progressed = False
            for r, conn in enumerate(self._conns):
                if r in results or not conn.poll(0.02):
                    continue
                progressed = True
                kind, payload = conn.recv()
                if kind == "error":
                    self.terminate()
                    raise RuntimeError(
                        f"island worker {r} failed:\n{payload}")
                if kind not in kinds:
                    self.terminate()
                    raise RuntimeError(
                        f"island worker {r}: unexpected reply {kind!r}")
                results[r] = payload
            if not progressed and _time.monotonic() > deadline:
                missing = sorted(set(range(self.nranks)) - set(results))
                self.terminate()
                raise TimeoutError(
                    f"island worker(s) {missing} did not answer within "
                    f"{self.timeout:g}s"
                )
        return [results[r] for r in range(self.nranks)]

    def _send_all(self, payloads) -> None:
        """Broadcast with dead-worker detection: a broken pipe (worker
        OOM-killed/segfaulted between cells) tears the session down
        instead of leaving it half-alive with segments unreclaimed."""
        try:
            for conn, blob in zip(self._conns, payloads):
                conn.send(blob)
        except (BrokenPipeError, OSError) as e:
            self.terminate()
            raise RuntimeError(
                "an island worker died between cells (broken pipe); "
                "session terminated and segments reclaimed"
            ) from e

    def run(self, fn, *args, **kwargs) -> List[Any]:
        """Run ``fn(rank, size, *args, **kwargs)`` on EVERY rank; returns
        per-rank results in rank order.  Collective ops inside ``fn`` are
        fine — all ranks execute the same cell.  Raises
        :class:`TypeError`, with the session left alive, when the cell
        cannot be shipped."""
        if not self._alive:
            raise RuntimeError("session is shut down")
        blob = dumps_cell(fn, args, kwargs)
        self._send_all([blob] * self.nranks)
        return self._collect(("ok",))

    def shutdown(self) -> None:
        """Collective teardown: windows freed, segments unlinked."""
        if not self._alive:
            return
        self._send_all([None] * self.nranks)
        self._collect(("bye",))
        for p in self._procs:
            p.join(self.timeout)
        self._alive = False

    def terminate(self) -> None:
        """Hard kill (error paths); reclaims the job's shm segments.

        Workers are joined (then killed) BEFORE the unlink: SIGTERM is
        asynchronous, and a worker mid win_create could re-create a
        segment after the unlink, leaking it."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join(10.0)
        from bluefog_tpu_torch.native import shm_native

        shm_native.unlink_all(self.job)
        self._alive = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._alive:
            try:
                self.shutdown()
            except Exception:  # noqa: BLE001
                self.terminate()
