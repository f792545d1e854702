"""One gossip round on a bf16 island window.

Each of ``--islands`` processes creates a ``torch.bfloat16`` window (rank
0's tensor on ``--device``, the card by default; the others on the CPU),
deposits it at its out-neighbors over ExponentialTwoGraph, and combines
with ``win_update``'s default uniform weights.  Every rank's result is
held, bit for bit, against the combine computed here in plain torch in
the order the JAX package's bf16 windows take:
``bf16(f64(self) * w + sum f64(f32(neighbor) * w))``.

Run: ``python -m bluefog_tpu_torch.examples.bf16_window [--device cpu]``
(one JSON line).
"""

from __future__ import annotations

import argparse
import json

import torch

from bluefog_tpu_torch import islands, topology_util

WINDOW = "bf16"


def inputs(rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s bf16 vector (seeded by the rank), on the CPU."""
    g = torch.Generator().manual_seed(1000 + rank)
    return (torch.randn(n, generator=g) * (1 + rank)).to(torch.bfloat16)


def plain_round(size: int, n: int):
    """Every rank's expected bf16 result of one deposit + default combine."""
    topo = topology_util.ExponentialTwoGraph(size)
    xs = [inputs(r, n) for r in range(size)]
    out = []
    for r in range(size):
        nbrs = sorted(topo.predecessors(r))
        w = 1.0 / (len(nbrs) + 1)
        acc = xs[r].double() * w
        for s in nbrs:
            acc += (xs[s].float() * w).double()
        out.append(acc.to(torch.bfloat16))
    return out


def _worker(rank, size, device, n):
    islands.set_topology(topology_util.ExponentialTwoGraph(size))
    x = inputs(rank, n).to(device if rank == 0 else "cpu")
    islands.win_create(x, WINDOW)
    islands.barrier()
    islands.win_put(x, WINDOW)
    islands.barrier()
    out = islands.win_update(WINDOW)
    islands.barrier()
    # the bits as numpy: a torch tensor would travel through shared memory
    # that dies with this process
    bits = out.detach().cpu().view(torch.int16).numpy().copy()
    res = (rank, str(out.device.type), str(out.dtype), bits)
    islands.win_free(WINDOW)
    return res


def run(nranks: int = 2, n: int = 1 << 16, device: str = "cuda",
        timeout: float = 300.0) -> dict:
    """Spawn the round; returns a JSON-able summary (``ok`` iff every rank
    came back bf16, rank 0 on ``device``, and bit-equal to
    :func:`plain_round`)."""
    res = sorted(islands.spawn(_worker, nranks, timeout=timeout,
                               args=(device, n)))
    want = plain_round(nranks, n)
    got = {r: torch.from_numpy(bits).view(torch.bfloat16) for r, _, _, bits in res}
    mismatched = {r: int((got[r].view(torch.int16) != want[r].view(torch.int16)).sum())
                  for r in got}
    exact = sum(inputs(s, n).double() for s in range(nranks)) / nranks
    spread = max(float((g.double() - exact).abs().max()) for g in got.values())
    out = {"islands": nranks, "elems": n, "device": device,
           "rank0_device": res[0][1], "dtypes": sorted({d for _, _, d, _ in res}),
           "mismatched_elems": mismatched,
           "max_abs_from_average": spread}
    out["ok"] = (out["dtypes"] == ["torch.bfloat16"]
                 and out["rank0_device"] == torch.device(device).type
                 and not any(mismatched.values()))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--islands", type=int, default=2)
    ap.add_argument("--elems", type=int, default=1 << 16)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run(a.islands, a.elems, a.device)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
