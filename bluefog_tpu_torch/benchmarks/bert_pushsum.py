"""BERT push-sum fine-tune round on the rank-major backend (BASELINE config #3).

Counterpart of the repo-root ``benchmarks/bert_pushsum.py``: ``size``
virtual ranks each fine-tune a BERT encoder (the ``base`` preset is
BERT-base: 12 layers x 768 hidden x 12 heads, ~110M parameters, sequence
128, batch 32 a rank) with Adam, then mix parameters by push-sum over the
directed ring: ``win_accumulate`` half to the successor, ``win_update``
(self 0.5, neighbor 1.0, reset), debias by p, and restart with p = 1.
The whole parameter set rides one packed f32 window.

Two flows of the same round, from the same state (:func:`build_flows`):

- ``eager``: the public window API, call by call;
- ``device``: the same round written out with ``windows._exchange_body``
  and the same weights (``windows._class_scales``) on mailbox tensors the
  flow carries itself, as a plain loop of k rounds.  (The JAX version runs
  it as one ``lax.fori_loop`` dispatch; capturing the round in a CUDA
  graph is not done here.)

Prints one JSON line: tokens/s on the device (all ranks' tokens), ms a
round of each flow, peak memory and the parameter count; ``--profile``
adds one more eager round split by the host clock into forward and
backward, Adam and the window round (each synchronized), and one traced
round (device time by kernel and the device's idle share).

Run (one H100):  python -m bluefog_tpu_torch.benchmarks.bert_pushsum
Run (CPU):       python -m bluefog_tpu_torch.benchmarks.bert_pushsum --preset tiny --device cpu
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import bluefog_tpu_torch as bf
from bluefog_tpu_torch import topology_util, windows
from bluefog_tpu_torch.core import basics
from bluefog_tpu_torch.models.transformer import BertEncoder
from bluefog_tpu_torch.profiling import device_profile
from bluefog_tpu_torch.training import replicate_for_mesh

PRESETS = {
    # the reference's config #3 scale: BERT-base
    "base": dict(vocab=30522, hidden=768, layers=12, heads=12, dff=3072,
                 seq=128, batch=32),
    "tiny": dict(vocab=128, hidden=64, layers=2, heads=4, dff=128,
                 seq=16, batch=4),
}
LR = 2e-5
WINDOW = "bert_packed"


def make_model(cfg, seed: int = 0,
               state_dict: Optional[Dict[str, torch.Tensor]] = None) -> BertEncoder:
    """The preset's ``BertEncoder`` (bf16 products, 2 classes) on the CPU:
    drawn from ``seed``, or loaded from ``state_dict``."""
    model = BertEncoder(vocab_size=cfg["vocab"], hidden_size=cfg["hidden"],
                        num_layers=cfg["layers"], num_heads=cfg["heads"], dff=cfg["dff"],
                        max_len=cfg["seq"], num_classes=2, dtype=torch.bfloat16,
                        device="cpu", generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def build_flows(cfg, n: int, seed: int = 0,
                state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """Model, data and both flows of the push-sum round on the initialized
    context (``n`` ranks, on its device).

    Returns ``(state, eager_step, device_rounds, meta)``:

    - ``state = (params, optimizer)``: rank-major leaves (requires grad)
      and a ``torch.optim.Adam`` over them; the eager flow's window lives
      in the context;
    - ``eager_step(params, optimizer) -> (params, optimizer, losses [n])``,
      one round through the public window API (the parameters change in
      place);
    - ``device_rounds(dstate, k) -> (dstate, losses [n])``: k rounds on
      ``dstate = meta["device_init"](params, optimizer)``, a copy of the
      state with its own optimizer and mailbox;
    - ``meta``: ``n_params``, ``B``, ``T``, ``device_init``, ``p_mass``
      (the device scalars sum(p) after each round's update, before the
      restart; both flows append) and ``parts``, the eager round's two
      halves ``(losses_and_grads(params), eager_mix(params))`` around the
      optimizer step.

    Token ids and labels are drawn from ``np.random.default_rng(seed)`` as
    the JAX version draws them."""
    bf.set_topology(topology_util.RingGraph(n, connect_style=1))
    bf.turn_on_win_ops_with_associated_p()
    ctx = basics.context()
    plan, dev = ctx.plan, ctx.device
    model = make_model(cfg, seed, state_dict).to(dev)
    B, T = cfg["batch"], cfg["seq"]
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(0, cfg["vocab"], size=(n, B, T))).to(dev)
    labels = torch.from_numpy(rng.integers(0, 2, size=(n, B))).to(dev)
    params = replicate_for_mesh(dict(model.named_parameters()), n)
    names = list(params)
    sizes = [params[k][0].numel() for k in names]
    n_params = sum(sizes)

    def pack(ps):
        return torch.cat([ps[k].detach().reshape(n, -1) for k in names], dim=1)

    @torch.no_grad()
    def unpack_into(ps, packed):
        off = 0
        for k, sz in zip(names, sizes):
            ps[k].copy_(packed[:, off:off + sz].view_as(ps[k]))
            off += sz

    def losses_and_grads(ps):
        """Every rank's loss on its batch; gradients into ``ps[k].grad[r]``."""
        for p in ps.values():
            p.grad = None
        losses = []
        for r in range(n):
            logits = functional_call(model, {k: v[r] for k, v in ps.items()}, (ids[r],))
            loss = F.cross_entropy(logits, labels[r])
            loss.backward()
            losses.append(loss.detach())
        return torch.stack(losses)

    dst = [{(r + 1) % n: 0.5} for r in range(n)]
    ones_prev = [{(r - 1) % n: 1.0} for r in range(n)]
    p_mass = []
    windows.win_create(pack(params), WINDOW, zero_init=True)
    opt = torch.optim.Adam(params.values(), lr=LR)

    def eager_mix(ps):
        """The push-sum round through the public window API."""
        windows.win_accumulate(pack(ps), WINDOW, dst_weights=dst)
        m = windows.win_update(WINDOW, self_weight=0.5, neighbor_weights=ones_prev,
                               reset=True)
        p_assoc = windows.win_associated_p(WINDOW)
        p_mass.append(p_assoc.sum())
        merged = m / p_assoc.view(n, 1).to(m.dtype)
        windows.win_set_exposed(WINDOW, merged, associated_p=1.0)
        unpack_into(ps, merged)

    def eager_step(ps, optimizer):
        loss = losses_and_grads(ps)
        optimizer.step()
        eager_mix(ps)
        return ps, optimizer, loss

    # --- the device flow: the same round on its own mailbox tensors ------
    maxd = max(plan.max_in_degree, 1)
    send_scales, send_active = windows._class_scales(plan, dst, side="send")

    def device_init(ps, optimizer):
        ps2 = {k: v.detach().clone().requires_grad_(True) for k, v in ps.items()}
        opt2 = torch.optim.Adam(ps2.values(), lr=LR)
        opt2.load_state_dict(copy.deepcopy(optimizer.state_dict()))
        f32 = dict(dtype=torch.float32, device=dev)
        return dict(params=ps2, opt=opt2, mail=torch.zeros(n, maxd, n_params, **f32),
                    ver=torch.zeros(n, maxd, dtype=torch.int32, device=dev),
                    p_self=torch.ones(n, **f32), p_mail=torch.zeros(n, maxd, **f32))

    def device_rounds(ds, k: int):
        loss = None
        for _ in range(k):
            loss = losses_and_grads(ds["params"])
            ds["opt"].step()
            packed = pack(ds["params"])
            # the ring accumulate: the exchange the eager win_accumulate runs
            windows._exchange_body(plan, True, True, packed, ds["mail"], ds["ver"],
                                   ds["p_self"], ds["p_mail"], send_scales, send_active)
            # win_update(self 0.5, neighbor 1.0, reset), debias, restart p = 1
            merged = 0.5 * packed + ds["mail"].sum(dim=1)
            p_new = 0.5 * ds["p_self"] + ds["p_mail"].sum(dim=1)
            p_mass.append(p_new.sum())
            unpack_into(ds["params"], merged / p_new.view(n, 1))
            ds["mail"].zero_()
            ds["p_mail"].zero_()
            ds["p_self"].fill_(1.0)
        return ds, loss

    meta = dict(n_params=n_params, B=B, T=T, device_init=device_init, p_mass=p_mass,
                parts=(losses_and_grads, eager_mix))
    return (params, opt), eager_step, device_rounds, meta


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _profile(dev, params, opt, eager_step, meta):
    """One eager round split by the host clock (synchronized after each
    part), then one round traced with torch.profiler (device activity
    only: host-side tracing would stretch the gaps the idle share reads)."""
    grads, mix = meta["parts"]
    split = {}
    for name, fn in (("fwd_bwd", lambda: grads(params)), ("adam", opt.step),
                     ("window_round", lambda: mix(params))):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        split[name] = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CUDA if dev.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _sync(dev)
        t0 = time.perf_counter()
        eager_step(params, opt)
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    return split, device_profile(prof, wall, top=20)


def run(args) -> dict:
    cfg = PRESETS[args.preset]
    bf.init(size=args.size, device=args.device)
    try:
        dev = bf.device()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        (params, opt), eager_step, device_rounds, meta = build_flows(cfg, args.size, args.seed)
        n, tokens = args.size, args.size * meta["B"] * meta["T"]

        def timed(fn):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            return (time.perf_counter() - t0) * 1e3 / args.rounds, out

        for _ in range(args.warmup):
            params, opt, loss = eager_step(params, opt)
        eager_ms, (_, _, loss) = timed(lambda: [eager_step(params, opt)
                                               for _ in range(args.rounds)][-1])
        dstate = meta["device_init"](params, opt)
        dstate, _ = device_rounds(dstate, args.warmup)
        device_ms, (_, dloss) = timed(lambda: device_rounds(dstate, args.rounds))
        p_mass = torch.stack(meta["p_mass"]).tolist()
        out = {
            "metric": f"BERT-{args.preset} ({meta['n_params'] / 1e6:.1f}M) push-sum "
                      f"fine-tune tokens/s on the device ({n} ranks, directed ring, "
                      f"S={meta['T']})",
            "tokens_per_s": tokens / (eager_ms / 1e3),
            "round_ms": eager_ms,
            "device_flow_tokens_per_s": tokens / (device_ms / 1e3),
            "device_flow_round_ms": device_ms,
            "tokens_per_round": tokens, "ranks": n, "per_rank_batch": meta["B"],
            "seq": meta["T"], "n_params": meta["n_params"], "rounds": args.rounds,
            "losses": loss.tolist(), "device_flow_losses": dloss.tolist(),
            "p_mass_max_err": max(abs(m - n) for m in p_mass),
            "device": str(dev),
        }
        if dev.type == "cuda":
            out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            out["gpu"] = torch.cuda.get_device_name(dev)
        if args.profile:
            out["split_ms"], out["profile"] = _profile(dev, params, opt, eager_step, meta)
        return out
    finally:
        bf.shutdown()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="base", choices=sorted(PRESETS))
    ap.add_argument("--size", type=int, default=4, help="virtual ranks")
    ap.add_argument("--rounds", type=int, default=5, help="timed rounds a flow")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--profile", action="store_true",
                    help="add a split round and a traced round (see the module doc)")
    return ap


def main(argv=None) -> None:
    print(json.dumps(run(_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
