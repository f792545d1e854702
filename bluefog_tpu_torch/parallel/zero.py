"""ZeRO-1 and FSDP train steps composing with machine gossip (counterpart
of ``bluefog_tpu/parallel/zero.py``).

The reference keeps one replica of the model a *machine* and partitions
its f32 master and optimizer state over the machine's ``local`` chips (the
``bf_local`` mesh axis); the updated replicas then mix with their
machine-topology neighbors (``bf_machines``).  Two builders:

- :func:`make_zero_gossip_train_step` packs every leaf into one padded f32
  vector a replica, stored as a ``[machines, local, padded/local]`` grid
  (the ZeRO-1 partition), each local rank computing the gradient of its
  own batch;
- :func:`make_fsdp_gossip_train_step` keeps one f32 master a machine per
  leaf, ``[machines, *shape]``, and takes each machine's batch ``[local·B,
  ...]`` as one batch (GSPMD's FSDP recipe in the reference).

On the rank-major backend one device holds every rank, so the state keeps
the reference's shapes, and the two packages' states carry across
(:mod:`bluefog_tpu_torch.interop.jax_weights`), but nothing is
partitioned: the memory the partition saves a chip is not saved here.
What the reference spells as collectives is arithmetic on the leading
axes:

- ``all_gather`` over ``bf_local``: a machine's ``[local, shard]`` rows
  read as its padded vector;
- ``psum_scatter / local``: the mean of the machine's local gradients, the
  elementwise rule then updating each ``[shard]`` row of the grid alone
  (one call over the machine's rows, since the rule is elementwise);
- ``neighbor_allreduce`` over ``bf_machines``:
  :func:`bluefog_tpu_torch.ops.neighbor_allreduce_plan` on the machine
  axis (dim 0), shard by shard or leaf by leaf.

Both step functions update the state's tensors in place and return it
(the reference donates them).  The ``(machines, local)`` pair is the
shape of the reference's ``hier_mesh``; ``machine_plan`` is the context's
(``basics.context().machine_plan``) or None for no gossip.

The FSDP hooks for :class:`bluefog_tpu_torch.models.transformer.LlamaLM`:
:func:`fsdp_param_io_constraint` keeps its gradient-dtype contract;
:func:`fsdp_act_constraint` and :func:`fsdp_onehot_constraint` are
identities.  No counterpart: ``fsdp_state_struct``, ``fsdp_count_struct``
and ``step_fn.lower``, which build ShapeDtypeStructs with GSPMD shardings
and lower the step ahead of time without a buffer; eager PyTorch compiles
no program to lower.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from bluefog_tpu_torch.core.plan import CommPlan
from bluefog_tpu_torch.ops import neighbor_allreduce_plan, tree_flatten, tree_map, tree_unflatten
from bluefog_tpu_torch.training import apply_accepts_labels

__all__ = [
    "make_zero_gossip_train_step",
    "make_fsdp_gossip_train_step",
    "fsdp_act_constraint",
    "fsdp_onehot_constraint",
    "fsdp_param_io_constraint",
    "packed_layout",
    "unpack_params",
]


def fsdp_act_constraint():
    """Activation hook (``LlamaLM.act_constraint``): the identity.  The
    reference pins every block-boundary activation batch-sharded over
    ``bf_local`` so GSPMD gathers the weights and not the activations; one
    device holds every rank here, so there is no layout to pin."""
    return lambda x: x


def fsdp_onehot_constraint():
    """One-hot operand hook (``LlamaLM.onehot_constraint``): the identity.
    The reference pins the one-hot ``[B, T, vocab]`` vocab-sharded so the
    embedding product partitions on its contracting dim; one device holds
    every rank here."""
    return lambda oh: oh


class _GradCast(torch.autograd.Function):
    """Identity forward; the cotangent rounded to ``grad_dtype`` backward
    (autograd then casts it to the weight's own dtype)."""

    @staticmethod
    def forward(ctx, w, grad_dtype):
        ctx.grad_dtype = grad_dtype
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.grad_dtype), None


def fsdp_param_io_constraint(grad_dtype=None):
    """Per-read weight hook (``LlamaLM.weight_constraint``): identity
    forward, the weight's cotangent rounded to ``grad_dtype`` backward (the
    bf16-gradient contract of the reference's custom VJP, whose sharding
    pins have no counterpart here).  ``.sharding_only`` is the identity
    both ways, for reads inside a loop whose cotangents must accumulate
    before the one rounding (the chunked LM head)."""
    def constrain(w):
        return w if grad_dtype is None else _GradCast.apply(w, grad_dtype)

    constrain.sharding_only = lambda w: w
    return constrain


class _Layout(NamedTuple):
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    spec: Any
    total: int      # unpadded element count
    padded: int     # total padded to a multiple of local_size


def packed_layout(params, local_size: int) -> _Layout:
    """The packed vector's layout: leaves in tree order (dict keys sorted,
    as ``jax.tree_util`` flattens them), padded to a multiple of
    ``local_size``."""
    flat, spec = tree_flatten(params)
    shapes = tuple(tuple(l.shape) for l in flat)
    sizes = tuple(l.numel() for l in flat)
    total = int(sum(sizes))
    padded = -(-total // local_size) * local_size
    return _Layout(shapes, sizes, spec, total, padded)


def _pack(flat, layout: _Layout, dtype=torch.float32):
    vec = torch.cat([l.reshape(-1).to(dtype) for l in flat])
    return torch.nn.functional.pad(vec, (0, layout.padded - layout.total))


def unpack_params(vec, layout: _Layout, dtype):
    """Padded flat vector -> the params tree in ``dtype``."""
    leaves, off = [], 0
    for shape, size in zip(layout.shapes, layout.sizes):
        leaves.append(vec[off:off + size].reshape(shape).to(dtype))
        off += size
    return tree_unflatten(layout.spec, leaves)


def _make_update_rule(optimizer: str, lr: float, momentum: float, weight_decay: float):
    """Elementwise update rule on f32 gradients, the same on a packed shard
    as on a leaf.  Returns ``(init, update)``: ``init(zeros_f32,
    zeros_i32)`` builds the state tuple from two zero factories;
    ``update(g, state, w) -> (delta, state)``.

    "sgdm": state (mu,); ``weight_decay`` is L2 folded into the gradient.
    "adamw": state (mu, nu, count); ``momentum`` is b1, ``weight_decay`` is
    decoupled (applied to w, not g), and with it 0 this is ``optax.adam``.
    Both accumulate in f32 and store at the state's dtype (a bf16 momentum
    stays bf16); adamw's nu is f32 whatever the momentum dtype, since its
    0.1% a step decay is below a bf16 step."""
    wd = float(weight_decay)
    if optimizer == "sgdm":
        mom = float(momentum)

        def init(zeros_f32, zeros_i32):
            del zeros_i32
            return (zeros_f32(),)

        def update(g, state, w):
            (mu,) = state
            if wd:
                g = g + wd * w
            mu_f = mom * mu.float() + g
            return -lr * mu_f, (mu_f.to(mu.dtype),)

        return init, update
    if optimizer == "adamw":
        b1, b2, eps = float(momentum), 0.999, 1e-8

        def init(zeros_f32, zeros_i32):
            return (zeros_f32(), zeros_f32(torch.float32), zeros_i32())

        def update(g, state, w):
            mu, nu, count = state
            count = count + 1
            mu_f = b1 * mu.float() + (1 - b1) * g
            nu_f = b2 * nu.float() + (1 - b2) * g * g
            c = count.float()
            mu_hat = mu_f / (1 - b1 ** c)
            nu_hat = nu_f / (1 - b2 ** c)
            delta = -lr * (mu_hat / (torch.sqrt(nu_hat) + eps) + wd * w)
            return delta, (mu_f.to(mu.dtype), nu_f.to(nu.dtype), count)

        return init, update
    raise ValueError(f"optimizer must be 'sgdm' or 'adamw', got {optimizer!r}")


def _make_loss(apply_fn: Callable, loss_fn: Callable) -> Callable:
    if apply_accepts_labels(apply_fn):
        return lambda p, x, y: loss_fn(apply_fn(p, x, labels=y), y)
    return lambda p, x, y: loss_fn(apply_fn(p, x), y)


def _apply_update(opt_update, g, slots, w):
    """One update of ``w`` and its optimizer ``slots`` in place."""
    delta, new = opt_update(g, slots, w)
    w.add_(delta)
    for s, v in zip(slots, new):
        s.copy_(v)


def make_zero_gossip_train_step(
    apply_fn: Callable,
    loss_fn: Callable,
    grid: Tuple[int, int],
    machine_plan: Optional[CommPlan],
    *,
    learning_rate: float = 1e-3,
    momentum: float = 0.9,
    optimizer: str = "sgdm",
    weight_decay: float = 0.0,
    compute_dtype=torch.bfloat16,
):
    """Build ``(init_fn, step_fn, params_of)`` for ZeRO-1 + gossip training
    on ``grid = (machines, local)``.

    ``init_fn(params)`` -> state with the f32 master and every optimizer
    slot (``"sgdm"``: momentum; ``"adamw"``: mu/nu/count) as ``[machines,
    local, padded/local]`` tensors (counts ``[machines, local, 1]`` int32),
    every machine from the same point.

    ``step_fn(state, batch, labels) -> (state, mean_loss)``: batch and
    labels lead with ``[machines, local, ...]``.  Each (machine, local)
    batch runs its own forward and backward on the machine's parameters in
    ``compute_dtype``; the f32 gradients are averaged over the machine's
    local batches, each shard updated by the rule, and the shards mixed
    over ``machine_plan``.

    ``params_of(state)`` -> machine 0's parameters in ``compute_dtype``.
    """
    machines, local = grid
    lr = float(learning_rate)
    loss_of = _make_loss(apply_fn, loss_fn)
    opt_init, opt_update = _make_update_rule(optimizer, lr, momentum, weight_decay)
    do_mix = machine_plan is not None and machines > 1
    layout_box = {}

    def init_fn(params):
        if "l" not in layout_box:
            layout_box["l"] = packed_layout(params, local)
        layout = layout_box["l"]
        vec = _pack(tree_flatten(params)[0], layout)
        shard_len = layout.padded // local
        master = vec.reshape(local, shard_len).expand(machines, local, shard_len).clone()
        opt = opt_init(
            lambda dtype=None: torch.zeros_like(master, dtype=dtype),
            lambda: torch.zeros((machines, local, 1), dtype=torch.int32,
                                device=master.device))
        return {"master": master, "opt": opt}

    def _layout():
        if "l" not in layout_box:
            raise RuntimeError(
                "call init_fn(params) first: the packed layout (shapes/offsets) "
                "comes from the params tree — when restoring state from a "
                "checkpoint, still call init_fn with a matching params tree to "
                "rebuild it")
        return layout_box["l"]

    def step_fn(state, batch, labels):
        layout = _layout()
        master, opt = state["master"], state["opt"]
        losses = []
        for m in range(machines):
            g = torch.zeros_like(master[m])  # [local, shard] f32
            for r in range(local):
                vec = master[m].reshape(-1).detach().requires_grad_()
                loss = loss_of(unpack_params(vec, layout, compute_dtype), batch[m, r],
                               labels[m, r])
                (grad,) = torch.autograd.grad(loss, vec)
                g += grad.view_as(g)
                losses.append(loss.detach().float())
            g /= local
            _apply_update(opt_update, g, tuple(o[m] for o in opt), master[m])
        if do_mix:
            master.copy_(neighbor_allreduce_plan(master, machine_plan))
        return state, torch.stack(losses).mean()

    def params_of(state):
        return unpack_params(state["master"][0].reshape(-1), _layout(), compute_dtype)

    return init_fn, step_fn, params_of


def make_fsdp_gossip_train_step(
    apply_fn: Callable,
    loss_fn: Callable,
    grid: Tuple[int, int],
    machine_plan: Optional[CommPlan],
    *,
    learning_rate: float = 1e-3,
    momentum: float = 0.9,
    optimizer: str = "sgdm",
    weight_decay: float = 0.0,
    compute_dtype=torch.bfloat16,
    momentum_dtype=torch.float32,
):
    """FSDP-style ZeRO + gossip on ``grid = (machines, local)``: one f32
    master a machine per leaf, ``[machines, *shape]``.

    ``init_fn(params)`` -> ``{"master": tree, "opt": slots}``; the first
    slot (momentum, or adamw's mu) in ``momentum_dtype``, adamw's nu in
    f32, adamw's per-leaf count ``[machines, 1, ...]`` int32.

    ``step_fn(state, batch, labels) -> (state, mean_loss)``: batch and
    labels ``[machines, per_machine_batch, ...]``.  The gradient is that of
    the sum of the machine losses, each machine's batch one batch: every
    leaf of the machine is cast to ``compute_dtype`` (norms and head too),
    the machine's loss is differentiated, and its leaves are updated by the
    rule before the next machine runs (its loss reads its own leaves only,
    so this is the gradient of the sum).  Then the masters mix over
    ``machine_plan``, leaf by leaf.

    ``params_of(state)`` -> machine 0's parameters in ``compute_dtype``.
    """
    machines, _ = grid
    lr = float(learning_rate)
    loss_of = _make_loss(apply_fn, loss_fn)
    opt_init, opt_update = _make_update_rule(optimizer, lr, momentum, weight_decay)
    do_mix = machine_plan is not None and machines > 1

    def init_fn(params):
        master = tree_map(lambda a: a.detach().float().unsqueeze(0).repeat(
            (machines,) + (1,) * a.dim()), params)
        opt = opt_init(
            lambda dtype=None: tree_map(
                lambda a: torch.zeros_like(a, dtype=dtype or momentum_dtype), master),
            lambda: tree_map(lambda a: torch.zeros(
                (machines,) + (1,) * (a.dim() - 1), dtype=torch.int32, device=a.device),
                master))
        return {"master": master, "opt": opt}

    def step_fn(state, batch, labels):
        m_leaves, spec = tree_flatten(state["master"])
        o_leaves = [tree_flatten(o)[0] for o in state["opt"]]
        losses = []
        for m in range(machines):
            leaves = [w[m].detach().to(compute_dtype).requires_grad_() for w in m_leaves]
            loss = loss_of(tree_unflatten(spec, leaves), batch[m], labels[m])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            losses.append(loss.detach().float())
            del leaves
            for i, (w, g) in enumerate(zip(m_leaves, grads)):
                g = torch.zeros_like(w[m]) if g is None else g.float()
                _apply_update(opt_update, g, tuple(ol[i][m] for ol in o_leaves), w[m])
            del grads
        if do_mix:
            for w in m_leaves:
                w.copy_(neighbor_allreduce_plan(w, machine_plan))
        return state, torch.stack(losses).mean()

    def params_of(state):
        return tree_map(lambda a: a[0].to(compute_dtype), state["master"])

    return init_fn, step_fn, params_of
