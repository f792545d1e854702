"""Transformer models (counterpart of ``bluefog_tpu/models/transformer.py``):
the BERT-style encoder with a classification head (:class:`BertEncoder`,
the push-sum fine-tune workload) and the Llama-style decoder LM.

``BertEncoder`` keeps the reference's dtypes: f32 parameters, products in
``dtype`` (bf16 by default) on a residual stream in ``dtype``, LayerNorm
(epsilon 1e-6), softmax, pooler and classifier in f32, the tanh GELU, and
padding masked by -1e30 on the scaled f32 scores (a row with every key
masked gets a uniform softmax).  Its attention is the plain dense product,
as in the reference, which runs it outside any Pallas kernel.

``LlamaLM`` has the reference's options: GQA, remat with its policies,
``scan_layers``, ``spmd_vocab`` and the three FSDP hooks.  Parameters
are f32 and matmuls run in ``dtype`` (bf16 by default), with norms and
softmax in f32 and the LM head in ``head_dtype``: f32 by default, or bf16
operands with f32 accumulation in both directions (the JAX
``_head_matmul``).

Layout: projections are ``nn.Linear`` (weight ``[out, in]``), the transpose
of flax's ``(in, out)`` kernels, or under ``scan_layers`` one ``[L, out,
in]`` parameter a weight; :mod:`bluefog_tpu_torch.interop.jax_weights`
maps one to the other.  :meth:`LlamaLM.reset_parameters` draws from flax's
distributions (lecun-normal projections, N(0, 1/d) embedding, ones for the
norms) from an explicit ``torch.Generator``: the same distributions, not
the same bits.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from bluefog_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_

__all__ = ["BertEncoder", "LlamaLM", "RMSNorm", "attn_out", "dense_attention",
           "chunked_softmax_cross_entropy", "head_matmul", "one_hot"]


def dense_attention(q, k, v, *, causal: bool, dtype=torch.float32):
    """Plain softmax attention, ``[B, T, H, D]`` layout; f32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# --------------------------------------------------------------------------
# BERT-style encoder
# --------------------------------------------------------------------------


class _EncoderBlock(nn.Module):
    """Pre-norm encoder block.  ``qkv`` is flax's ``DenseGeneral((3, H,
    Dh))``: its weight rows run over (3, H, Dh) in that order."""

    def __init__(self, hidden: int, num_heads: int, dff: int, dtype, device):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.ln1 = LayerNorm(hidden, device=device)
        self.qkv = Dense(hidden, 3 * hidden, device=device, compute_dtype=dtype)
        self.o = Dense(hidden, hidden, device=device, compute_dtype=dtype)
        self.ln2 = LayerNorm(hidden, device=device)
        self.fc1 = Dense(hidden, dff, device=device, compute_dtype=dtype)
        self.fc2 = Dense(dff, hidden, device=device, compute_dtype=dtype)

    def forward(self, x, mask):
        b, t, d = x.shape
        h = self.ln1(x)
        q, k, v = self.qkv(h).view(b, t, 3, self.num_heads, d // self.num_heads).unbind(2)
        scale = 1.0 / math.sqrt(q.shape[-1])
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        if mask is not None:
            scores = torch.where(mask[:, None, None, :].bool(), scores,
                                 scores.new_tensor(-1e30))
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
        x = x + self.o(att)
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class BertEncoder(nn.Module):
    """BERT-style encoder with a classification head (the push-sum
    fine-tuning workload).  ``forward(input_ids [B, T], attention_mask
    [B, T] or None)`` returns f32 logits ``[B, num_classes]`` from the
    first position."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12, dff: int = 3072,
                 max_len: int = 512, num_classes: int = 2, dtype=torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads {num_heads}")
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, hidden_size, device=device, dtype=torch.float32)
        self.pos_embedding = nn.Parameter(torch.empty(max_len, hidden_size, device=device))
        self.layers = nn.ModuleList(
            _EncoderBlock(hidden_size, num_heads, dff, dtype, device) for _ in range(num_layers))
        self.norm = LayerNorm(hidden_size, device=device)
        self.pooler = Dense(hidden_size, hidden_size, device=device, compute_dtype=torch.float32)
        self.classifier = Dense(hidden_size, num_classes, device=device,
                                compute_dtype=torch.float32)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's distributions: N(0, 1/d) token embedding, N(0, 0.02^2)
        positions, lecun-normal kernels, zero biases, LayerNorm ones and
        zeros."""
        d = self.embed.weight.shape[1]
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        for mod in self.modules():
            if isinstance(mod, Dense):
                lecun_normal_(mod.weight, mod.in_features, generator)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.reset_parameters()

    def forward(self, input_ids, attention_mask=None):
        t = input_ids.shape[1]
        x = F.embedding(input_ids, self.embed.weight.to(self.dtype))
        x = x + self.pos_embedding[None, :t].to(self.dtype)
        for layer in self.layers:
            x = layer(x, attention_mask)
        x = self.norm(x)  # f32
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return self.classifier(pooled)


# --------------------------------------------------------------------------
# Llama-style decoder LM
# --------------------------------------------------------------------------


def _rotary(x, positions):
    """Rotary position embedding; x: [B, T, H, D], positions: [T], or
    [B, T] with each row's own.  The per-row form is a layout need of the
    rank-major sequence parallelism (:mod:`bluefog_tpu_torch.parallel`),
    which folds n shards into the batch, each row with its shard's global
    positions, where the reference passes each device its own [T] under
    ``shard_map``; it is not a feature of the reference's model."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[..., None].float() * freqs  # [T, half] or [B, T, half]
    if positions.dim() == 1:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _rms_norm(x, scale, dtype):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        return _rms_norm(x, self.scale, self.dtype)


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=torch.float32)


@torch.library.custom_op("bluefog_tpu_torch::attn_out", mutates_args=())
def attn_out(att: torch.Tensor) -> torch.Tensor:
    """Identity that names the attention output for ``remat_policy="attn"``
    (the reference's ``checkpoint_name(att, "attn_out")``): a dispatcher op
    the selective-checkpoint policy sees, where the flash kernel's launch
    inside its autograd Function is not one."""
    return att.clone()


@attn_out.register_fake
def _attn_out_fake(att):
    return torch.empty_like(att)


attn_out.register_autograd(lambda ctx, g: g)

_aten = torch.ops.aten
# what each remat policy saves for the backward; everything else in a block
# is recomputed (the reference's _remat_block policies)
_REMAT_SAVES = {
    "dots": (_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm),  # checkpoint_dots
    "dots_no_batch": (_aten.mm, _aten.addmm),  # checkpoint_dots_with_no_batch_dims
    "attn": (torch.ops.bluefog_tpu_torch.attn_out,),  # save_only_these_names("attn_out")
}


def _remat_context(policy: str) -> Callable:
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint`` that saves
    the outputs of ``_REMAT_SAVES[policy]`` and recomputes the rest."""
    saves = frozenset(_REMAT_SAVES[policy])

    def policy_fn(ctx, op, *args, **kwargs):
        if getattr(op, "overloadpacket", None) in saves:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


# a block's weights, in the order _decoder_block takes them
_BLOCK_WEIGHTS = ("attn_norm", "q", "k", "v", "o", "mlp_norm", "gate", "up", "down")


class _BlockSpec(NamedTuple):
    num_heads: int
    kv_heads: int
    dtype: torch.dtype
    attention_fn: Optional[Callable]
    mark_attn: bool  # name the attention output for remat_policy="attn"


def _decoder_block(spec: _BlockSpec, x, positions, attn_norm, wq, wk, wv, wo,
                   mlp_norm, wg, wu, wd):
    """One pre-norm decoder block on ``[B, T, d]``; projection weights are
    ``[out, in]`` f32, multiplied in ``spec.dtype``.  With GQA (``kv_heads``
    < ``num_heads``) k and v project to ``kv_heads`` heads and each is
    repeated in place, as ``jnp.repeat`` does: query head i reads kv head
    ``i // (num_heads / kv_heads)``."""
    b, t, d = x.shape
    hd = d // spec.num_heads
    dt = spec.dtype
    h = _rms_norm(x, attn_norm, dt)
    q = _rotary(F.linear(h, wq.to(dt)).view(b, t, spec.num_heads, hd), positions)
    k = _rotary(F.linear(h, wk.to(dt)).view(b, t, spec.kv_heads, hd), positions)
    v = F.linear(h, wv.to(dt)).view(b, t, spec.kv_heads, hd)
    if spec.kv_heads != spec.num_heads:
        rep = spec.num_heads // spec.kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if spec.attention_fn is not None:
        att = spec.attention_fn(q, k, v)
    else:
        att = dense_attention(q, k, v, causal=True, dtype=dt)
    if spec.mark_attn:
        att = attn_out(att)
    x = x + F.linear(att.reshape(b, t, d), wo.to(dt))
    h = _rms_norm(x, mlp_norm, dt)
    mlp = F.silu(F.linear(h, wg.to(dt))) * F.linear(h, wu.to(dt))
    return x + F.linear(mlp, wd.to(dt))


class _DecoderBlock(nn.Module):
    """One block's weights as modules (``layers.{i}.q.weight``, ...)."""

    def __init__(self, hidden: int, num_heads: int, kv_heads: int, dff: int, device):
        super().__init__()
        kv = kv_heads * (hidden // num_heads)
        self.attn_norm = RMSNorm(hidden, device=device)
        self.q = _linear(hidden, hidden, device)
        self.k = _linear(hidden, kv, device)
        self.v = _linear(hidden, kv, device)
        self.o = _linear(hidden, hidden, device)
        self.mlp_norm = RMSNorm(hidden, device=device)
        self.gate = _linear(hidden, dff, device)
        self.up = _linear(hidden, dff, device)
        self.down = _linear(dff, hidden, device)

    def weights(self):
        return tuple(m.scale if isinstance(m, RMSNorm) else m.weight
                     for m in (getattr(self, n) for n in _BLOCK_WEIGHTS))


class _ScannedDecoder(nn.Module):
    """Every block's weights stacked on a leading ``[num_layers]`` axis, one
    ``nn.Parameter`` a weight (``layers.q``: ``[L, out, in]``, ...), as the
    reference's ``scan_layers`` tree holds them: the optimizer and the
    gossip see nine leaves, not nine a layer."""

    def __init__(self, num_layers: int, hidden: int, num_heads: int, kv_heads: int,
                 dff: int, device):
        super().__init__()
        kv = kv_heads * (hidden // num_heads)
        shapes = {"attn_norm": (hidden,), "q": (hidden, hidden), "k": (kv, hidden),
                  "v": (kv, hidden), "o": (hidden, hidden), "mlp_norm": (hidden,),
                  "gate": (dff, hidden), "up": (dff, hidden), "down": (hidden, dff)}
        for name in _BLOCK_WEIGHTS:
            self.register_parameter(name, nn.Parameter(
                torch.empty(num_layers, *shapes[name], device=device)))

    def per_layer(self):
        """Each layer's weights, from one ``unbind`` a leaf: the backward
        then stacks the layers' gradients once, where indexing ``w[l]`` in
        the loop would add a zero tensor the size of the stack a layer."""
        return list(zip(*(getattr(self, n).unbind(0) for n in _BLOCK_WEIGHTS)))


def _mm_f32(a, b):
    """``a @ b`` of two bf16 matrices with an f32 output.  On the card one
    bf16 GEMM that accumulates and writes f32; on the CPU the f32 product
    of the bf16 values, which is exact in f32 and needs no TF32 switch."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _Bf16MatmulF32Acc(torch.autograd.Function):
    """``x @ W^T`` (``W`` the ``[V, d]`` head) with bf16 operands and f32
    accumulation in both directions: the twin of the JAX package's custom
    VJP ``_bf16_matmul_f32_acc``.  The backward rounds the cotangent to
    bf16 too, so dx = g.W and dW = g^T.x are bf16 GEMMs with f32 results."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.lead = x.shape[:-1]
        return _mm_f32(xb, wb.t()).reshape(*ctx.lead, w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
        dx = _mm_f32(gb, wb).reshape(*ctx.lead, wb.shape[1])
        return dx, _mm_f32(gb.t(), xb)


def head_matmul(x, head_w, head_dtype=torch.float32):
    """f32 logits ``x @ head_w^T`` whatever ``head_dtype``: f32 operands, or
    bf16 operands with f32 accumulation (:class:`_Bf16MatmulF32Acc`)."""
    if head_dtype == torch.bfloat16:
        return _Bf16MatmulF32Acc.apply(x, head_w)
    if head_dtype != torch.float32:
        raise ValueError(f"head_dtype must be float32 or bfloat16, got {head_dtype}")
    return F.linear(x.float(), head_w.float())


def one_hot(ids, n: int, dtype):
    """``jax.nn.one_hot``: a zero row for an id outside ``[0, n)``, where
    ``F.one_hot`` raises."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _target_logits(logits, y, onehot_targets: bool):
    """``logits[..., y]``; by a one-hot sum where ``onehot_targets`` (0 for
    an out-of-range id, as the reference's ``spmd_vocab`` gives)."""
    if onehot_targets:
        return (logits * one_hot(y, logits.shape[-1], logits.dtype)).sum(-1)
    return logits.gather(-1, y[..., None])[..., 0]


def _head_chunk_loss(xc, head_w, yc, wc, head_dtype, onehot_targets, kernel_constraint):
    if kernel_constraint is not None:
        head_w = kernel_constraint(head_w)
    logits = head_matmul(xc, head_w, head_dtype)  # [B, tc, V] f32 — the peak
    lse = torch.logsumexp(logits, dim=-1)
    tgt = _target_logits(logits, yc, onehot_targets)
    return ((lse - tgt) * wc).sum()


def chunked_softmax_cross_entropy(hidden, head_weight, labels, num_chunks: int,
                                  head_dtype=torch.float32, onehot_targets: bool = False,
                                  kernel_constraint: Optional[Callable] = None):
    """Shifted next-token cross-entropy without materializing the full
    ``[B, T, vocab]`` logits: ``mean(CE(logits[:, :-1], labels[:, 1:]))``
    computed per sequence chunk, each chunk under ``torch.utils.checkpoint``
    so its logits are recomputed in the backward.  ``head_weight`` is the
    ``[vocab, d]`` head, multiplied in ``head_dtype``;
    ``onehot_targets`` takes the target logit by a one-hot sum;
    ``kernel_constraint`` is applied to the head inside every chunk (the
    reference's per-chunk ``.sharding_only`` marker)."""
    B, T, _ = hidden.shape
    if T % num_chunks:
        raise ValueError(f"num_chunks {num_chunks} must divide T {T}")
    y = torch.cat([labels[:, 1:], labels[:, :1]], dim=1)
    w = torch.ones(B, T, dtype=torch.float32, device=hidden.device)
    w[:, -1] = 0.0  # the last token predicts nothing
    tc = T // num_chunks
    total = hidden.new_zeros((), dtype=torch.float32)
    for c in range(num_chunks):
        sl = slice(c * tc, (c + 1) * tc)
        total = total + checkpoint(_head_chunk_loss, hidden[:, sl], head_weight,
                                   y[:, sl], w[:, sl], head_dtype, onehot_targets,
                                   kernel_constraint, use_reentrant=False)
    return total / w.sum()


class LlamaLM(nn.Module):
    """Llama-style decoder-only LM: RMSNorm, rotary, SwiGLU, no biases.

    ``forward(ids, positions=None, labels=None)``, in the reference's order:
    ``positions`` (``[T]`` int, default ``arange(T)``, or ``[B, T]``, one
    row a batch row: see :func:`_rotary`) feed the rotary embedding of
    every block, so a sequence shard passes its global positions.  Without ``labels`` it returns f32 logits; with them, the
    scalar shifted-LM loss (chunked when ``head_chunks > 1``).
    ``head_dtype=torch.bfloat16`` runs the LM head on bf16 operands with
    f32 accumulation and f32 logits (:func:`head_matmul`).

    The reference's options:

    - ``num_kv_heads``: grouped-query attention (k and v on fewer heads,
      repeated up before the attention function).
    - ``remat``: each block under ``torch.utils.checkpoint`` (its forward is
      recomputed in the backward, the flash forward kernel with it);
      ``remat_policy`` ``"dots"`` / ``"dots_no_batch"`` / ``"attn"`` saves
      the matmul outputs / those without batch dims (not attention's
      ``bmm``) / the attention output (:func:`attn_out`) by selective
      checkpointing.  Without ``remat`` the policy does nothing.
    - ``scan_layers``: the blocks' weights stacked on a leading layer axis
      (:class:`_ScannedDecoder`); the same function as the unrolled model.
    - ``spmd_vocab``: the embedding as a one-hot matmul and the target logit
      as a one-hot sum (:func:`one_hot`): bit-equal to the default on
      in-range ids; an out-of-range id embeds as zeros and has no target
      logit.
    - The FSDP hooks, called where the reference calls them:
      ``act_constraint`` on the ``[B, T, d]`` hidden states after the
      embedding and after every block; ``onehot_constraint`` on the one-hot
      operand (``spmd_vocab``); ``weight_constraint`` on the table of the
      ``spmd_vocab`` embedding, on every weight of each block (in the
      stacked model on each layer's slice, as ``nn.map_variables`` applies
      it per scan step), and once on the head outside the chunk loop, with
      its ``.sharding_only`` form inside each chunk
      (:func:`bluefog_tpu_torch.parallel.zero.fsdp_param_io_constraint`).
      The final norm and the gather embedding get none, as in the
      reference.
    """

    def __init__(self, vocab_size: int = 32000, hidden_size: int = 512,
                 num_layers: int = 4, num_heads: int = 8, dff: int = 1376,
                 dtype=torch.bfloat16, attention_fn: Optional[Callable] = None,
                 remat: bool = False, remat_policy: Optional[str] = None,
                 scan_layers: bool = False, num_kv_heads: Optional[int] = None,
                 head_chunks: int = 0, head_dtype=torch.float32, spmd_vocab: bool = False,
                 act_constraint: Optional[Callable] = None,
                 onehot_constraint: Optional[Callable] = None,
                 weight_constraint: Optional[Callable] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads {num_heads}")
        kvh = num_kv_heads or num_heads
        if num_heads % kvh:
            raise ValueError(f"num_heads {num_heads} not divisible by num_kv_heads {kvh}")
        if head_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"head_dtype must be float32 or bfloat16, got {head_dtype}")
        if remat_policy and remat_policy not in _REMAT_SAVES:
            raise ValueError(f"remat_policy must be one of {sorted(_REMAT_SAVES)} or None, "
                             f"got {remat_policy!r}")
        self.dtype = dtype
        self.head_chunks = head_chunks
        self.head_dtype = head_dtype
        self.spmd_vocab = spmd_vocab
        self.act_constraint = act_constraint
        self.onehot_constraint = onehot_constraint
        self.weight_constraint = weight_constraint
        self.scan_layers = scan_layers
        self.remat = remat
        self.remat_policy = remat_policy if remat else None
        self.spec = _BlockSpec(num_heads, kvh, dtype, attention_fn,
                               mark_attn=self.remat_policy == "attn")
        self.embed = nn.Embedding(vocab_size, hidden_size, device=device,
                                  dtype=torch.float32)
        if scan_layers:
            self.layers = _ScannedDecoder(num_layers, hidden_size, num_heads, kvh, dff, device)
        else:
            self.layers = nn.ModuleList(
                _DecoderBlock(hidden_size, num_heads, kvh, dff, device)
                for _ in range(num_layers))
        self.norm = RMSNorm(hidden_size, torch.float32, device)
        self.head = _linear(hidden_size, vocab_size, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's distributions: N(0, 1/d) embedding, lecun-normal (normal
        truncated at 2 sigma, std 1/sqrt(fan_in)) projections, ones for
        norm scales.  A stacked weight ``[L, out, in]`` draws every layer
        with the layer's own fan-in ``in``."""
        d = self.embed.weight.shape[1]
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, generator)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)
            elif isinstance(mod, _ScannedDecoder):
                for name in _BLOCK_WEIGHTS:
                    w = getattr(mod, name)
                    if name.endswith("norm"):
                        w.fill_(1.0)
                    else:
                        lecun_normal_(w, w.shape[-1], generator)

    def split_head_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The q, k and v weights' shapes with the output axis split into
        (heads, head dim), by parameter name: ``[(L,) heads, hd, d]`` for
        ``[(L,) heads * hd, d]``.  These are the reference's DenseGeneral
        kernels ``[(L,) d, heads, hd]`` with the axes in another order, the
        shapes :class:`bluefog_tpu_torch.optim.Adafactor` factors them in."""
        heads = {"q": self.spec.num_heads, "k": self.spec.kv_heads, "v": self.spec.kv_heads}
        out = {}
        for name, p in self.named_parameters():
            parts = name.split(".")  # layers.{i}.q.weight, or layers.q stacked
            key = parts[-2] if parts[-1] == "weight" else parts[-1]
            if parts[0] == "layers" and key in heads:
                h = heads[key]
                out[name] = (*p.shape[:-2], h, p.shape[-2] // h, p.shape[-1])
        return out

    def _block(self, x, positions, weights):
        if not self.remat:
            return _decoder_block(self.spec, x, positions, *weights)
        kw = {}
        if self.remat_policy:
            kw["context_fn"] = _remat_context(self.remat_policy)
        return checkpoint(_decoder_block, self.spec, x, positions, *weights,
                          use_reentrant=False, **kw)

    def forward(self, input_ids, positions=None, labels=None):
        t = input_ids.shape[1]
        if positions is None:
            positions = torch.arange(t, device=input_ids.device)
        else:
            positions = torch.as_tensor(positions, device=input_ids.device)
        act, wc = self.act_constraint, self.weight_constraint
        table = self.embed.weight
        if self.spmd_vocab:
            if wc is not None:
                table = wc(table)
            oh = one_hot(input_ids, table.shape[0], self.dtype)
            if self.onehot_constraint is not None:
                oh = self.onehot_constraint(oh)
            x = oh @ table.to(self.dtype)
        else:
            x = F.embedding(input_ids, table.to(self.dtype))
        if act is not None:
            x = act(x)
        blocks = (self.layers.per_layer() if self.scan_layers
                  else [blk.weights() for blk in self.layers])
        for weights in blocks:
            if wc is not None:
                weights = tuple(wc(w) for w in weights)
            x = self._block(x, positions, weights)
            if act is not None:
                x = act(x)
        x = self.norm(x)  # f32
        head_w = self.head.weight
        if wc is not None:  # once, outside any chunk loop
            head_w = wc(head_w)
        if labels is None:
            return head_matmul(x, head_w, self.head_dtype)  # f32 logits
        if self.head_chunks > 1:
            if wc is not None and not hasattr(wc, "sharding_only"):
                raise ValueError(
                    "head_chunks > 1 with a custom weight_constraint requires a "
                    ".sharding_only attribute (the per-chunk pin without the "
                    "grad-dtype cast, cf. parallel/zero.fsdp_param_io_constraint): "
                    "passing the full constraint would re-round the head-kernel "
                    "cotangent once per chunk instead of once on the accumulated "
                    "gradient")
            return chunked_softmax_cross_entropy(
                x, head_w, labels, self.head_chunks, self.head_dtype,
                onehot_targets=self.spmd_vocab,
                kernel_constraint=getattr(wc, "sharding_only", wc))
        logits = head_matmul(x, head_w, self.head_dtype)[:, :-1]
        tgt = _target_logits(logits, labels[:, 1:], self.spmd_vocab)
        return (torch.logsumexp(logits, dim=-1) - tgt).mean()
