"""Transformer models (counterpart of ``bluefog_tpu/models/transformer.py``):
the BERT-style encoder with a classification head (:class:`BertEncoder`,
the push-sum fine-tune workload) and the Llama-style decoder LM.

``BertEncoder`` keeps the reference's dtypes: f32 parameters, products in
``dtype`` (bf16 by default) on a residual stream in ``dtype``, LayerNorm
(epsilon 1e-6), softmax, pooler and classifier in f32, the tanh GELU, and
padding masked by -1e30 on the scaled f32 scores (a row with every key
masked gets a uniform softmax).  Its attention is the plain dense product,
as in the reference, which runs it outside any Pallas kernel.

Only ``LlamaLM``'s default path is ported: unrolled layers, multi-head
attention, no remat, no vocab-sharded mode.  Parameters are f32 and matmuls
run in ``dtype`` (bf16 by default), with norms and softmax in f32 and the
LM head in ``head_dtype``: f32 by default, or bf16 operands with f32
accumulation in both directions (the JAX ``_head_matmul``).

Layout: projections are ``nn.Linear`` (weight ``[out, in]``), the transpose
of flax's ``(in, out)`` kernels; :mod:`bluefog_tpu_torch.interop.jax_weights`
maps one to the other.  :meth:`LlamaLM.reset_parameters` draws from flax's
distributions (lecun-normal projections, N(0, 1/d) embedding, ones for the
norms) from an explicit ``torch.Generator``: the same distributions, not
the same bits.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bluefog_tpu_torch.models.layers import Dense, LayerNorm, lecun_normal_

__all__ = ["BertEncoder", "LlamaLM", "RMSNorm", "dense_attention",
           "chunked_softmax_cross_entropy", "head_matmul"]


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
    """Rotary position embedding; x: [B, T, H, D], positions: [T]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    angles = positions[:, None].float() * freqs[None, :]  # [T, half]
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6) * self.scale).to(self.dtype)


def _linear(d_in: int, d_out: int, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, device=device, dtype=torch.float32)


class _DecoderBlock(nn.Module):
    def __init__(self, hidden: int, num_heads: int, dff: int, dtype,
                 attention_fn: Optional[Callable], device):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention_fn = attention_fn
        self.attn_norm = RMSNorm(hidden, dtype, device)
        self.q = _linear(hidden, hidden, device)
        self.k = _linear(hidden, hidden, device)
        self.v = _linear(hidden, hidden, device)
        self.o = _linear(hidden, hidden, device)
        self.mlp_norm = RMSNorm(hidden, dtype, device)
        self.gate = _linear(hidden, dff, device)
        self.up = _linear(hidden, dff, device)
        self.down = _linear(dff, hidden, device)

    def _proj(self, lin: nn.Linear, x):
        return F.linear(x, lin.weight.to(self.dtype))

    def forward(self, x, positions):
        b, t, d = x.shape
        hd = d // self.num_heads
        h = self.attn_norm(x)
        q = _rotary(self._proj(self.q, h).view(b, t, self.num_heads, hd), positions)
        k = _rotary(self._proj(self.k, h).view(b, t, self.num_heads, hd), positions)
        v = self._proj(self.v, h).view(b, t, self.num_heads, hd)
        if self.attention_fn is not None:
            att = self.attention_fn(q, k, v)
        else:
            att = dense_attention(q, k, v, causal=True, dtype=self.dtype)
        x = x + self._proj(self.o, att.reshape(b, t, d))
        h = self.mlp_norm(x)
        mlp = F.silu(self._proj(self.gate, h)) * self._proj(self.up, h)
        return x + self._proj(self.down, mlp)


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
    return F.linear(x.float(), head_w)


def _head_chunk_loss(xc, head_w, yc, wc, head_dtype):
    logits = head_matmul(xc, head_w, head_dtype)  # [B, tc, V] f32 — the peak
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, yc[..., None])[..., 0]
    return ((lse - tgt) * wc).sum()


def chunked_softmax_cross_entropy(hidden, head_weight, labels, num_chunks: int,
                                  head_dtype=torch.float32):
    """Shifted next-token cross-entropy without materializing the full
    ``[B, T, vocab]`` logits: ``mean(CE(logits[:, :-1], labels[:, 1:]))``
    computed per sequence chunk, each chunk under ``torch.utils.checkpoint``
    so its logits are recomputed in the backward.  ``head_weight`` is the
    ``[vocab, d]`` f32 head, multiplied in ``head_dtype``."""
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
                                   y[:, sl], w[:, sl], head_dtype, use_reentrant=False)
    return total / w.sum()


class LlamaLM(nn.Module):
    """Llama-style decoder-only LM: RMSNorm, rotary, SwiGLU, no biases.

    ``forward(ids)`` returns f32 logits; ``forward(ids, labels=...)``
    returns the scalar shifted-LM loss (chunked when ``head_chunks > 1``).
    ``head_dtype=torch.bfloat16`` runs the LM head on bf16 operands with
    f32 accumulation and f32 logits (:func:`head_matmul`).
    """

    def __init__(self, vocab_size: int = 32000, hidden_size: int = 512,
                 num_layers: int = 4, num_heads: int = 8, dff: int = 1376,
                 dtype=torch.bfloat16, attention_fn: Optional[Callable] = None,
                 head_chunks: int = 0, head_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden {hidden_size} not divisible by heads {num_heads}")
        if head_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"head_dtype must be float32 or bfloat16, got {head_dtype}")
        self.dtype = dtype
        self.head_chunks = head_chunks
        self.head_dtype = head_dtype
        self.embed = nn.Embedding(vocab_size, hidden_size, device=device,
                                  dtype=torch.float32)
        self.layers = nn.ModuleList(
            _DecoderBlock(hidden_size, num_heads, dff, dtype, attention_fn, device)
            for _ in range(num_layers))
        self.norm = RMSNorm(hidden_size, torch.float32, device)
        self.head = _linear(hidden_size, vocab_size, device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's distributions: N(0, 1/d) embedding, lecun-normal (normal
        truncated at 2 sigma, std 1/sqrt(fan_in)) projections, ones for
        norm scales."""
        d = self.embed.weight.shape[1]
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                # flax's truncated_normal rescales so the truncated draw has
                # the target std; 0.8796... is the std of N(0,1) cut at ±2
                std = 1.0 / math.sqrt(mod.in_features) / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.scale.fill_(1.0)

    def forward(self, input_ids, labels=None):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = F.embedding(input_ids, self.embed.weight.to(self.dtype))
        for layer in self.layers:
            x = layer(x, positions)
        x = self.norm(x)  # f32
        if labels is None:
            return head_matmul(x, self.head.weight, self.head_dtype)  # f32 logits
        if self.head_chunks > 1:
            return chunked_softmax_cross_entropy(x, self.head.weight, labels,
                                                 self.head_chunks, self.head_dtype)
        logits = head_matmul(x, self.head.weight, self.head_dtype)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               labels[:, 1:].reshape(-1))
