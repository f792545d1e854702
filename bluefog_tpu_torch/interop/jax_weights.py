"""Carry model weights from the JAX package to this one.

Each function maps a flax tree (nested dicts of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, params)``) to the ``state_dict`` of
the port's model: :func:`bert_state_dict` for ``BertEncoder``,
:func:`llama_state_dict` for ``LlamaLM`` (every block layout its options
make), :func:`vit_state_dict` for ``ViT``,
:func:`lenet_state_dict` for ``LeNet5`` and :func:`resnet_state_dict` for
``ResNet`` (parameters and ``batch_stats``).  Flax dense kernels are
``(in, out)``, ``nn.Linear`` weights ``(out, in)``: they transpose.  Flax
convolution kernels are ``[kh, kw, in, out]``, the port's ``[out, in, kh,
kw]``; BERT's fused ``DenseGeneral((3, H, Dh))`` kernel ``[d, 3, H, Dh]``
flattens in that order into the ``[3·H·Dh, d]`` qkv weight.  A gradient
tree of the same structure maps the same way.  This module needs only
numpy and torch: it reads arrays, not JAX
objects.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["bert_state_dict", "lenet_state_dict", "llama_state_dict", "resnet_state_dict",
           "vit_state_dict"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:  # [kh, kw, in, out] -> [out, in, kh, kw]
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _dense(tree, out: Dict[str, torch.Tensor], name: str) -> None:
    out[name + ".weight"] = _t(np.asarray(tree["kernel"]).T)
    out[name + ".bias"] = _t(tree["bias"])


def _layer_norm(tree, out: Dict[str, torch.Tensor], name: str) -> None:
    out[name + ".scale"] = _t(tree["scale"])
    out[name + ".bias"] = _t(tree["bias"])


def _encoder_block(blk, out: Dict[str, torch.Tensor], pre: str) -> None:
    """One ``_EncoderBlock`` (BERT's and ViT's) under the prefix ``pre``."""
    _layer_norm(blk["LayerNorm_0"], out, pre + "ln1")
    qkv = blk["DenseGeneral_0"]
    k = np.asarray(qkv["kernel"])  # [d, 3, H, Dh]
    out[pre + "qkv.weight"] = _t(k.reshape(k.shape[0], -1).T)
    out[pre + "qkv.bias"] = _t(np.asarray(qkv["bias"]).reshape(-1))
    _dense(blk["Dense_0"], out, pre + "o")
    _layer_norm(blk["LayerNorm_1"], out, pre + "ln2")
    _dense(blk["Dense_1"], out, pre + "fc1")
    _dense(blk["Dense_2"], out, pre + "fc2")


def bert_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``BertEncoder`` from a flax ``params`` tree."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"]),
           "pos_embedding": _t(params["pos_embedding"])}
    for i in range(num_layers):
        _encoder_block(params[f"_EncoderBlock_{i}"], out, f"layers.{i}.")
    _layer_norm(params["LayerNorm_0"], out, "norm")
    _dense(params["Dense_0"], out, "pooler")
    _dense(params["Dense_1"], out, "classifier")
    return out


def vit_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``ViT`` from a flax ``params`` tree: the
    ``patch_embed`` kernel ``[P, P, 3, hidden]`` becomes the patchify
    convolution's weight, ``cls`` ``[1, 1, hidden]`` and ``pos_embedding``
    ``[1, 1 + (S/P)^2, hidden]`` keep their shapes."""
    out = {"patch_embed.weight": _conv(params["patch_embed"]["kernel"]),
           "patch_embed.bias": _t(params["patch_embed"]["bias"]),
           "cls": _t(params["cls"]), "pos_embedding": _t(params["pos_embedding"])}
    for i in range(num_layers):
        _encoder_block(params[f"_EncoderBlock_{i}"], out, f"layers.{i}.")
    _layer_norm(params["LayerNorm_0"], out, "norm")
    _dense(params["Dense_0"], out, "head")
    return out


# flax's names for a decoder block's weights, by the port's names
_LLAMA_BLOCK = {"q": ("DenseGeneral_0", "kernel"), "k": ("DenseGeneral_1", "kernel"),
                "v": ("DenseGeneral_2", "kernel"), "o": ("Dense_0", "kernel"),
                "gate": ("Dense_1", "kernel"), "up": ("Dense_2", "kernel"),
                "down": ("Dense_3", "kernel"), "attn_norm": ("RMSNorm_0", "scale"),
                "mlp_norm": ("RMSNorm_1", "scale")}


def _llama_weight(a, stacked: bool) -> torch.Tensor:
    """A flax decoder-block leaf in the port's layout, with or without a
    leading layer axis: a kernel ``[(L,) d, heads, hd]`` or ``[(L,) in,
    out]`` becomes ``[(L,) out, in]``; a norm scale keeps its shape."""
    a = np.asarray(a)
    lead = a.shape[:1] if stacked else ()
    body = a.shape[len(lead):]
    if len(body) == 1:
        return _t(a)
    return _t(np.swapaxes(a.reshape(lead + (body[0], -1)), -1, -2))


def llama_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``LlamaLM`` from a flax ``params`` tree, in
    the layout of the port's model with the same options.

    The blocks are ``_DecoderBlock_{i}`` (unrolled),
    ``Checkpoint_DecoderBlock_{i}`` (``remat``), or one
    ``Scan_ScannedDecoderBlock_0/{_DecoderBlock_0 | Checkpoint_DecoderBlock_0}``
    with every leaf stacked on a leading ``[num_layers]`` axis
    (``scan_layers``), which maps to the stacked ``layers.<name>``
    parameters.  GQA's k/v kernels ``[d, kvh, hd]`` map to ``[kvh * hd, d]``."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"])}
    if "Scan_ScannedDecoderBlock_0" in params:
        (blk,) = params["Scan_ScannedDecoderBlock_0"].values()
        for name, (mod, leaf) in _LLAMA_BLOCK.items():
            w = _llama_weight(blk[mod][leaf], stacked=True)
            if w.shape[0] != num_layers:
                raise ValueError(f"stacked {name} has {w.shape[0]} layers, "
                                 f"expected {num_layers}")
            out[f"layers.{name}"] = w
    else:
        for i in range(num_layers):
            key = f"_DecoderBlock_{i}"
            blk = params[key if key in params else f"Checkpoint_DecoderBlock_{i}"]
            for name, (mod, leaf) in _LLAMA_BLOCK.items():
                suffix = "scale" if leaf == "scale" else "weight"
                out[f"layers.{i}.{name}.{suffix}"] = _llama_weight(blk[mod][leaf], False)
    out["norm.scale"] = _t(params["RMSNorm_0"]["scale"])
    out["head.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    return out


def lenet_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``LeNet5`` from a flax ``params`` tree."""
    out: Dict[str, torch.Tensor] = {}
    for j in range(2):
        out[f"conv{j + 1}.weight"] = _conv(params[f"Conv_{j}"]["kernel"])
        out[f"conv{j + 1}.bias"] = _t(params[f"Conv_{j}"]["bias"])
    for j in range(3):
        _dense(params[f"Dense_{j}"], out, f"fc{j + 1}")
    return out


def _norm(p, s, out: Dict[str, torch.Tensor], name: str) -> None:
    out[name + ".scale"] = _t(p["scale"])
    out[name + ".bias"] = _t(p["bias"])
    out[name + ".mean"] = _t(s["mean"])
    out[name + ".var"] = _t(s["var"])


def resnet_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (parameters and BatchNorm statistics as buffers) for the
    port's ``ResNet`` from flax ``params`` and ``batch_stats`` trees."""
    out = {"conv_init.weight": _conv(params["conv_init"]["kernel"])}
    _norm(params["bn_init"], batch_stats["bn_init"], out, "bn_init")
    blocks = sorted((k for k in params if k.startswith(("BasicBlock_", "BottleneckBlock_"))),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
    for i, name in enumerate(blocks):
        blk, stats = params[name], batch_stats[name]
        n_conv = sum(k.startswith("Conv_") for k in blk)
        for j in range(n_conv):
            out[f"blocks.{i}.convs.{j}.weight"] = _conv(blk[f"Conv_{j}"]["kernel"])
            _norm(blk[f"BatchNorm_{j}"], stats[f"BatchNorm_{j}"], out, f"blocks.{i}.norms.{j}")
    _dense(params["Dense_0"], out, "fc")
    return out
