"""Carry model weights from the JAX package to this one.

Each function maps a flax tree (nested dicts of numpy arrays, e.g.
``jax.tree_util.tree_map(np.asarray, params)``) to the ``state_dict`` of
the port's model: :func:`bert_state_dict` for ``BertEncoder``,
:func:`llama_state_dict` for ``LlamaLM``,
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

__all__ = ["bert_state_dict", "lenet_state_dict", "llama_state_dict", "resnet_state_dict"]


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


def bert_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``BertEncoder`` from a flax ``params`` tree."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"]),
           "pos_embedding": _t(params["pos_embedding"])}
    for i in range(num_layers):
        blk = params[f"_EncoderBlock_{i}"]
        pre = f"layers.{i}."
        _layer_norm(blk["LayerNorm_0"], out, pre + "ln1")
        qkv = blk["DenseGeneral_0"]
        k = np.asarray(qkv["kernel"])  # [d, 3, H, Dh]
        out[pre + "qkv.weight"] = _t(k.reshape(k.shape[0], -1).T)
        out[pre + "qkv.bias"] = _t(np.asarray(qkv["bias"]).reshape(-1))
        _dense(blk["Dense_0"], out, pre + "o")
        _layer_norm(blk["LayerNorm_1"], out, pre + "ln2")
        _dense(blk["Dense_1"], out, pre + "fc1")
        _dense(blk["Dense_2"], out, pre + "fc2")
    _layer_norm(params["LayerNorm_0"], out, "norm")
    _dense(params["Dense_0"], out, "pooler")
    _dense(params["Dense_1"], out, "classifier")
    return out


def llama_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``LlamaLM`` from a flax ``params`` tree."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"])}
    for i in range(num_layers):
        blk = params[f"_DecoderBlock_{i}"]
        pre = f"layers.{i}."
        for j, name in enumerate(("q", "k", "v")):
            w = np.asarray(blk[f"DenseGeneral_{j}"]["kernel"])  # [d, H, hd]
            out[pre + name + ".weight"] = _t(w.reshape(w.shape[0], -1).T)
        for j, name in enumerate(("o", "gate", "up", "down")):
            out[pre + name + ".weight"] = _t(np.asarray(blk[f"Dense_{j}"]["kernel"]).T)
        out[pre + "attn_norm.scale"] = _t(blk["RMSNorm_0"]["scale"])
        out[pre + "mlp_norm.scale"] = _t(blk["RMSNorm_1"]["scale"])
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
