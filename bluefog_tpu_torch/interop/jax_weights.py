"""Carry ``LlamaLM`` weights from the JAX package to this one.

:func:`llama_state_dict` maps the flax parameter tree of
``bluefog_tpu.models.transformer.LlamaLM`` (nested dicts of numpy arrays,
e.g. ``jax.tree_util.tree_map(np.asarray, params)``) to the ``state_dict``
of :class:`bluefog_tpu_torch.models.transformer.LlamaLM`.  Flax kernels are
``(in, out)``; ``nn.Linear`` weights are ``(out, in)``, so they transpose.
This module needs only numpy and torch: it reads arrays, not JAX objects.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["llama_state_dict"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


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
