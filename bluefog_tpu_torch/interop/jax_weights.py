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
tree of the same structure maps the same way; :func:`llama_flax_params`
maps back.

The parallel layers' state crosses both ways: the packed ZeRO-1 grid
(:func:`zero_state_from_jax`, :func:`zero_state_to_jax`) and the FSDP
master and optimizer trees (:func:`fsdp_state_from_jax`,
:func:`fsdp_state_to_jax`), each machine's replica through a parameter
mapping such as :func:`llama_state_dict`; the tensor-, pipeline- and
expert-parallel trees keep the reference's layouts and cross as they are
(:func:`tree_from_jax`, :func:`tree_to_jax`).  This module needs only
numpy and torch: it reads arrays, not JAX objects.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["bert_state_dict", "fsdp_state_from_jax", "fsdp_state_to_jax", "lenet_state_dict",
           "llama_flax_params", "llama_state_dict", "resnet_state_dict", "tree_from_jax",
           "tree_to_jax", "vit_state_dict", "zero_state_from_jax", "zero_state_to_jax"]


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


# the scanned blocks' module: plain, or under the FSDP weight_constraint
# (nn.map_variables renames it)
_LLAMA_SCAN = ("Scan_ScannedDecoderBlock_0", "ScanMap_variables_ScannedDecoderBlock_0")
# an unrolled block's module name before its index: plain, remat, and each
# under the FSDP weight_constraint
_LLAMA_UNROLLED = ("_DecoderBlock_", "Checkpoint_DecoderBlock_",
                   "Map_variables_DecoderBlock_", "Map_variablesCheckpoint_DecoderBlock_")


def _llama_blocks_key(params: Mapping, i: int) -> str:
    for prefix in _LLAMA_UNROLLED:
        if f"{prefix}{i}" in params:
            return f"{prefix}{i}"
    raise KeyError(f"no decoder block {i} in the tree: looked for "
                   f"{[p + str(i) for p in _LLAMA_UNROLLED]}, have {sorted(params)}")


def llama_state_dict(params: Mapping, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``LlamaLM`` from a flax ``params`` tree, in
    the layout of the port's model with the same options.

    The blocks are ``_DecoderBlock_{i}`` (unrolled),
    ``Checkpoint_DecoderBlock_{i}`` (``remat``), or one
    ``Scan_ScannedDecoderBlock_0/{_DecoderBlock_0 | Checkpoint_DecoderBlock_0}``
    with every leaf stacked on a leading ``[num_layers]`` axis
    (``scan_layers``), which maps to the stacked ``layers.<name>``
    parameters.  Under the FSDP ``weight_constraint`` flax's
    ``nn.map_variables`` renames them ``Map_variables{_DecoderBlock |
    Checkpoint_DecoderBlock}_{i}`` and
    ``ScanMap_variables_ScannedDecoderBlock_0/...``.  GQA's k/v kernels
    ``[d, kvh, hd]`` map to ``[kvh * hd, d]``."""
    out = {"embed.weight": _t(params["Embed_0"]["embedding"])}
    scan = [k for k in _LLAMA_SCAN if k in params]
    if scan:
        (blk,) = params[scan[0]].values()
        for name, (mod, leaf) in _LLAMA_BLOCK.items():
            w = _llama_weight(blk[mod][leaf], stacked=True)
            if w.shape[0] != num_layers:
                raise ValueError(f"stacked {name} has {w.shape[0]} layers, "
                                 f"expected {num_layers}")
            out[f"layers.{name}"] = w
    else:
        for i in range(num_layers):
            blk = params[_llama_blocks_key(params, i)]
            for name, (mod, leaf) in _LLAMA_BLOCK.items():
                suffix = "scale" if leaf == "scale" else "weight"
                out[f"layers.{i}.{name}.{suffix}"] = _llama_weight(blk[mod][leaf], False)
    out["norm.scale"] = _t(params["RMSNorm_0"]["scale"])
    out["head.weight"] = _t(np.asarray(params["Dense_0"]["kernel"]).T)
    return out


def llama_flax_params(state_dict: Mapping, like: Mapping) -> Dict:
    """The inverse of :func:`llama_state_dict`: a flax ``params`` tree (numpy
    arrays) shaped and named as ``like`` (a flax tree of arrays or shape
    structs of the reference model with the same options), from the port's
    ``LlamaLM`` state dict (or a gradient dict of the same names)."""
    def back(w, shape, norm: bool):
        a = np.asarray(w.detach().cpu() if isinstance(w, torch.Tensor) else w, np.float32)
        if not norm:
            a = np.swapaxes(a, -1, -2)
        return a.reshape(shape)

    def shape(a):
        return tuple(getattr(a, "shape", None) or np.shape(a))

    out = {"Embed_0": {"embedding": back(state_dict["embed.weight"],
                                         shape(like["Embed_0"]["embedding"]), True)},
           "RMSNorm_0": {"scale": back(state_dict["norm.scale"],
                                       shape(like["RMSNorm_0"]["scale"]), True)},
           "Dense_0": {"kernel": back(state_dict["head.weight"],
                                      shape(like["Dense_0"]["kernel"]), False)}}
    scan = [k for k in _LLAMA_SCAN if k in like]
    if scan:
        ((inner, blk),) = like[scan[0]].items()
        tree = {}
        for name, (mod, leaf) in _LLAMA_BLOCK.items():
            tree.setdefault(mod, {})[leaf] = back(state_dict[f"layers.{name}"],
                                                  shape(blk[mod][leaf]), leaf == "scale")
        out[scan[0]] = {inner: tree}
        return out
    i = 0
    while any(f"{p}{i}" in like for p in _LLAMA_UNROLLED):
        key = _llama_blocks_key(like, i)
        tree = {}
        for name, (mod, leaf) in _LLAMA_BLOCK.items():
            suffix = "scale" if leaf == "scale" else "weight"
            tree.setdefault(mod, {})[leaf] = back(state_dict[f"layers.{i}.{name}.{suffix}"],
                                                  shape(like[key][mod][leaf]), leaf == "scale")
        out[key] = tree
        i += 1
    return out


# --------------------------------------------------------------------------
# Trees and parallel-layer state (tensor, pipeline, expert, ZeRO / FSDP)
# --------------------------------------------------------------------------


def tree_from_jax(tree, dtype=torch.float32):
    """A nested dict / list / tuple of arrays as the same structure of
    tensors in ``dtype`` (integer leaves keep an integer dtype).  The
    tensor-, pipeline- and expert-parallel parameter trees keep the
    reference's layouts (the stacked ``[tp, ...]`` / ``[pp, ...]`` /
    ``[ep, E/ep, ...]`` leaves, the same einsum index orders), so they
    cross as they are."""
    if isinstance(tree, Mapping):
        return {k: tree_from_jax(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_jax(v, dtype) for v in tree)
    if tree is None:  # a placeholder of a split tree
        return None
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(np.array(a, dtype=np.int32))
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def tree_to_jax(tree):
    """The inverse of :func:`tree_from_jax`: numpy arrays (f32 for floating
    leaves) in the same structure."""
    if isinstance(tree, Mapping):
        return {k: tree_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_jax(v) for v in tree)
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        return np.asarray(tree)
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _leaves(tree) -> list:
    """Leaves in ``jax.tree_util``'s order: dict keys sorted, sequences in
    order (the port's ``ops.tree_flatten`` order too)."""
    if isinstance(tree, Mapping):
        return [l for k in sorted(tree) for l in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _unflatten_like(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, Mapping):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(like)


def _np(a) -> np.ndarray:
    return (a.detach().cpu().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _map_leaves(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def _is_float(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def _convert_machines(tree, convert):
    """Each machine's slice of a ``[machines, ...]`` tree through
    ``convert`` (one replica's tree in, the other package's tree out),
    restacked as numpy arrays."""
    leaves = [_np(l) for l in _leaves(tree)]
    per = [convert(_unflatten_like(tree, [l[m] for l in leaves]))
           for m in range(leaves[0].shape[0])]
    return _unflatten_like(per[0], [np.stack([_np(x) for x in ls])
                                    for ls in zip(*map(_leaves, per))])


def _counts_like(counts, master):
    """Step counters shaped ``[machines, 1, ...]`` against each leaf of
    ``master``: one machine's counts agree over its leaves (every leaf
    steps together), so they cross by value."""
    vals = np.stack([np.asarray(_np(c)).reshape(np.shape(c)[0], -1)[:, 0]
                     for c in _leaves(counts)])
    if not (vals == vals[:1]).all():
        raise ValueError("per-leaf step counts differ within a machine")
    return _map_leaves(master, lambda l: vals[0].reshape(
        (-1,) + (1,) * (l.ndim - 1)).astype(np.int32))


def _fsdp_cross(state, convert):
    master = _convert_machines(state["master"], convert)
    opt = tuple(_convert_machines(o, convert) if _is_float(_leaves(o)[0])
                else _counts_like(o, master) for o in state["opt"])
    return {"master": master, "opt": opt}


def fsdp_state_from_jax(state: Mapping, to_port, *, momentum_dtype=torch.float32):
    """The reference's ``make_fsdp_gossip_train_step`` state (``{"master":
    tree of [machines, ...], "opt": (slots)}``, arrays) as the port's: each
    machine's slice of the master and of every float slot through
    ``to_port`` (one flax tree in, the port's dict out: e.g.
    ``functools.partial(llama_state_dict, num_layers=L)``, or
    :func:`tree_from_jax` for a plain tree), and the per-leaf step counts
    reshaped to the port's leaves.  Tensors: f32 master, the first slot in
    ``momentum_dtype``, f32 for the other float slots (adamw's nu), int32
    counts."""
    out = _fsdp_cross(state, to_port)
    dts = [momentum_dtype] + [torch.float32] * (len(out["opt"]) - 1)

    def tens(dt):
        return lambda a: torch.from_numpy(a).to(dt if a.dtype.kind == "f" else torch.int32)

    return {"master": _map_leaves(out["master"], tens(torch.float32)),
            "opt": tuple(_map_leaves(o, tens(dt)) for o, dt in zip(out["opt"], dts))}


def fsdp_state_to_jax(state: Mapping, to_jax):
    """The inverse of :func:`fsdp_state_from_jax`: the port's FSDP state as
    the reference's, numpy arrays (f32 float slots, int32 counts);
    ``to_jax`` takes one machine's port dict to a flax tree (e.g.
    ``functools.partial(llama_flax_params, like=params)``)."""
    return _fsdp_cross(state, to_jax)


def _repack_grid(grid, src_like, convert, local: int):
    """A packed ``[machines, local, shard]`` grid, unpacked by the leaf
    shapes of ``src_like`` in tree order, each machine's tree through
    ``convert``, and packed again in the converted tree's order, padded to
    a multiple of ``local``."""
    g = _np(grid)
    src_shapes = [tuple(l.shape) for l in _leaves(src_like)]
    out = []
    for m in range(g.shape[0]):
        vec, off, leaves = g[m].reshape(-1), 0, []
        for shp in src_shapes:
            n = int(np.prod(shp, dtype=np.int64))
            leaves.append(vec[off:off + n].reshape(shp))
            off += n
        flat = np.concatenate([np.ravel(_np(l)) for l in
                               _leaves(convert(_unflatten_like(src_like, leaves)))])
        padded = -(-flat.size // local) * local
        out.append(np.pad(flat, (0, padded - flat.size)).reshape(local, -1))
    return np.stack(out)


def _zero_cross(state, src_like, convert, local, wrap):
    opt = tuple(_repack_grid(o, src_like, convert, local) if _is_float(o)
                else _np(o).astype(np.int32) for o in state["opt"])
    return {"master": wrap(_repack_grid(state["master"], src_like, convert, local)),
            "opt": tuple(wrap(o) for o in opt)}


def zero_state_from_jax(state: Mapping, like: Mapping, to_port, local: int):
    """The reference's packed ZeRO-1 state (``make_zero_gossip_train_step``:
    ``[machines, local, padded/local]`` grids, counts ``[machines, local,
    1]``) as the port's: each machine's vector unpacked by the leaf shapes
    of the flax tree ``like``, through ``to_port``, packed in the port's
    leaf order (sorted names) and padded to a multiple of ``local``.
    Tensors: f32 grids, int32 counts."""
    return _zero_cross(state, like, lambda t: to_port(t), local, torch.from_numpy)


def zero_state_to_jax(state: Mapping, like: Mapping, to_jax, local: int):
    """The inverse of :func:`zero_state_from_jax`: ``like`` is the port's
    parameter dict (its leaf shapes and order), ``to_jax`` one machine's
    dict to a flax tree; numpy arrays out."""
    return _zero_cross(state, like, lambda t: to_jax(t), local, lambda a: a)


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
