"""Weights carried across between the JAX package's layout and the port's.

The JAX transformer stores its layers stacked for ``lax.scan``: attention
leaves under ``blocks["attn"]`` with leading ``(n_super, period)`` axes,
MLP leaves under ``blocks["mlp"]`` with a leading ``(n_super,)`` axis
(``src/repro/models/transformer.py::init``).  The JAX SSM LM stacks its
Mamba1 layers under ``layers`` on a leading ``(n_layers,)`` axis
(``src/repro/models/ssm_lm.py::init``).  The port keeps every layer's
tensors apart, under ``nn.Module`` names (``layers.3.attn.wq``), so
conversion unstacks those axes (``params_from_jax``) or stacks them back
(``jax_tree``, ``params_to_jax``).  Checkpoints are written in the JAX
layout, so that either package restores the other's.

A bfloat16 leaf crosses as numpy's 2-byte void words, the bytes of an
``ml_dtypes`` bfloat16 array (``train.checkpoint.host_array``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import Transformer
from repro_torch.train.checkpoint import host_array, tensor_from_host

# Mamba1 leaves that stay f32 in a bf16 model (``ssm.mamba1_init``)
F32_LEAVES = ("A_log", "D")


def _set(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _layer_path(cfg, rest: tuple) -> tuple:
    """The JAX key path of a per-layer leaf whose port name ends in
    ``rest`` (``("attn", "wq")``; an SSM layer's ``("A_log",)``)."""
    return ("layers",) + rest if cfg.family == "ssm" else ("blocks",) + rest


def jax_ndim(name: str, p: torch.Tensor, cfg) -> int:
    """The number of dims of port tensor ``name``'s leaf in the JAX layout:
    the stacked axes added to a per-layer tensor's own."""
    parts = name.split(".")
    if parts[0] != "layers":
        return p.dim()
    stacked = 2 if cfg.family != "ssm" and parts[2] == "attn" else 1
    return p.dim() + stacked


def decayed_names(named: dict, cfg) -> set:
    """The names AdamW decays: those whose JAX leaf has ``ndim >= 2``
    (``src/repro/train/optimizer.py::_is_matrix``).  Every per-layer tensor
    is one, norms included; ``final_norm`` is not."""
    return {k for k, p in named.items() if jax_ndim(k, p, cfg) >= 2}


def jax_tree(named: dict, cfg) -> dict:
    """``named`` (port name -> tensor: a model's parameters, or AdamW
    moments under the same names) as a nested dict in the JAX layout,
    per-layer tensors stacked into new tensors on their device."""
    out, per_layer = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = t
        else:
            _set(out, parts, t)
    for rest, by_layer in per_layer.items():
        if sorted(by_layer) != list(range(cfg.n_layers)):
            raise ValueError(f"{'.'.join(rest)}: layers {sorted(by_layer)} "
                             f"for {cfg.n_layers}")
        stacked = torch.stack([by_layer[i] for i in range(cfg.n_layers)])
        if cfg.family != "ssm" and rest[0] == "attn":
            stacked = stacked[:, None]          # the superblock period, 1
        _set(out, _layer_path(cfg, rest), stacked)
    return out


def named_from_jax(tree: dict, cfg) -> dict:
    """Inverse of :func:`jax_tree`: port name -> that layer's slice of the
    JAX leaf (numpy arrays or tensors, as given)."""
    named = {f"embed.{k}": a for k, a in tree["embed"].items()}
    named["final_norm"] = tree["final_norm"]
    if cfg.family == "ssm":
        stack = tree["layers"]
        n = {np.shape(a)[0] for a in stack.values()}
        if n != {cfg.n_layers}:
            raise ValueError(f"Mamba1 stack of {sorted(n)} layers for "
                             f"{cfg.n_layers}")
        for k, a in stack.items():
            for i in range(cfg.n_layers):
                named[f"layers.{i}.{k}"] = a[i]
        return named
    blocks = tree["blocks"]
    if set(blocks) != {"attn", "mlp"}:
        raise NotImplementedError(
            f"blocks {sorted(blocks)}: only the dense family's attn + mlp "
            f"stacks convert")
    n_super, period = np.shape(blocks["attn"]["wq"])[:2]
    if period != 1 or n_super != cfg.n_layers:
        raise ValueError(f"attention stack of shape ({n_super}, {period}) "
                         f"for {cfg.n_layers} dense layers")
    for grp in ("attn", "mlp"):
        for k, a in blocks[grp].items():
            for i in range(n_super):
                named[f"layers.{i}.{grp}.{k}"] = a[i, 0] if grp == "attn" \
                    else a[i]
    return named


def params_from_jax(tree: dict, cfg, device=None, dtype=None):
    """``tree``: the JAX ``init`` params as nested dicts of numpy arrays (or
    tensors) under the JAX key paths.  Returns the port's model on
    ``device``, in ``dtype`` (default: the arrays' own dtype; ``A_log`` and
    ``D`` of a Mamba1 layer stay f32), its parameters carrying no
    gradient."""
    dt = None if dtype is None else torch_dtype(dtype)

    def t(name, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            x = a.detach().to(device, copy=True)
        else:
            x = tensor_from_host(a, device=device)     # a writable copy
        keep_f32 = cfg.family == "ssm" and name.rsplit(".", 1)[-1] in \
            F32_LEAVES
        return x if dt is None or keep_f32 else x.to(dt)

    named = {k: t(k, a) for k, a in named_from_jax(tree, cfg).items()}
    embed = {k.split(".", 1)[1]: v for k, v in named.items()
             if k.startswith("embed.")}

    def layer(prefix):
        return {k[len(prefix):]: v for k, v in named.items()
                if k.startswith(prefix)}

    if cfg.family == "ssm":
        return MambaLM(cfg, embed, named["final_norm"],
                       [layer(f"layers.{i}.") for i in range(cfg.n_layers)])
    return Transformer(cfg, embed, named["final_norm"],
                       [(layer(f"layers.{i}.attn."), layer(f"layers.{i}.mlp."))
                        for i in range(cfg.n_layers)])


def params_to_jax(model) -> dict:
    """Inverse of :func:`params_from_jax`: the model's parameters stacked
    into the JAX layout, as host numpy arrays (bfloat16 as 2-byte void
    words)."""
    tree = jax_tree(dict(model.named_parameters()), model.cfg)

    def host(x):
        return {k: host(v) for k, v in x.items()} if isinstance(x, dict) \
            else host_array(x)
    return host(tree)
