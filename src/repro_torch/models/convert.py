"""Weights carried across between the JAX package's layout and the port's.

The JAX transformer stores its layers stacked for ``lax.scan`` in
superblocks of ``moe_layer_period`` layers
(``src/repro/models/transformer.py::init``): attention leaves under
``blocks["attn"]`` with leading ``(n_super, period)`` axes; the dense
family's MLP under ``blocks["mlp"]`` with ``(n_super,)``; the MoE family's
expert layer (the last of each superblock) under ``blocks["moe"]`` with
``(n_super,)`` (its ``shared`` MLP a nested dict) and its other layers'
MLPs under ``blocks["mlp_dense"]`` with ``(n_super, period - 1)``.  Layer
i is superblock ``i // period``, slot ``i % period``.  The JAX SSM LM
stacks its Mamba1 layers under ``layers`` on a leading ``(n_layers,)``
axis (``src/repro/models/ssm_lm.py::init``), and the encoder-decoder its
two stacks under ``encoder`` and ``decoder`` the same way
(``src/repro/models/encdec.py::init``).  The JAX hybrid stacks its Mamba2
layers under ``layers`` on leading ``(G, P)`` axes, G groups of
``shared_attn_period`` layers, beside its unstacked ``shared`` block
(``src/repro/models/hybrid.py::init``).  The port keeps every layer's
tensors apart, under ``nn.Module`` names (``layers.3.attn.wq``,
``layers.3.moe.shared.wg``, ``decoder.3.cross.wk``; the hybrid's
``layers.1.0.in_proj``, group 1's first layer, and ``shared.attn.wq``),
so conversion unstacks those axes
(``params_from_jax``) or stacks them back (``jax_tree``,
``params_to_jax``).  Checkpoints are written in the JAX layout, so that
either package restores the other's.

A bfloat16 leaf crosses as numpy's 2-byte void words, the bytes of an
``ml_dtypes`` bfloat16 array (``train.checkpoint.host_array``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import HybridLM, _groups
from repro_torch.models.layers import torch_dtype
from repro_torch.models.ssm_lm import MambaLM
from repro_torch.models.transformer import (Transformer, ffn_group,
                                            superblock_slot)
from repro_torch.train.checkpoint import host_array, tensor_from_host

# leaves that stay f32 in a bf16 model, by family: Mamba1's
# (``ssm.mamba1_init``), Mamba2's (``ssm.mamba2_init``) and an MoE layer's
# router and shared gate (``moe.moe_init``)
F32_LEAVES = {"ssm": ("A_log", "D"), "hybrid": ("A_log", "D", "dt_bias"),
              "moe": ("router", "shared_gate")}
# the stacks of each transformer family, under ``blocks``
GROUPS = {"dense": ("attn", "mlp"), "vlm": ("attn", "mlp"),
          "moe": ("attn", "moe", "mlp_dense")}


def _set(tree: dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _leaves(tree: dict, prefix=()):
    """(key path, leaf) of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _stacks(cfg) -> dict:
    """The port's per-layer stacks (its top-level ``nn.ModuleList`` names)
    and each one's number of layers."""
    if cfg.family == "audio":
        return {"encoder": cfg.n_encoder_layers, "decoder": cfg.n_layers}
    return {"layers": cfg.n_layers}


def _flat(cfg) -> bool:
    """Whether every leaf of a stack has the same leading axes in the JAX
    layout, under the stack's own name: (n_layers,) for the SSM LM's
    ``layers`` and the encoder-decoder's ``encoder`` and ``decoder``, (G,
    P) for the hybrid's ``layers``; not the transformer's superblocks."""
    return cfg.family in ("ssm", "audio", "hybrid")


def _port_index(cfg, i: int) -> str:
    """Layer i's index in its port name: ``g.p`` in the hybrid's groups."""
    if cfg.family == "hybrid":
        return "%d.%d" % divmod(i, _groups(cfg)[1])
    return str(i)


def _split_name(cfg, name: str):
    """(stack, layer i, the rest of the name) of a per-layer port name, or
    None for any other (``embed.*``, ``final_norm``, ``shared.*``)."""
    parts = name.split(".")
    if parts[0] not in _stacks(cfg):
        return None
    n = 2 if cfg.family == "hybrid" else 1
    idx = [int(x) for x in parts[1:1 + n]]
    i = idx[0] * _groups(cfg)[1] + idx[1] if n == 2 else idx[0]
    return parts[0], i, tuple(parts[1 + n:])


def _layer_path(cfg, stack: str, rest: tuple) -> tuple:
    """The JAX key path of a per-layer leaf of port stack ``stack`` whose
    port name ends in ``rest`` (``("attn", "wq")``, ``("moe", "shared",
    "wg")``; an SSM layer's ``("A_log",)``)."""
    return (stack,) + rest if _flat(cfg) else ("blocks",) + rest


def _group_layers(cfg, stack: str, group: str) -> list:
    """The layers whose tensors the stack ``group`` holds, in stack order
    (``group``: a transformer stack; for a flat stack, any leaf)."""
    if _flat(cfg) or group == "attn":
        return list(range(_stacks(cfg)[stack]))
    return [i for i in range(cfg.n_layers) if ffn_group(cfg, i) == group]


def _stack_shape(cfg, stack: str, group: str) -> tuple:
    """The leading axes of the stack ``group`` in the JAX layout."""
    if cfg.family == "hybrid":
        return _groups(cfg)
    if _flat(cfg):
        return (_stacks(cfg)[stack],)
    period = cfg.moe_layer_period
    n_super = cfg.n_layers // period
    return {"attn": (n_super, period), "mlp_dense": (n_super, period - 1)
            }.get(group, (n_super,))


def _jax_index(cfg, group: str, i: int) -> tuple:
    """Layer i's index into the leading axes of the stack ``group``."""
    if cfg.family == "hybrid":
        return divmod(i, _groups(cfg)[1])
    if _flat(cfg):
        return (i,)
    sb, j = superblock_slot(cfg, i)
    return (sb, j) if group in ("attn", "mlp_dense") else (sb,)


def jax_ndim(name: str, p: torch.Tensor, cfg) -> int:
    """The number of dims of port tensor ``name``'s leaf in the JAX layout:
    the stacked axes added to a per-layer tensor's own."""
    split = _split_name(cfg, name)
    if split is None:
        return p.dim()
    stack, _, rest = split
    return p.dim() + len(_stack_shape(cfg, stack, rest[0]))


def decayed_names(named: dict, cfg) -> set:
    """The names AdamW decays: those whose JAX leaf has ``ndim >= 2``
    (``src/repro/train/optimizer.py::_is_matrix``).  Every per-layer tensor
    is one, norms included; ``final_norm`` (and the encoder-decoder's
    ``enc_norm``, the hybrid's unstacked ``shared`` norms) is not."""
    return {k for k, p in named.items() if jax_ndim(k, p, cfg) >= 2}


def jax_tree(named: dict, cfg) -> dict:
    """``named`` (port name -> tensor: a model's parameters, or AdamW
    moments under the same names) as a nested dict in the JAX layout,
    per-layer tensors stacked into new tensors on their device."""
    out, per_layer = {}, {}
    for name, t in named.items():
        split = _split_name(cfg, name)
        if split is None:
            _set(out, name.split("."), t)
        else:
            stack, i, rest = split
            per_layer.setdefault((stack,) + rest, {})[i] = t
    for (stack, *rest), by_layer in per_layer.items():
        want = _group_layers(cfg, stack, rest[0])
        if sorted(by_layer) != want:
            raise ValueError(f"{stack}.{'.'.join(rest)}: layers "
                             f"{sorted(by_layer)} for {want}")
        stacked = torch.stack([by_layer[i] for i in want])
        stacked = stacked.reshape(_stack_shape(cfg, stack, rest[0])
                                  + stacked.shape[1:])
        _set(out, _layer_path(cfg, stack, tuple(rest)), stacked)
    return out


def named_from_jax(tree: dict, cfg) -> dict:
    """Inverse of :func:`jax_tree`: port name -> that layer's slice of the
    JAX leaf (numpy arrays or tensors, as given)."""
    named = {f"embed.{k}": a for k, a in tree["embed"].items()}
    stacks = _stacks(cfg)
    if _flat(cfg):
        # (port stack, key path prefix, JAX stack): the leaf names follow
        parts = [(s, (), tree[s]) for s in stacks]
    else:
        blocks = tree["blocks"]
        want = {g for g in GROUPS.get(cfg.family, ())
                if _group_layers(cfg, "layers", g)}
        if set(blocks) != want:
            raise NotImplementedError(
                f"blocks {sorted(blocks)}: a {cfg.family!r} stack of "
                f"{cfg.n_layers} layers in superblocks of "
                f"{cfg.moe_layer_period} converts from {sorted(want)}")
        parts = [("layers", (g,), blk) for g, blk in blocks.items()]
    jax_stacks = ("blocks",) if not _flat(cfg) else tuple(stacks)
    for k, a in tree.items():
        if k == "embed" or k in jax_stacks:
            continue
        if isinstance(a, dict):                 # the hybrid's shared block
            named.update((".".join(path), leaf)
                         for path, leaf in _leaves(a, (k,)))
        else:
            named[k] = a                        # final_norm, enc_norm
    for stack, prefix, leaves in parts:
        for path, a in _leaves(leaves, prefix):
            lead = _stack_shape(cfg, stack, path[0])
            if tuple(np.shape(a)[:len(lead)]) != lead:
                raise ValueError(f"{'/'.join(path)}: leading axes "
                                 f"{tuple(np.shape(a)[:len(lead)])}, not "
                                 f"{lead}")
            for i in _group_layers(cfg, stack, path[0]):
                named[".".join((stack, _port_index(cfg, i)) + path)] = \
                    a[_jax_index(cfg, path[0], i)]
    return named


def _unflatten(flat: dict) -> dict:
    """``{"shared.wg": t}`` -> ``{"shared": {"wg": t}}``."""
    out = {}
    for k, v in flat.items():
        _set(out, k.split("."), v)
    return out


def params_from_jax(tree: dict, cfg, device=None, dtype=None):
    """``tree``: the JAX ``init`` params as nested dicts of numpy arrays (or
    tensors) under the JAX key paths.  Returns the port's model on
    ``device``, in ``dtype`` (default: the arrays' own dtype; the leaves of
    ``F32_LEAVES`` stay f32), its parameters carrying no gradient."""
    dt = None if dtype is None else torch_dtype(dtype)
    keep = F32_LEAVES.get(cfg.family, ())

    def t(name, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            x = a.detach().to(device, copy=True)
        else:
            x = tensor_from_host(a, device=device)     # a writable copy
        keep_f32 = name.rsplit(".", 1)[-1] in keep
        return x if dt is None or keep_f32 else x.to(dt)

    named = {k: t(k, a) for k, a in named_from_jax(tree, cfg).items()}
    embed = {k.split(".", 1)[1]: v for k, v in named.items()
             if k.startswith("embed.")}

    def layer(prefix):
        return _unflatten({k[len(prefix):]: v for k, v in named.items()
                           if k.startswith(prefix)})

    def stack(name):
        return [layer(f"{name}.{i}.") for i in range(_stacks(cfg)[name])]

    if cfg.family == "ssm":
        return MambaLM(cfg, embed, named["final_norm"], stack("layers"))
    if cfg.family == "hybrid":
        g, p = _groups(cfg)
        return HybridLM(cfg, embed, named["final_norm"], layer("shared."),
                        [[layer(f"layers.{i}.{j}.") for j in range(p)]
                         for i in range(g)])
    if cfg.family == "audio":
        return EncDec(cfg, embed, named["enc_norm"], named["final_norm"],
                      stack("encoder"), stack("decoder"))
    return Transformer(cfg, embed, named["final_norm"],
                       [(layer(f"layers.{i}.attn."),
                         layer(f"layers.{i}.{ffn_group(cfg, i)}."))
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
