"""Carry weights and optimizer state between the JAX package and the port.

The JAX package holds a model as nested dicts (``params``,
``batch_stats``) of arrays named by Flax; the port holds an
``nn.Module`` whose submodules carry the same names. How a leaf maps
depends on the kind of the port's module that holds it, never on the
leaf's rank (GPT's QKV kernel is 4-D and no convolution):

- ResNet ``Conv``: ``weight`` OIHW ↔ ``kernel`` HWIO;
- ``nn.Linear``: ``weight`` ``[out, in]`` ↔ ``kernel`` ``[in, out]``;
- ResNet ``BatchNorm``: ``weight`` ↔ ``scale``, ``bias`` ↔ ``bias``, and
  ``running_mean``/``running_var`` ↔ ``batch_stats`` ``mean``/``var``;
- MoE ``ExpertMlp`` (``w1``, ``b1``, ``w2``, ``b2``, ``[E, ...]``): the
  leaf as it is, or, once ``moe.shard_experts_`` has cut the experts over
  an expert group, this expert rank's contiguous block of E from the Flax
  leaf (the other way the port's tensor goes as it is: gather first);
- every other module (the GPT's, the MoE models' and ViT's, which keep the
  Flax names and layouts: ``kernel``, ``bias``, ``scale``, ``embedding``,
  ``pos_embed``, ``Dense_0``, ``LayerNorm_0``; ViT's q/k/v ``DenseGeneral``
  kernels ``[d, H, hd]``, ``out`` ``[H, hd, d]``, the HWIO patch conv,
  ``cls_token``): the leaf as it is.

The JAX pipeline stacks the decoder blocks into one ``blocks`` tree with a
leading layer dim in its storage order (``circular_layer_order``):
:func:`unstack_blocks` gives them back their per-layer names (JAX's
``unstack_block_params``), and :func:`load_flax_pipeline` and
:func:`flax_pipeline_tree_to_named` carry them into the port's model,
whole or one pipeline stage (a ``PipelinedLM`` holds its layers' blocks
under those names), the parameters and Adam's moments alike.

A tree from JAX's ``serving/quantize.py::quantize_params`` holds
``QuantizedTensor`` leaves (``q`` int8 and ``scale`` float32):
:func:`flax_to_serving_params` carries them, as the port's
``QuantizedTensor``, into the parameter set the serving engine installs
(``serving/quantize.py::install_params``).

Everything goes through numpy, so this module imports neither framework's
other half: the tests hand it ``jax.device_get`` output.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from distributed_training_tpu_torch.models.moe import ExpertMlp
from distributed_training_tpu_torch.models.resnet import BatchNorm, Conv
from distributed_training_tpu_torch.serving.quantize import QuantizedTensor

_STAT_NAMES = {"running_mean": "mean", "running_var": "var"}


def _same(x: np.ndarray) -> np.ndarray:
    return x


class _Rule(NamedTuple):
    collection: str          # "params" | "batch_stats"
    path: tuple              # the leaf's path in that Flax tree
    to_torch: Callable[[np.ndarray], np.ndarray]
    to_flax: Callable[[np.ndarray], np.ndarray]


def _rule(module: nn.Module, prefix: tuple, leaf: str) -> _Rule:
    if isinstance(module, Conv) and leaf == "weight":
        return _Rule("params", (*prefix, "kernel"),
                     lambda x: x.transpose(3, 2, 0, 1),
                     lambda x: x.transpose(2, 3, 1, 0))
    if isinstance(module, nn.Linear) and leaf == "weight":
        return _Rule("params", (*prefix, "kernel"), lambda x: x.T, lambda x: x.T)
    if isinstance(module, BatchNorm):
        if leaf == "weight":
            return _Rule("params", (*prefix, "scale"), _same, _same)
        if leaf in _STAT_NAMES:
            return _Rule("batch_stats", (*prefix, _STAT_NAMES[leaf]), _same, _same)
    if isinstance(module, ExpertMlp) and module.ep is not None:
        n = getattr(module, leaf).shape[0]
        lo = module.ep.index * n
        return _Rule("params", (*prefix, leaf), lambda x: x[lo:lo + n], _same)
    return _Rule("params", (*prefix, leaf), _same, _same)


def _rules(model: nn.Module) -> dict[str, _Rule]:
    """Every parameter and buffer of ``model`` by name, with its rule."""
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        leaves = [n for n, _ in mod.named_parameters(recurse=False)]
        leaves += [n for n, _ in mod.named_buffers(recurse=False)]
        leaves += [n for n, v in vars(mod).items() if isinstance(v, QuantizedTensor)]
        for leaf in leaves:
            out[".".join((*prefix, leaf))] = _rule(mod, prefix, leaf)
    return out


def _flatten(tree: Any, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        # JAX's QuantizedTensor: its two arrays, as a pair.
        return {prefix: (np.asarray(tree.q), np.asarray(tree.scale))}
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _nest(flat: dict[tuple, np.ndarray]) -> dict:
    out: dict = {}
    for path, x in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def _from_trees(model: nn.Module, trees: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The port's tensors for the leaves of ``trees`` (by collection);
    the Flax trees and the model must cover the same leaves."""
    flat = {c: _flatten(t) for c, t in trees.items()}
    out, used = {}, {c: set() for c in trees}
    for name, rule in _rules(model).items():
        if rule.collection not in trees:
            continue
        x = flat[rule.collection].get(rule.path)
        if x is None:
            raise KeyError(f"Flax {rule.collection} has no {'/'.join(rule.path)} "
                           f"for the port's {name}")
        used[rule.collection].add(rule.path)
        if isinstance(x, tuple):
            out[name] = QuantizedTensor(*(torch.from_numpy(np.array(rule.to_torch(a)))
                                          for a in x))
        else:
            out[name] = torch.from_numpy(np.array(rule.to_torch(x)))
    for c, leaves in flat.items():
        extra = set(leaves) - used[c]
        if extra:
            raise KeyError(f"Flax {c} leaves the port's model lacks: "
                           f"{sorted('/'.join(p) for p in extra)}")
    return out


def _to_trees(model: nn.Module, named: dict[str, torch.Tensor]) -> dict[str, dict]:
    rules = _rules(model)
    flat: dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in named.items():
        rule = rules[name]
        x = rule.to_flax(t.detach().cpu().numpy())
        flat[rule.collection][rule.path] = np.ascontiguousarray(x)
    return {c: _nest(f) for c, f in flat.items()}


def flax_to_state_dict(model: nn.Module, params: Any,
                       batch_stats: Any = None) -> dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` for Flax ``params`` and ``batch_stats``
    (None: the buffers are left out)."""
    trees = {"params": params}
    if batch_stats is not None:
        trees["batch_stats"] = batch_stats
    return _from_trees(model, trees)


def state_dict_to_flax(model: nn.Module,
                       state_dict: dict[str, torch.Tensor] | None = None
                       ) -> tuple[dict, dict]:
    """``(params, batch_stats)`` as nested numpy dicts with Flax names, of
    ``state_dict`` (default: the model's own)."""
    trees = _to_trees(model, model.state_dict() if state_dict is None else state_dict)
    return trees["params"], trees["batch_stats"]


def flax_tree_to_named(model: nn.Module, tree: Any) -> dict[str, torch.Tensor]:
    """A param-shaped Flax tree (e.g. Adam's ``mu``) keyed by the port's
    parameter names, in the port's layouts."""
    return _from_trees(model, {"params": tree})


def named_to_flax_tree(model: nn.Module, named: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_tree_to_named`."""
    return _to_trees(model, named)["params"]


def flax_to_serving_params(model: nn.Module, params: Any) -> dict[str, Any]:
    """The serving engine's parameter set for a Flax ``params`` tree, JAX's
    quantized leaves included (each a port ``QuantizedTensor`` of the same
    codes and scales); install it with ``serving.quantize.install_params``."""
    return _from_trees(model, {"params": params})


def load_flax_variables(model: nn.Module, params: Any,
                        batch_stats: Any = None) -> None:
    """Copy Flax variables into ``model`` in place (strict: every
    parameter and buffer must be covered)."""
    model.load_state_dict(flax_to_state_dict(model, params, batch_stats),
                          strict=True)


def load_flax_adam_state(model: nn.Module, opt_state, count: int, mu: Any,
                         nu: Any) -> None:
    """Copy a JAX ``FusedAdamState`` (``count``, ``mu``, ``nu``) or an optax
    ``ScaleByAdamState`` of ``model``'s parameters into the port's
    ``OptState``."""
    opt_state.set_count(count)
    for src, dst in ((mu, opt_state.mu), (nu, opt_state.nu)):
        for name, t in flax_tree_to_named(model, src).items():
            dst[name].copy_(t)


def named_to_flax_stats(model: nn.Module, named: dict[str, torch.Tensor]) -> dict:
    """BatchNorm statistics keyed by the port's buffer names (e.g. the
    ``ema_stats`` slot) as a Flax ``batch_stats`` tree."""
    return _to_trees(model, named)["batch_stats"]


def _optax_parts(state) -> list:
    """The leaf states of an optax chain (nested tuples), outermost first."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return [p for s in state for p in _optax_parts(s)]
    if hasattr(state, "ema_params"):  # EmaState: its own fields, then inner
        return [state, *_optax_parts(state.inner)]
    return [state]


def load_optax_state(model: nn.Module, opt_state, jax_state) -> None:
    """Copy the JAX optimizer state of ``model``'s parameters (after
    ``jax.device_get``) into the port's ``OptState``, by the fields of the
    chain's states: ``mu``/``nu`` (optax ``ScaleByAdamState``, the fused
    ``FusedAdamState``), ``trace`` (``TraceState``), ``ema_params`` and
    ``ema_batch_stats`` (``EmaState``); the count from the first state
    that has one. Every slot of ``opt_state`` must be covered."""
    slots = opt_state.slots
    covered = set()
    count = None
    for part in _optax_parts(jax_state):
        fields = getattr(part, "_fields", ())
        if count is None and "count" in fields:
            count = int(part.count)
        trees = {}
        if "mu" in fields and "nu" in fields:
            trees = {"mu": part.mu, "nu": part.nu}
        elif "trace" in fields:
            trees = {"trace": part.trace}
        elif "ema_params" in fields:
            trees = {"ema": part.ema_params}
            if "ema_stats" in slots:
                for name, t in _from_trees(
                        model, {"batch_stats": part.ema_batch_stats}).items():
                    slots["ema_stats"][name].copy_(t)
                covered.add("ema_stats")
        for slot, tree in trees.items():
            for name, t in flax_tree_to_named(model, tree).items():
                slots[slot][name].copy_(t)
            covered.add(slot)
    if covered != set(slots):
        raise ValueError(f"the JAX state covers slots {sorted(covered)}, the "
                         f"port's has {sorted(slots)}")
    opt_state.set_count(0 if count is None else count)


def unstack_blocks(tree: Any, layer_order) -> dict:
    """A JAX pipeline tree (``blocks`` stacked in the storage order
    ``layer_order``, beside the other leaves) as the plain model's tree:
    storage row ``i`` becomes ``block{layer_order[i]}``."""
    flat = _flatten(tree["blocks"])
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for row, layer in enumerate(layer_order):
        out[f"block{layer}"] = _nest({path: x[row] for path, x in flat.items()})
    return out


def _held(model: nn.Module, tree: dict) -> dict:
    """``tree`` without the blocks that ``model`` (a pipeline stage) lacks."""
    mods = dict(model.named_children())
    return {k: v for k, v in tree.items() if not k.startswith("block") or k in mods}


def load_flax_pipeline(model: nn.Module, params: Any, layer_order) -> None:
    """Copy JAX pipeline parameters (see :func:`unstack_blocks`) into
    ``model``, a whole ``TransformerLM`` or a pipeline stage (its blocks)."""
    load_flax_variables(model, _held(model, unstack_blocks(params, layer_order)))


def flax_pipeline_tree_to_named(model: nn.Module, tree: Any, layer_order) -> dict:
    """A JAX pipeline param-shaped tree (e.g. Adam's ``mu``) keyed by
    ``model``'s parameter names (:func:`load_flax_pipeline`'s blocks)."""
    return flax_tree_to_named(model, _held(model, unstack_blocks(tree, layer_order)))
