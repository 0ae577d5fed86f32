"""Carry weights and optimizer state between the JAX package and the port.

The JAX package holds a model as nested dicts (``params``,
``batch_stats``) of arrays named by Flax; the port holds an
``nn.Module`` whose submodules carry the same names. The mapping, leaf by
leaf:

- conv ``kernel`` HWIO → ``weight`` OIHW;
- Dense ``kernel`` ``[in, out]`` → ``weight`` ``[out, in]``;
- BatchNorm ``scale``/``bias`` → ``weight``/``bias``;
- ``mean``/``var`` → ``running_mean``/``running_var``.

Everything goes through numpy, so this module imports neither framework's
other half: the tests hand it ``jax.device_get`` output.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}
_STAT_NAMES_BACK = {v: k for k, v in _STAT_NAMES.items()}


def _flatten(tree: Any, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _to_torch_leaf(path: tuple, x: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return ".".join([*mods, leaf]), x


def _to_flax_leaf(name: str, x: np.ndarray) -> tuple[tuple, np.ndarray]:
    *mods, leaf = name.split(".")
    if leaf == "weight":
        if x.ndim == 4:
            return (*mods, "kernel"), x.transpose(2, 3, 1, 0)
        if x.ndim == 2:
            return (*mods, "kernel"), x.T
        return (*mods, "scale"), x
    return (*mods, leaf), x


def _nest(flat: dict[tuple, np.ndarray]) -> dict:
    out: dict = {}
    for path, x in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return out


def flax_to_state_dict(params: Any, batch_stats: Any = None) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for Flax ``params`` and ``batch_stats``."""
    sd = flax_tree_to_named(params)
    for path, x in _flatten(batch_stats or {}).items():
        *mods, leaf = path
        sd[".".join([*mods, _STAT_NAMES[leaf]])] = torch.from_numpy(np.array(x))
    return sd


def state_dict_to_flax(state_dict: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """``(params, batch_stats)`` as nested numpy dicts with Flax names."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf in _STAT_NAMES_BACK:
            stats[(*mods, _STAT_NAMES_BACK[leaf])] = t.detach().cpu().numpy()
        else:
            params[name] = t
    return named_to_flax_tree(params), _nest(stats)


def flax_tree_to_named(tree: Any) -> dict[str, torch.Tensor]:
    """A param-shaped Flax tree (e.g. Adam's ``mu``) keyed by the port's
    parameter names, in the port's layouts."""
    out = {}
    for path, x in _flatten(tree).items():
        name, y = _to_torch_leaf(path, x)
        out[name] = torch.from_numpy(np.array(y))
    return out


def named_to_flax_tree(named: dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`flax_tree_to_named`."""
    flat = {}
    for name, t in named.items():
        path, y = _to_flax_leaf(name, t.detach().cpu().numpy())
        flat[path] = np.ascontiguousarray(y)
    return _nest(flat)


def load_flax_variables(model: torch.nn.Module, params: Any,
                        batch_stats: Any = None) -> None:
    """Copy Flax variables into ``model`` in place (strict: every
    parameter and buffer must be covered)."""
    model.load_state_dict(flax_to_state_dict(params, batch_stats), strict=True)


def load_flax_adam_state(opt_state, count: int, mu: Any, nu: Any) -> None:
    """Copy a JAX ``FusedAdamState`` (``count``, ``mu``, ``nu``) or an optax
    ``ScaleByAdamState`` into the port's :class:`AdamState`."""
    opt_state.count = int(count)
    for src, dst in ((mu, opt_state.mu), (nu, opt_state.nu)):
        for name, t in flax_tree_to_named(src).items():
            dst[name].copy_(t)
