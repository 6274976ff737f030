"""Map the JAX package's parameter trees to the port's state dicts and back.

A JAX tree nests dicts by layer name (``params["enc"]["conv0"]["w"]``); the
port's state-dict key is the dotted path with the leaf renamed:

    w -> weight    gamma -> weight    beta -> bias
    mean -> running_mean (state)      var -> running_var (state)

Weights change layout (ops/layers.py): a conv weight HWIO -> OIHW by
``transpose(3,2,0,1)``; a transposed conv, the layers named ``up*``,
(k,k,cin,cout) -> (cin,cout,k,k) by ``transpose(2,3,0,1)``.  The same
mappings are pinned by tests/test_step_golden.py and checkpoint/t7.py in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAF = {"w": "weight", "gamma": "weight", "beta": "bias"}
_STATE_LEAF = {"mean": "running_mean", "var": "running_var"}


def _is_transposed(path: tuple[str, ...]) -> bool:
    return path[-2].startswith("up")


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_weight(path, w: np.ndarray) -> np.ndarray:
    if w.ndim != 4:
        return w
    return w.transpose(2, 3, 0, 1) if _is_transposed(path) \
        else w.transpose(3, 2, 0, 1)


def _to_jax_weight(path, w: np.ndarray) -> np.ndarray:
    if w.ndim != 4:
        return w
    return w.transpose(2, 3, 0, 1) if _is_transposed(path) \
        else w.transpose(2, 3, 1, 0)


def tree_to_state_dict(params: dict, state: dict | None = None
                       ) -> dict[str, torch.Tensor]:
    """One network's (params, BN state) trees -> its state dict (CPU f32)."""
    sd = {}
    for path, leaf in _flatten(params):
        name = _PARAM_LEAF[path[-1]]
        arr = _to_torch_weight(path, np.asarray(leaf))
        sd[".".join(path[:-1] + (name,))] = torch.tensor(
            arr, dtype=torch.float32)
    for path, leaf in _flatten(state or {}):
        name = _STATE_LEAF[path[-1]]
        sd[".".join(path[:-1] + (name,))] = torch.tensor(
            np.asarray(leaf), dtype=torch.float32)
    return sd


def state_dict_to_tree(sd: dict[str, torch.Tensor]) -> tuple[dict, dict]:
    """Inverse of ``tree_to_state_dict``: (params, state) nested numpy dicts.
    Also maps a dict of parameter gradients keyed like the parameters."""
    inv_param = {"weight": None, "bias": "beta"}
    params: dict = {}
    state: dict = {}
    for key, t in sd.items():
        *scope, leaf = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf in ("running_mean", "running_var"):
            tree, jleaf = state, leaf[len("running_"):]
        elif leaf in inv_param:
            tree = params
            jleaf = inv_param[leaf] or ("w" if arr.ndim == 4 else "gamma")
            arr = _to_jax_weight(tuple(scope) + (jleaf,), arr)
        else:
            raise KeyError(f"no JAX counterpart for state-dict key {key!r}")
        node = tree
        for s in scope:
            node = node.setdefault(s, {})
        node[jleaf] = np.ascontiguousarray(arr)
    return params, state


def from_jax(params_g: dict, state_g: dict, params_d: dict, state_d: dict
             ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """JAX (params, BN state) trees of G and D -> the port's (G, D) state
    dicts, running statistics included."""
    return (tree_to_state_dict(params_g, state_g),
            tree_to_state_dict(params_d, state_d))


def to_jax(sd_g: dict[str, torch.Tensor], sd_d: dict[str, torch.Tensor]
           ) -> tuple[dict, dict, dict, dict]:
    """Inverse of ``from_jax``: (params_g, state_g, params_d, state_d)."""
    params_g, state_g = state_dict_to_tree(sd_g)
    params_d, state_d = state_dict_to_tree(sd_d)
    return params_g, state_g, params_d, state_d
