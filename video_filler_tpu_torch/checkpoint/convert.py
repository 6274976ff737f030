"""Map the JAX package's parameter trees to the port's state dicts and back.

A JAX tree nests dicts by layer name (``params["enc"]["conv0"]["w"]``); the
port's state-dict key is the dotted path with the leaf renamed:

    w -> weight    b -> bias (a conv's, useBias)
    gamma -> weight    beta -> bias (a BatchNorm's)
    mean -> running_mean (state)      var -> running_var (state)

A state-dict ``bias`` is a BatchNorm beta when its layer is a BatchNorm
(named ``bn*`` or ``*_bn``), else a conv bias ``b`` (``conv*``, ``up*``,
``noise``, ``ctx``, ``pred``).

Only the conv weights, leaf ``w``, change layout (ops/layers.py,
ops/layers3d.py); BN leaves and conv biases are 1-D and cross unchanged.  A conv weight
HWIO -> OIHW by ``transpose(3,2,0,1)``, and DHWIO -> OIDHW by
``transpose(4,3,0,1,2)``; a transposed conv, the layers named ``up*``,
(k,k,cin,cout) -> (cin,cout,k,k) by ``transpose(2,3,0,1)``, and
(kt,kh,kw,cin,cout) -> (cin,cout,kt,kh,kw) by ``transpose(3,4,0,1,2)``.
The same mappings are pinned by tests/test_step_golden.py,
tests/test_video3d.py and checkpoint/t7.py in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAF = {"w": "weight", "b": "bias", "gamma": "weight", "beta": "bias"}
_STATE_LEAF = {"mean": "running_mean", "var": "running_var"}

# JAX layout -> port layout of a conv weight, by (rank, transposed conv).
_TO_TORCH = {(4, False): (3, 2, 0, 1), (4, True): (2, 3, 0, 1),
             (5, False): (4, 3, 0, 1, 2), (5, True): (3, 4, 0, 1, 2)}


def _is_transposed(path: tuple[str, ...]) -> bool:
    return path[-2].startswith("up")


def _is_batch_norm(layer: str) -> bool:
    return layer.startswith("bn") or layer.endswith("_bn")


def _flatten(tree: dict, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _conv_perm(path: tuple[str, ...], ndim: int) -> tuple[int, ...]:
    """The permutation taking the conv weight at ``path`` from the JAX
    layout to the port's."""
    try:
        return _TO_TORCH[(ndim, _is_transposed(path))]
    except KeyError:
        raise ValueError(f"conv weight {'.'.join(path)} has {ndim} dims; "
                         "expected 4 (2-D) or 5 (3-D)") from None


def to_torch_layout(path: tuple[str, ...], w: np.ndarray) -> np.ndarray:
    """A JAX parameter leaf at ``path`` in the port's layout (a view)."""
    if path[-1] != "w":
        return w
    return w.transpose(_conv_perm(path, w.ndim))


def to_jax_layout(path: tuple[str, ...], w: np.ndarray) -> np.ndarray:
    """Inverse of ``to_torch_layout`` (a view)."""
    if path[-1] != "w":
        return w
    return w.transpose(tuple(int(i) for i in
                             np.argsort(_conv_perm(path, w.ndim))))


def jax_path(key: str, ndim: int) -> tuple[bool, tuple[str, ...]]:
    """(True for a BN running statistic, the leaf's path in the JAX params
    or state tree) for a state-dict key whose tensor has ``ndim`` dims.  A
    ``weight`` is a BN gamma when it is 1-D, a conv weight otherwise; a
    ``bias`` is a BN beta under a BatchNorm layer, a conv bias otherwise."""
    *scope, leaf = key.split(".")
    if leaf in ("running_mean", "running_var"):
        return True, (*scope, leaf[len("running_"):])
    if leaf == "bias":
        return False, (*scope, "beta" if _is_batch_norm(scope[-1]) else "b")
    if leaf == "weight":
        return False, (*scope, "gamma" if ndim == 1 else "w")
    raise KeyError(f"no JAX counterpart for state-dict key {key!r}")


def tree_to_state_dict(params: dict, state: dict | None = None
                       ) -> dict[str, torch.Tensor]:
    """One network's (params, BN state) trees -> its state dict (CPU f32)."""
    sd = {}
    for path, leaf in _flatten(params):
        name = _PARAM_LEAF[path[-1]]
        arr = to_torch_layout(path, np.asarray(leaf))
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
    params: dict = {}
    state: dict = {}
    for key, t in sd.items():
        arr = t.detach().float().cpu().numpy()
        is_state, path = jax_path(key, arr.ndim)
        if not is_state:
            arr = to_jax_layout(path, arr)
        node = state if is_state else params
        for s in path[:-1]:
            node = node.setdefault(s, {})
        node[path[-1]] = np.ascontiguousarray(arr)
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
