"""Carry the JAX package's parameters into the port.

``jaxcheck.model.init_params`` returns a pytree
``{"embed", "lm_head", "ln_f": {"g"}, "layers": [{"ln1": {"g"}, "wqkv",
"wo", "ln2": {"g"}, "w1", "w2"}, ...]}``. Given that tree with numpy leaves
(``jax.tree.map(np.asarray, params)``), :func:`params_from_jax` names each
leaf as :class:`~.model.Transformer` names its parameter, so the same
weights run through both packages. The MoE and pipeline parameters are
plain trees of tensors in both packages (``{"router", "w1", "w2"}``; a
list of ``{"w1", "w2"}`` layers or their stacked form), which
:func:`tensors_from_jax` carries across as they are.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(leaf) -> torch.Tensor:
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's comes from ml_dtypes):
        # carry the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def tensors_from_jax(np_tree: Any, device: str | torch.device = "cpu"
                     ) -> Any:
    """A tree of dicts, lists and numpy leaves (a JAX pytree through
    ``np.asarray``) as the same tree of tensors on ``device``."""
    if isinstance(np_tree, dict):
        return {k: tensors_from_jax(v, device) for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(tensors_from_jax(v, device) for v in np_tree)
    return _tensor(np_tree).to(device)


def params_from_jax(np_tree: dict[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX parameter pytree (numpy leaves) as a ``state_dict``."""
    state: dict[str, torch.Tensor] = {}

    def put(name: str, leaf) -> None:
        state[name] = _tensor(leaf)

    put("embed", np_tree["embed"])
    put("lm_head", np_tree["lm_head"])
    put("ln_f.g", np_tree["ln_f"]["g"])
    for i, layer in enumerate(np_tree["layers"]):
        for key in ("wqkv", "wo", "w1", "w2"):
            put(f"layers.{i}.{key}", layer[key])
        for norm in ("ln1", "ln2"):
            put(f"layers.{i}.{norm}.g", layer[norm]["g"])
    return state


def load_jax_params(model: torch.nn.Module,
                    np_tree: dict[str, Any]) -> torch.nn.Module:
    """Load the JAX pytree into ``model`` in place (cast to each
    parameter's dtype and device); every name and shape must match."""
    state = params_from_jax(np_tree)
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"parameter names differ: jax-only "
                         f"{sorted(set(state) - set(own))}, port-only "
                         f"{sorted(set(own) - set(state))}")
    for name, value in state.items():
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: jax shape {tuple(value.shape)} vs "
                             f"port shape {tuple(own[name].shape)}")
    model.load_state_dict(state)
    return model
