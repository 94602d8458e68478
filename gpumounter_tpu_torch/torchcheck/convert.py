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

:func:`train_state_from_jax` carries a whole JAX ``TrainState`` (params,
``optax.adamw`` state, step) into the port's :class:`~.train.TrainState`,
so both packages can start from one point of a trajectory, moments
included.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gpumounter_tpu_torch.torchcheck import dist as dist_lib
from gpumounter_tpu_torch.torchcheck import model as model_lib
from gpumounter_tpu_torch.torchcheck import train as train_lib


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


def state_tree_from_jax(np_state) -> dict:
    """A JAX ``TrainState(params, opt_state, step)`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) as the port's state tree
    (``train`` module docstring), whole tensors on the CPU.

    The JAX optimizer is ``optax.adamw`` (``jaxcheck/train.py:40-41``): a
    chain whose first state is ``ScaleByAdamState(count, mu, nu)``. Its
    ``mu`` and ``nu`` become torch AdamW's ``exp_avg`` and ``exp_avg_sq``,
    and its one ``count`` every parameter's ``step``: both libraries bias-
    correct with the count of updates taken so far plus one."""
    adam = np_state.opt_state[0]
    if not all(hasattr(adam, key) for key in ("count", "mu", "nu")):
        raise ValueError(f"expected optax.adamw's state, whose first "
                         f"element is ScaleByAdamState; got {type(adam)}")
    params = params_from_jax(np_state.params)
    mu, nu = params_from_jax(adam.mu), params_from_jax(adam.nu)
    count = float(np.asarray(adam.count))
    return {"params": params,
            "opt": {name: {"exp_avg": mu[name], "exp_avg_sq": nu[name],
                           "step": torch.tensor(count)}
                    for name in params},
            "step": int(np.asarray(np_state.step))}


def train_state_from_jax(np_state, cfg: model_lib.ModelConfig,
                         device: str | torch.device = "cuda", mesh=None,
                         lr: float = 3e-4) -> train_lib.TrainState:
    """The JAX ``TrainState`` (numpy leaves) as the port's, on ``device``
    with AdamW at ``lr``; with ``mesh`` every rank keeps its shard of the
    parameters and of their moments (the Megatron split)."""
    tree = state_tree_from_jax(np_state)
    if mesh is not None:
        specs = model_lib.param_shardings(cfg)
        for name, spec in specs.items():
            tree["params"][name] = dist_lib.shard(tree["params"][name],
                                                  mesh, spec)
            for key in ("exp_avg", "exp_avg_sq"):
                tree["opt"][name][key] = dist_lib.shard(
                    tree["opt"][name][key], mesh, spec)
    return train_lib.state_from_tree(cfg, tree, device, lr)
