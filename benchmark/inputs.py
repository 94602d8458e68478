"""The inputs of a run, made from ``--seed``: weights and token batches.

Both sides of the comparison get these same tensors: the program through
its ``build`` and the plain reference directly. They are made on the
device, in a few large calls, in the model's dtype.

The weights' leaves, their shapes and their scales are the program's
``groups(dims)``: (group tag, [(leaf name, shape, std or None for ones)])
in the order the leaves are drawn. Each group has a generator of its own,
seeded from (seed, group), so any one group can be made again alone.

Tokens come from the one traffic generator, :func:`token_pool`, reading
a traffic file's parameters: ``pool`` batches of ``batch`` x ``seq`` ids
drawn from a Zipf law of exponent ``zipf_exponent`` over the vocabulary
(id k-1 has weight 1/k^s). Every seed gives the same sizes; only the ids
differ.
"""

from __future__ import annotations

import hashlib
import math

import torch

# A program's groups(dims): (tag, [(leaf name, shape, std or None)]).
Groups = list[tuple[str, list[tuple[str, tuple, float | None]]]]


def _seed(seed: int, tag: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_group(groups: Groups, dtype: torch.dtype, seed: int, tag: str,
               device) -> dict[str, torch.Tensor]:
    """The leaves of one group, drawn by one call of one generator."""
    leaves = dict(groups)[tag]
    dense = [(n, s, std) for n, s, std in leaves if std is not None]
    total = sum(math.prod(s) for _, s, _ in dense)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, tag))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, offset = {}, 0
    for name, shape, std in leaves:
        if std is None:
            out[name] = torch.ones(shape, device=device, dtype=dtype)
            continue
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    return out


def make_params(groups: Groups, dtype: torch.dtype, seed: int,
                device) -> dict[str, torch.Tensor]:
    params = {}
    for tag, _ in groups:
        params.update(make_group(groups, dtype, seed, tag, device))
    return params


def group_of(groups: Groups, name: str) -> str:
    """The tag of the group that holds leaf ``name``."""
    for tag, leaves in groups:
        if any(leaf == name for leaf, _, _ in leaves):
            return tag
    raise KeyError(f"no group holds leaf {name!r}")


def token_pool(traffic: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """[pool, batch, seq] int64 ids from the traffic's Zipf law."""
    n = traffic["pool"] * traffic["batch"] * traffic["seq"]
    ranks = torch.arange(1, vocab + 1, device=device, dtype=torch.float64)
    weights = ranks.pow(-float(traffic["zipf_exponent"]))
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    gen = torch.Generator(device=device).manual_seed(_seed(seed, "tokens"))
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    ids = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
    return ids.view(traffic["pool"], traffic["batch"], traffic["seq"])
