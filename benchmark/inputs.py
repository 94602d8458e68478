"""The inputs of a run, made from ``--seed``: weights and token batches.

Both sides of the comparison get these same tensors: the program through
``train.state_from_tree`` and the plain reference directly. They are made
on the device, in a few large calls, in the model's dtype.

Weights are drawn as the model draws them: N(0, 1/fan_in) dense layers,
0.02 embeddings, RMSNorm gains at 1. Each group of leaves (the embedding,
head and final norm; then each layer) has a generator of its own, seeded
from (seed, group), so any one group can be made again alone.

Tokens come from the one traffic generator, :func:`token_pool`, reading
a traffic file's parameters: ``pool`` batches of ``batch`` x ``seq`` ids
drawn from a Zipf law of exponent ``zipf_exponent`` over the vocabulary
(id k-1 has weight 1/k^s). Every seed gives the same sizes; only the ids
differ.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import torch


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    n_heads: int
    n_layers: int
    d_ff: int
    dtype: torch.dtype

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dims(config: dict) -> Dims:
    """The sizes of a configuration file (published ``config.json`` keys)."""
    return Dims(vocab=config["vocab_size"], d_model=config["hidden_size"],
                n_heads=config["num_attention_heads"],
                n_layers=config["num_hidden_layers"],
                d_ff=config["intermediate_size"],
                dtype=DTYPES[config["torch_dtype"]])


def _seed(seed: int, tag: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def groups(d: Dims) -> list[tuple[str, list[tuple[str, tuple, float | None]]]]:
    """(group tag, [(leaf name, shape, std or None for ones)]) in the order
    the leaves are drawn. Leaf names are the state tree's."""
    dm, h, hd, f = d.d_model, d.n_heads, d.head_dim, d.d_ff
    out = [("top", [("embed", (d.vocab, dm), 0.02),
                    ("lm_head", (dm, d.vocab), 1 / math.sqrt(dm)),
                    ("ln_f.g", (dm,), None)])]
    for i in range(d.n_layers):
        p = f"layers.{i}."
        out.append((f"layer{i}", [
            (p + "ln1.g", (dm,), None),
            (p + "wqkv", (dm, 3, h, hd), 1 / math.sqrt(dm)),
            (p + "wo", (h, hd, dm), 1 / math.sqrt(dm)),
            (p + "ln2.g", (dm,), None),
            (p + "w1", (dm, f), 1 / math.sqrt(dm)),
            (p + "w2", (f, dm), 1 / math.sqrt(f))]))
    return out


def make_group(d: Dims, seed: int, tag: str,
               device) -> dict[str, torch.Tensor]:
    """The leaves of one group, drawn by one call of one generator."""
    leaves = dict(groups(d))[tag]
    dense = [(n, s, std) for n, s, std in leaves if std is not None]
    total = sum(math.prod(s) for _, s, _ in dense)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, tag))
    flat = torch.randn(total, generator=gen, device=device, dtype=d.dtype)
    out, offset = {}, 0
    for name, shape, std in leaves:
        if std is None:
            out[name] = torch.ones(shape, device=device, dtype=d.dtype)
            continue
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    return out


def make_params(d: Dims, seed: int, device) -> dict[str, torch.Tensor]:
    params = {}
    for tag, _ in groups(d):
        params.update(make_group(d, seed, tag, device))
    return params


def group_of(name: str) -> str:
    if name.startswith("layers."):
        return f"layer{name.split('.')[1]}"
    return "top"


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
