"""Plain float32 reference of the decoder LM's training step.

The model's equations, written from its description and from nothing of
the program: token embedding plus fixed sinusoidal positions (sin over the
first half of the width, cos over the second, angle p / 10000^(2i/d));
per layer, x + Wo . attn(RMSNorm(x)) then x + W2 . gelu_tanh(W1 .
RMSNorm(x)), where attention is causal softmax(q k^T / sqrt(head_dim)) v
over the heads of Wqkv; a final RMSNorm and an untied head; next-token
cross-entropy, the mean over every (row, position) but the last; then
AdamW (decoupled weight decay, bias-corrected moments) on every leaf.

The configuration states the dtype of the training state (``torch_dtype``:
parameters and both AdamW moments). Between steps this reference keeps
each of them as a value of that dtype; every operation in a step runs in
float32 with TF32 off. So a parameter moves exactly as far as the stated
dtype can hold, and no farther.

It computes layer by layer: a forward pass keeps only each layer's input,
and the backward pass recomputes one layer at a time, then updates that
layer's leaves. Attention runs in blocks of query rows against the keys
up to the block's end, with its backward written out, so no [T, T] tensor
for all heads is ever held.

``precision="fp8"`` is the control: the same step with the operands of
every matrix product rounded to float8 with a per-tensor scale (e4m3 for
weights and activations, e5m2 for gradients), as an fp8 training recipe
computes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0),
        "e5m2": (torch.float8_e5m2, 57344.0)}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# Elements of one block of attention scores ([heads, rows, keys], f32).
BLOCK_ELEMENTS = 1 << 27
Q_BLOCK = 2048


class Numerics:
    """Where the matrix products round: nowhere (``"fp32"``) or to float8
    (``"fp8"``)."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def q(self, x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
        if not self.fp8:
            return x
        dtype, top = _FP8[fmt]
        scale = top / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(dtype).float() / scale

    def mm(self, a, b, fmt_a: str = "e4m3", fmt_b: str = "e4m3"):
        return torch.matmul(self.q(a, fmt_a), self.q(b, fmt_b))


class _Matmul(torch.autograd.Function):
    """a [M, K] @ b [K, N] whose forward and backward products round as
    ``num`` says."""

    @staticmethod
    def forward(ctx, a, b, num):
        ctx.save_for_backward(a, b)
        ctx.num = num
        return num.mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        num = ctx.num
        return (num.mm(g, b.t(), "e5m2", "e4m3"),
                num.mm(a.t(), g, "e4m3", "e5m2"), None)


def _blocks(b: int, t: int, h: int):
    """(batch row, head slice, first query row, end row) covering all."""
    rows = min(t, Q_BLOCK)
    heads = max(1, min(h, BLOCK_ELEMENTS // (rows * t)))
    for bi in range(b):
        for h0 in range(0, h, heads):
            for r0 in range(0, t, rows):
                yield bi, slice(h0, min(h, h0 + heads)), r0, min(t, r0 + rows)


def _scores(num, qs, ks, r0: int, r1: int, scale: float):
    """Causal scores [h, r1 - r0, r1] of query rows r0..r1 against keys
    0..r1, future keys at -inf (only the last r1 - r0 keys hold any)."""
    s = num.mm(qs, ks.transpose(1, 2)).mul_(scale)
    rows = torch.arange(r1 - r0, device=qs.device)
    s[..., r0:].masked_fill_(rows[None, :] > rows[:, None], float("-inf"))
    return s


def _attention(q, k, v, num):
    """(o [B, T, H, D], lse [B, H, T]) of causal attention, f32."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    for bi, hs, r0, r1 in _blocks(b, t, h):
        qs = q[bi, r0:r1, hs].transpose(0, 1)
        ks = k[bi, :r1, hs].transpose(0, 1)
        vs = v[bi, :r1, hs].transpose(0, 1)
        s = _scores(num, qs, ks, r0, r1, scale)
        lse_blk = torch.logsumexp(s, dim=-1)
        p = s.sub_(lse_blk[..., None]).exp_()
        o[bi, r0:r1, hs] = num.mm(p, vs).transpose(0, 1)
        lse[bi, hs, r0:r1] = lse_blk
    return o, lse


class _Attention(torch.autograd.Function):
    """Causal attention [B, T, H, D] (f32) -> [B, T, H, D]. ``cache`` (a
    dict, or None) keeps the forward's result between a layer's first
    pass and its recompute in the backward pass, where it is taken."""

    @staticmethod
    def forward(ctx, q, k, v, num, cache):
        if cache is not None and "o" in cache:
            o, lse = cache.pop("o"), cache.pop("lse")
        else:
            o, lse = _attention(q, k, v, num)
            if cache is not None:
                cache.update(o=o, lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num = num
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        num = ctx.num
        b, t, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        delta = (do * o).sum(dim=-1)                        # [B, T, H]
        dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
        for bi, hs, r0, r1 in _blocks(b, t, h):
            qs = q[bi, r0:r1, hs].transpose(0, 1)
            ks = k[bi, :r1, hs].transpose(0, 1)
            vs = v[bi, :r1, hs].transpose(0, 1)
            dos = do[bi, r0:r1, hs].transpose(0, 1)
            p = _scores(num, qs, ks, r0, r1, scale)
            p.sub_(lse[bi, hs, r0:r1][..., None]).exp_()
            dv[bi, :r1, hs] += num.mm(p.transpose(1, 2), dos,
                                      "e4m3", "e5m2").transpose(0, 1)
            ds = num.mm(dos, vs.transpose(1, 2), "e5m2", "e4m3")
            ds.sub_(delta[bi, r0:r1, hs].t()[..., None]).mul_(p)
            del p
            dq[bi, r0:r1, hs] = (num.mm(ds, ks, "e5m2", "e4m3")
                                 .mul_(scale).transpose(0, 1))
            dk[bi, :r1, hs] += (num.mm(ds.transpose(1, 2), qs, "e5m2", "e4m3")
                                .mul_(scale).transpose(0, 1))
        return dq, dk, dv, None, None


def positions(t: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    angle = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


class Reference:
    """One configuration's model, its stored training state and its step.

    ``params`` maps the state tree's leaf names (``embed``, ``lm_head``,
    ``ln_f.g``, ``layers.{i}.{ln1.g, wqkv, wo, ln2.g, w1, w2}``) to the
    initial values; they are copied, never written."""

    def __init__(self, config: dict, params: dict[str, torch.Tensor],
                 precision: str = "fp32"):
        self.num = Numerics(precision)
        self.d = config["hidden_size"]
        self.h = config["num_attention_heads"]
        self.n_layers = config["num_hidden_layers"]
        self.eps = float(config["layer_norm_eps"])
        train = config["training"]
        self.lr = float(train["lr"])
        self.betas = tuple(float(b) for b in train["betas"])
        self.adam_eps = float(train["eps"])
        self.wd = float(train["weight_decay"])
        dtype = _DTYPES[config["torch_dtype"]]
        self.p = {n: x.detach().to(dtype).clone() for n, x in params.items()}
        self.m = {n: torch.zeros_like(x) for n, x in self.p.items()}
        self.v = {n: torch.zeros_like(x) for n, x in self.p.items()}
        self.t = 0
        self.grad_norms: dict[str, float] = {}

    # -- the model ----------------------------------------------------------

    def _w(self, name: str, grad: bool) -> torch.Tensor:
        return self.p[name].to(torch.float32, copy=True).requires_grad_(grad)

    def _linear(self, x, w):
        """x [..., K] @ w [K, N] through the numerics."""
        lead = x.shape[:-1]
        out = _Matmul.apply(x.reshape(-1, x.shape[-1]), w, self.num)
        return out.view(*lead, w.shape[-1])

    def _rmsnorm(self, x, g):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * g

    def _layer(self, x, w: dict[str, torch.Tensor], cache: dict):
        b, t, d = x.shape
        qkv = self._linear(self._rmsnorm(x, w["ln1.g"]),
                           w["wqkv"].reshape(d, -1))
        q, k, v = qkv.view(b, t, 3, self.h, d // self.h).unbind(2)
        o = _Attention.apply(q, k, v, self.num, cache)
        x = x + self._linear(o.reshape(b, t, d), w["wo"].reshape(d, d))
        hid = F.gelu(self._linear(self._rmsnorm(x, w["ln2.g"]), w["w1"]),
                     approximate="tanh")
        return x + self._linear(hid, w["w2"])

    def _layer_weights(self, i: int, grad: bool) -> dict[str, torch.Tensor]:
        p = f"layers.{i}."
        return {n: self._w(p + n, grad)
                for n in ("ln1.g", "wqkv", "wo", "ln2.g", "w1", "w2")}

    # -- AdamW on the stored state -------------------------------------------

    def _update(self, name: str, g: torch.Tensor) -> None:
        if self.t == 1:
            self.grad_norms[name] = float(g.norm())
        b1, b2 = self.betas
        p, m, v = (s[name].to(torch.float32, copy=True)
                   for s in (self.p, self.m, self.v))
        p.mul_(1 - self.lr * self.wd)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** self.t)).add_(self.adam_eps)
        p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))
        self.p[name].copy_(p)
        self.m[name].copy_(m)
        self.v[name].copy_(v)

    # -- one step -----------------------------------------------------------

    def step(self, tokens: torch.Tensor) -> float:
        """One AdamW step on ``tokens`` [B, T]; returns the loss."""
        self.t += 1
        b, t = tokens.shape
        with torch.no_grad():
            x = (self.p["embed"].float()[tokens]
                 + positions(t, self.d, tokens.device)[None])
            inputs, caches = [x], [{} for _ in range(self.n_layers)]
            for i in range(self.n_layers):
                x = self._layer(x, self._layer_weights(i, False), caches[i])
                inputs.append(x)
        with torch.enable_grad():
            x_last = inputs.pop().requires_grad_(True)
            g_f, head = self._w("ln_f.g", True), self._w("lm_head", True)
            logits = self._linear(self._rmsnorm(x_last, g_f), head)
            loss = F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                tokens[:, 1:].reshape(-1))
            dx, dg, dh = torch.autograd.grad(loss, (x_last, g_f, head))
        del logits
        self._update("ln_f.g", dg)
        self._update("lm_head", dh)
        for i in reversed(range(self.n_layers)):
            x_in = inputs.pop().requires_grad_(True)
            w = self._layer_weights(i, True)
            with torch.enable_grad():
                out = self._layer(x_in, w, caches.pop())
                grads = torch.autograd.grad(out, (x_in, *w.values()), dx)
            dx = grads[0]
            for name, g in zip(w, grads[1:]):
                self._update(f"layers.{i}.{name}", g)
        g_embed = torch.zeros_like(self.p["embed"], dtype=torch.float32)
        g_embed.index_add_(0, tokens.reshape(-1), dx.reshape(-1, self.d))
        self._update("embed", g_embed)
        return float(loss.detach())


def train(config: dict, params: dict[str, torch.Tensor],
          batches: list[torch.Tensor], precision: str = "fp32") -> dict:
    """One AdamW step on each of ``batches`` from ``params``. Returns the
    readings the comparison needs: each step's loss, the first step's
    gradient norm of every leaf, and the norm of every leaf's change over
    all the steps."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = Reference(config, params, precision)
        losses = [ref.step(tokens) for tokens in batches]
        change = {n: float((ref.p[n].float() - params[n].float()).norm())
                  for n in ref.p}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return {"losses": losses, "grad_norms": ref.grad_norms,
            "change_norms": change}
