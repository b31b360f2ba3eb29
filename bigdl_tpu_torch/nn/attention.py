"""Multi-head self-attention (``bigdl_tpu/nn/attention.py``) over (batch,
seq, embed) inputs.

The forward runs :func:`bigdl_tpu_torch.ops.attention.fused_attention`
(K8 or K9 on the card, as the reference's dispatch picks them); the decode
path through the KV cache (:meth:`MultiHeadAttention.apply_decode`) is
plain tensor math, as in the reference, where no Pallas kernel runs on it.
Parameters ``wq``/``wk``/``wv``/``wo`` are (out, in) and ``bq``/``bk``/
``bv``/``bo`` the biases, under the reference's names.  GQA: K/V project to
``num_kv_heads`` heads, KV head ``j`` serving query heads
``[j*g, (j+1)*g)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.ops.attention import expand_kv_heads, fused_attention


def apply_rope(x, pos, theta: float = 10000.0):
    """Rotary position embedding over (B, H, T, D) at positions ``pos``
    (T,), the half-split pairing; computed in f32, returned in x's
    dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


class MultiHeadAttention(Module):

    def __init__(self, embed_dim: int, num_heads: int, causal: bool = False,
                 with_bias: bool = True,
                 init_method: str = init_methods.XAVIER,
                 num_kv_heads=None, rope: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.with_bias = with_bias
        self.init_method = init_method
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"{num_heads} heads do not share "
                             f"{self.num_kv_heads} KV heads")
        if rope and self.head_dim % 2:
            raise ValueError(f"rope needs an even head dim, got "
                             f"{self.head_dim}")
        self.rope = rope
        self.rope_theta = rope_theta
        e, ekv = embed_dim, self.num_kv_heads * self.head_dim
        for name, out in (("wq", e), ("wk", ekv), ("wv", ekv), ("wo", e)):
            setattr(self, name, nn.Parameter(torch.empty(out, e)))
        for name, out in (("bq", e), ("bk", ekv), ("bv", ekv), ("bo", e)):
            setattr(self, name,
                    nn.Parameter(torch.zeros(out)) if with_bias else None)
        self.reset_parameters(seeded())

    def reset_parameters(self, gen):
        e = self.embed_dim
        with torch.no_grad():
            for name in ("wq", "wk", "wv", "wo"):
                w = getattr(self, name)
                w.copy_(init_methods.init_weight(
                    self.init_method, gen, tuple(w.shape), fan_in=e,
                    fan_out=w.shape[0]))
            if self.with_bias:
                for name in ("bq", "bk", "bv", "bo"):
                    getattr(self, name).zero_()

    def _split(self, x, heads):
        b, t, _ = x.shape
        return x.reshape(b, t, heads, self.head_dim).transpose(1, 2)

    def _merge(self, x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def _qkv(self, x):
        q = F.linear(x, self.wq, self.bq)
        k = F.linear(x, self.wk, self.bk)
        v = F.linear(x, self.wv, self.bv)
        return (self._split(q, self.num_heads),
                self._split(k, self.num_kv_heads),
                self._split(v, self.num_kv_heads))

    def forward(self, x, key_padding_mask=None):
        q, k, v = self._qkv(x)
        if self.rope:
            pos = torch.arange(q.shape[2], device=x.device)
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        o = fused_attention(q, k, v, causal=self.causal,
                            needs_backward=self.training,
                            key_padding_mask=key_padding_mask)
        return F.linear(self._merge(o), self.wo, self.bo)

    # -- autoregressive decode (KV cache) -----------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """Zeroed KV cache for :meth:`apply_decode`, (B, H_kv, max_len, D)
        per tensor, on the parameters' device."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=self.wq.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.wq.device)}

    def apply_decode(self, x_t, cache, pos: int):
        """Incremental attention for the tokens ``x_t`` (B, S, E) at
        positions ``[pos, pos+S)``, each attending to every cached position
        at or before its own.  Writes this call's K/V into ``cache`` in
        place at ``[pos, pos+S)``; returns y (B, S, E)."""
        q, k, v = self._qkv(x_t)
        s = q.shape[2]
        positions = pos + torch.arange(s, device=x_t.device)
        if self.rope:
            # k is cached after rotation: each position's rotation is
            # absolute, scores depend only on relative offsets
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        ck, cv = cache["k"], cache["v"]
        ck[:, :, pos:pos + s] = k.to(ck.dtype)
        cv[:, :, pos:pos + s] = v.to(cv.dtype)
        kk, vv = expand_kv_heads(q, ck, cv)
        scores = torch.matmul(q, kk.transpose(-1, -2)) * \
            (1.0 / math.sqrt(self.head_dim))
        # key slot l is visible to local row i iff l <= pos + i (unwritten
        # slots lie beyond pos + S - 1, so this masks them too)
        valid = torch.arange(ck.shape[2], device=x_t.device)[None, :] <= \
            positions[:, None]
        scores = torch.where(valid, scores, float("-inf"))
        w = torch.softmax(scores.float(), dim=-1)
        o = torch.matmul(w.to(vv.dtype), vv)
        return F.linear(self._merge(o), self.wo, self.bo)
