"""Multi-head self-attention (``bigdl_tpu/nn/attention.py``) over (batch,
seq, embed) inputs.

The forward runs :func:`bigdl_tpu_torch.ops.attention.fused_attention`
(K8 or K9 on the card, as the reference's dispatch picks them).  The decode
paths through a KV cache written in place (:meth:`MultiHeadAttention.
apply_decode`, :meth:`~MultiHeadAttention.apply_decode_slots`) are plain
tensor math, as in the reference; the paged path
(:meth:`~MultiHeadAttention.apply_decode_pages`) reads through
:func:`~bigdl_tpu_torch.ops.attention.paged_attention` (K12 on the card).
Mixed cache and model dtypes promote at each product as ``jnp`` does.  The
q/k/v/out projections go through ``quant.matmul_or_observe``: in a
``quant.quantize_model`` copy they run K13, K14 or K15 by rung.
Parameters ``wq``/``wk``/``wv``/``wo`` are (out, in) and ``bq``/``bk``/
``bv``/``bo`` the biases, under the reference's names.  GQA: K/V project to
``num_kv_heads`` heads, KV head ``j`` serving query heads
``[j*g, (j+1)*g)``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bigdl_tpu_torch.core import init as init_methods
from bigdl_tpu_torch.core.module import Module, seeded
from bigdl_tpu_torch.ops import quant
from bigdl_tpu_torch.ops.attention import (decode_attention, fused_attention,
                                           paged_attention)


def apply_rope(x, pos, theta: float = 10000.0):
    """Rotary position embedding over (B, H, T, D) at positions ``pos``,
    (T,) shared by every row or (B, T) per row, the half-split pairing;
    computed in f32, returned in x's dtype."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    if ang.dim() == 3:
        ang = ang[:, None]            # (B, 1, T, half): one row per slot
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
        q, k, v = (quant.matmul_or_observe(self, w, x, getattr(self, b))
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        return (self._split(q, self.num_heads),
                self._split(k, self.num_kv_heads),
                self._split(v, self.num_kv_heads))

    def _out(self, o):
        """The output projection of (B, H, S, D) attention outputs: ``o``
        has the cache's dtype in decode, ``wo`` the model's."""
        return quant.matmul_or_observe(self, "wo", self._merge(o), self.bo)

    def forward(self, x, key_padding_mask=None):
        q, k, v = self._qkv(x)
        if self.rope:
            pos = torch.arange(q.shape[2], device=x.device)
            q = apply_rope(q, pos, self.rope_theta)
            k = apply_rope(k, pos, self.rope_theta)
        o = fused_attention(q, k, v, causal=self.causal,
                            needs_backward=self.training,
                            key_padding_mask=key_padding_mask)
        return self._out(o)

    # -- autoregressive decode (KV cache) -----------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32):
        """Zeroed KV cache for :meth:`apply_decode`, (B, H_kv, max_len, D)
        per tensor, on the parameters' device."""
        shape = (batch, self.num_kv_heads, max_len, self.head_dim)
        dev = self.tensor_device()
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

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
        # key slot l is visible to local row i iff l <= pos + i (unwritten
        # slots lie beyond pos + S - 1, so this masks them too)
        valid = torch.arange(ck.shape[2], device=x_t.device)[None, :] <= \
            positions[:, None]
        return self._out(decode_attention(q, ck, cv, valid,
                                          1.0 / math.sqrt(self.head_dim)))

    def _positions(self, x_t, q, k, pos):
        """(B, S) positions ``pos_b + [0, S)`` of every row, with q and k
        rotated there under rope."""
        pos = torch.as_tensor(pos, device=x_t.device).long()
        positions = pos[:, None] + torch.arange(q.shape[2],
                                                device=x_t.device)
        if self.rope:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        return positions, q, k

    def apply_decode_slots(self, x_t, cache, pos, active):
        """Slot-addressable :meth:`apply_decode`: batch row ``b`` is a KV
        cache slot at its own depth ``pos[b]`` (B,), and ``active`` (B,)
        bool gates its write.  An inactive slot writes its existing values
        back (the reference's read-modify-write), so a free slot's cache
        never changes.  A window past the cache end is clamped to end there,
        as ``dynamic_update_slice`` clamps; the caller bounds positions.
        Returns y (B, S, E)."""
        q, k, v = self._qkv(x_t)
        b, _, s, _ = q.shape
        positions, q, k = self._positions(x_t, q, k, pos)
        ck, cv = cache["k"], cache["v"]
        length = ck.shape[2]
        rows = torch.arange(b, device=x_t.device)[:, None].expand(b, s)
        cols = positions[:, :1].clamp(0, length - s) + \
            torch.arange(s, device=x_t.device)
        act = torch.as_tensor(active, device=x_t.device)[:, None, None, None]
        for c, new in ((ck, k), (cv, v)):
            c[rows, :, cols] = torch.where(act, new.transpose(1, 2).to(
                c.dtype), c[rows, :, cols])
        # key slot l is visible to row b's token s iff l <= positions[b, s]
        valid = torch.arange(length, device=x_t.device)[None, None, :] <= \
            positions[:, :, None]
        return self._out(decode_attention(q, ck, cv, valid[:, None],
                                          1.0 / math.sqrt(self.head_dim)))

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype=torch.float32):
        """Block-paged KV pool for :meth:`apply_decode_pages`,
        (num_pages + 1, H_kv, page_size, D) per tensor on the parameters'
        device.  The last page (id ``num_pages``) is the trash page:
        unmapped table slots and inactive rows write there."""
        shape = (num_pages + 1, self.num_kv_heads, page_size, self.head_dim)
        dev = self.tensor_device()
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def apply_decode_pages(self, x_t, cache, pages, pos, active):
        """Page-table :meth:`apply_decode_slots`: logical page ``l`` of row
        ``b`` lives in pool page ``pages[b, l]`` ((B, Lp) int).  Each
        token's K/V is written in place at ``(pages[b, p // ps], p % ps)``;
        an inactive row, and a position whose logical page lies past the
        table, write to the trash page instead, so a write never reaches a
        page outside the row's own table.  Every row writes before any row
        reads, so a row sees what the rows before it wrote in this call
        (a speculative verify pass relies on it).  The read is
        :func:`~bigdl_tpu_torch.ops.attention.paged_attention` (K12 on the
        card), which zeroes trash pages.  Returns y (B, S, E)."""
        q, k, v = self._qkv(x_t)
        b, _, s, _ = q.shape
        positions, q, k = self._positions(x_t, q, k, pos)
        ck, cv = cache["k"], cache["v"]
        ps, trash = ck.shape[2], ck.shape[0] - 1
        pages = torch.as_tensor(pages, device=x_t.device)
        lp = pages.shape[1]
        logical = positions // ps
        phys = torch.gather(pages.long(), 1, logical.clamp(0, lp - 1))
        phys = torch.where(logical >= lp, trash, phys)
        act = torch.as_tensor(active, device=x_t.device)[:, None]
        phys = torch.where(act, phys, trash).reshape(-1)
        offs = (positions % ps).reshape(-1)
        for c, new in ((ck, k), (cv, v)):
            c[phys, :, offs] = new.transpose(1, 2).reshape(
                b * s, self.num_kv_heads, self.head_dim).to(c.dtype)
        return self._out(paged_attention(q, ck, cv, pages, positions,
                                         1.0 / math.sqrt(self.head_dim)))
