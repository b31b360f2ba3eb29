"""Softmax attention (``bigdl_tpu/ops/attention.py``): the plain versions,
the dispatcher, and the attention-forward kernels K8 and K9.

Operands are (B, H, T, D) queries and (B, Hk, Tk, D) keys and values; K/V
may carry fewer heads (GQA/MQA, H % Hk == 0), KV head ``j`` serving query
heads ``[j*g, (j+1)*g)``.  Masked scores are ``NEG_INF = -1e30``, not
``-inf``; the causal mask is top-left aligned (``q_pos >= k_pos``, no shift
when Tq != Tk).

The kernels (``csrc/attention.cu``):

* K8 (:func:`attention_fwd`) replaces ``_fwd_kernel``
  (``bigdl_tpu/ops/attention.py:117``, reached through ``_fused_forward``):
  one max per row over all keys, ``p = exp(s - m)`` in f32, one division at
  the end, output in q's dtype.  The TPU kernel held a whole (block_q, Tk)
  score tile in VMEM; on Hopper that does not fit, so K8 makes two passes
  over K/V tiles of 64 keys, the row max first, then ``p``, ``l`` and
  ``acc``.  Its plain version is :func:`attention_reference`.
* K9 (:func:`attention_stream_fwd`) replaces ``_stream_kernel``
  (``:207``, reached through ``_streaming_forward``): the online softmax
  over key blocks with a running max, sum and accumulator in f32, causal
  blocks in the future and blocks whose keys are all padded skipped,
  ``p = 0`` where ``s <= NEG_INF/2``, ``o = acc / max(l, 1e-20)`` so a row
  with every key padded gives 0.  Its plain version is
  :func:`attention_stream_plain`.

Both hold no (T, T) score matrix in global memory.  A CPU tensor takes the
plain version, which autograd differentiates; a CUDA tensor launches the
kernel inside an autograd function whose backward raises until the flash
backward kernels (K10, K11) come with the TransformerLM training slice.
Each wrapper counts its launches in ``<wrapper>.launches``.

The plain versions compute in float32 whatever the input dtype (as the
kernels do: bf16 products are exact in f32) and round once to q's dtype.
"""

from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.ops import _build

NEG_INF = -1e30

# the reference's eligibility budgets (TPU VMEM), kept so that the port
# sends the same shapes to K8, K9 or the chunked form
_SCORE_TILE_BYTES = 2 * 1024 * 1024
_KV_VMEM_BYTES = 4 * 1024 * 1024
# eval dispatch: past this key length (or for untileable lengths) the
# forward-only call takes the chunked plain form
_EVAL_MAX_T = 8192

# key block of K9's plain version: the kernels' K/V tile
BLOCK_K = 64
# head dims the kernels take
HEAD_DIMS = (16, 32, 64, 128)


def expand_kv_heads(q, k, v):
    """GQA's shared KV heads repeated to the query head count: KV head
    ``j`` serves query heads ``[j*g, (j+1)*g)`` (``repeat_interleave``)."""
    h, hk = q.shape[1], k.shape[1]
    if h == hk:
        return k, v
    if h % hk:
        raise ValueError(f"{h} query heads do not share {hk} KV heads")
    group = h // hk
    return (k.repeat_interleave(group, dim=1),
            v.repeat_interleave(group, dim=1))


def _scale(d: int, scale) -> float:
    return float(1.0 / math.sqrt(d)) if scale is None else float(scale)


def attention_reference(q, k, v, causal=False, scale=None, mask=None):
    """Exact softmax attention, the oracle and K8's plain version.
    ``mask``: optional boolean broadcastable to (B, H, Tq, Tk), True =
    attend, combined with ``causal``; rows with every key masked give 0."""
    scale_ = _scale(q.shape[-1], scale)
    k, v = expand_kv_heads(q, k, v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale_
    if causal:
        t_q, t_k = q.shape[-2], k.shape[-2]
        allow = torch.arange(t_q, device=q.device)[:, None] >= \
            torch.arange(t_k, device=q.device)[None, :]
        s = torch.where(allow, s, NEG_INF)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(s.amax(dim=-1, keepdim=True) > NEG_INF / 2, p, 0.0)
    return torch.matmul(p, v.float()).to(q.dtype)


def attention_stream_plain(q, k, v, causal=False, scale=None, bias=None):
    """K9's plain version: the online softmax over key blocks of
    ``BLOCK_K`` with K9's masking, in f32.  ``bias``: optional (B, Tk)
    additive key-padding row (0 valid, ``NEG_INF`` padded).  The kernel's
    block skips are left out: a skipped block's update is the identity
    (``p = 0`` and ``alpha = 1``)."""
    scale_ = _scale(q.shape[-1], scale)
    k, v = expand_kv_heads(q, k, v)
    b, h, t, d = q.shape
    tk = k.shape[2]
    qf = q.float()
    m = torch.full((b, h, t, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, t, 1), device=q.device)
    acc = torch.zeros((b, h, t, d), device=q.device)
    q_pos = torch.arange(t, device=q.device)[:, None]
    for k0 in range(0, tk, BLOCK_K):
        kb = k[:, :, k0:k0 + BLOCK_K].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale_
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = torch.where(q_pos >= k_pos[None, :], s, NEG_INF)
        if bias is not None:
            s = s + bias[:, None, None, k0:k0 + BLOCK_K]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(
            p, v[:, :, k0:k0 + BLOCK_K].float())
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(q.dtype)


def _chunked_attention_reference(q, k, v, causal, scale, block_q=256,
                                 bias=None):
    """Exact attention computed per query chunk: one (B, H, block_q, Tk)
    score chunk at a time, never the full (Tq, Tk) matrix.  ``bias``:
    optional (B, Tk) additive key-padding row."""
    b, h, t, d = q.shape
    k, v = expand_kv_heads(q, k, v)
    tk = k.shape[2]
    block_q = next(bq for bq in (block_q, 128, 64, 32, 16, 8, 1)
                   if t % bq == 0)
    kf, vf = k.float().transpose(-1, -2), v.float()
    outs = []
    for i in range(0, t, block_q):
        s = torch.matmul(q[:, :, i:i + block_q].float(), kf) * scale
        if causal:
            q_pos = torch.arange(i, i + block_q, device=q.device)
            allow = q_pos[:, None] >= torch.arange(tk, device=q.device)
            s = torch.where(allow, s, NEG_INF)
        if bias is not None:
            s = s + bias[:, None, None, :]
        p = torch.softmax(s, dim=-1)
        if bias is not None:
            p = torch.where(s.amax(dim=-1, keepdim=True) > NEG_INF / 2,
                            p, 0.0)
        outs.append(torch.matmul(p, vf))
    return torch.cat(outs, dim=2).to(q.dtype)


def _pick_block_q(t_q: int, t_k: int):
    """The reference's K8 eligibility: the largest query block whose
    (block_q, t_k) f32 score tile fits the 2 MB budget, or None."""
    for b in (512, 256, 128, 64, 32, 16, 8):
        if t_q % b == 0 and b * t_k * 4 <= _SCORE_TILE_BYTES:
            return b
    if t_q * t_k * 4 <= _SCORE_TILE_BYTES:
        return t_q
    return None


def _pick_stream_blocks(t_q: int, t_k: int):
    """The reference's K9 eligibility: a (block_q, block_k) divisor pair,
    or None when the lengths admit no tiling."""
    bq = next((b for b in (256, 128, 64, 32, 16, 8) if t_q % b == 0), None)
    bk = next((b for b in (512, 256, 128, 64, 32, 16, 8)
               if t_k % b == 0), None)
    if bq is None or bk is None:
        return None
    return bq, bk


# -- the kernels --------------------------------------------------------------

def _check_operands(what, q, k, v, bias=None):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what} takes (B, H, T, D) q and equal (B, Hk, Tk, "
                         f"D) k and v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16 q, k and v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias is not None and (bias.shape != (b, k.shape[2]) or
                             bias.dtype != torch.float32):
        raise ValueError(f"{what}: bias must be (B, Tk) = {(b, k.shape[2])} "
                         f"float32, got {tuple(bias.shape)} {bias.dtype}")
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: operands on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} has no path for device {q.device}")


def _kernel_operand(t):
    """Contiguous, with a 16-byte aligned start (the kernels read 16-byte
    vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(wrapper, entry, q, k, v, bias, causal, scale):
    b, h, t, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    name = wrapper.__name__
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 (batch, head) "
                         f"rows, got {b * h}")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    o = torch.empty_like(q)
    if t == 0:
        return o
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if entry == "bigdl_attention_stream_fwd":
        args.append(0 if bias is None else _kernel_operand(bias).data_ptr())
    rc = getattr(_build.load(), entry)(
        *args, o.data_ptr(), _build.DTYPE_CODES[q.dtype], b * h, h, hk, t,
        tk, d, scale, int(bool(causal)), _build.stream_ptr(q))
    _build.check(rc, name)
    wrapper.launches += 1
    return o


class _ForwardOnly(torch.autograd.Function):
    """A kernel launch with autograd history whose backward raises: a bare
    launch would give an output with no history, and so a silently
    missing gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, wrapper, entry, causal, scale):
        return _launch(wrapper, entry, q, k, v, bias, causal, scale)

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "the backward of the attention-forward kernels K8/K9 is the "
            "flash backward (K10, K11), which comes with the TransformerLM "
            "training slice of bigdl_tpu_torch")


def attention_fwd(q, k, v, causal=False, scale=None):
    """K8: exact softmax attention with one max per row, for (B, H, T, D)
    q and (B, Hk, Tk, D) k, v in float32 or bfloat16."""
    _check_operands("attention_fwd", q, k, v)
    scale_ = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, scale_)
    return _ForwardOnly.apply(q, k, v, None, attention_fwd,
                              "bigdl_attention_fwd", causal, scale_)


def attention_stream_fwd(q, k, v, causal=False, scale=None, bias=None):
    """K9: online-softmax attention over key blocks, with an optional
    (B, Tk) float32 additive key-padding ``bias``."""
    _check_operands("attention_stream_fwd", q, k, v, bias)
    scale_ = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return attention_stream_plain(q, k, v, causal, scale_, bias)
    return _ForwardOnly.apply(q, k, v, bias, attention_stream_fwd,
                              "bigdl_attention_stream_fwd", causal, scale_)


for _fn in (attention_fwd, attention_stream_fwd):
    _fn.launches = 0


# -- dispatch -----------------------------------------------------------------

def fused_attention(q, k, v, causal: bool = False, scale=None,
                    needs_backward: bool = True, key_padding_mask=None):
    """Softmax attention over (B, H, T, D), dispatched as the reference
    dispatches on the TPU: K8 for an unmasked call whose K/V fit
    (``t_k * d * 4 <= 512 KB``), K9 for longer sequences and for every
    call with a key-padding mask, the chunked plain form for forward-only
    calls past T = 8192 or at lengths that do not tile, and
    :func:`attention_reference` for a call that needs a backward at such
    lengths.  ``key_padding_mask``: optional (B, Tk) boolean, True = real
    token."""
    scale_ = _scale(q.shape[-1], scale)
    t, t_k = q.shape[-2], k.shape[-2]
    bias = kpm = None
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=q.device)
        if tuple(kpm.shape) != (q.shape[0], t_k):
            raise ValueError(f"key_padding_mask shape {tuple(kpm.shape)} != "
                             f"(B, Tk) = {(q.shape[0], t_k)}")
        kpm = kpm.bool()
        bias = torch.where(kpm, 0.0, NEG_INF).float()
    tiles = _pick_stream_blocks(t, t_k) is not None
    if not needs_backward and (t_k > _EVAL_MAX_T or not tiles):
        return _chunked_attention_reference(q, k, v, bool(causal), scale_,
                                            bias=bias)
    if bias is not None:
        if tiles:
            return attention_stream_fwd(q, k, v, bool(causal), scale_, bias)
    else:
        fits = (t_k * q.shape[-1] * 4 <= _KV_VMEM_BYTES // 8 and
                _pick_block_q(t, t_k) is not None)
        if fits:
            return attention_fwd(q, k, v, bool(causal), scale_)
        if tiles:
            return attention_stream_fwd(q, k, v, bool(causal), scale_)
    return attention_reference(
        q, k, v, causal, scale_,
        mask=None if kpm is None else kpm[:, None, None, :])
