"""Softmax attention (``bigdl_tpu/ops/attention.py``): the plain versions,
the dispatcher, the attention-forward kernels K8 and K9, the flash
backward K10 and K11 and the paged-attention kernel K12.

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
  with every key padded gives 0.  On the training path it also writes the
  row logsumexp ``m + log(l)`` (``with_lse``).  Its plain version is
  :func:`attention_stream_plain`.
* K10 (:func:`attention_stream_bwd_dq`) and K11
  (:func:`attention_stream_bwd_dkv`, ``csrc/flash_attention_bwd.cu``)
  replace ``_bwd_dq_kernel`` (``:363``) and ``_bwd_dkv_kernel`` (``:415``),
  the flash backward of ``_flash_streaming_bwd``: ``p = exp(s - lse)``
  recomputed per block from K9's saved logsumexp, dQ summed over key
  blocks, dK and dV over query blocks of every query head of the GQA
  group.  Their plain version is :func:`flash_bwd_plain`.  Both take
  ``delta = rowsum(dO·O)`` from one pass, :func:`flash_bwd_delta` (plain
  version :func:`flash_bwd_delta_plain`), which the TPU kernels recomputed
  per block; it is a helper of K10/K11 with no TPU kernel of its own.

* K12 (:func:`paged_attention`) replaces ``_paged_kernel``
  (``:782``, wrapper ``:813``): masked attention of decode or prefill
  queries over a block-paged KV pool read through a page table, the
  serving read path of ``ContinuousGenerator``.  Its plain version,
  :func:`paged_attention_plain`, is the reference's gather path
  (``bigdl_tpu/nn/attention.py:341-369``): trash pages zeroed, scores in
  the promoted operand dtype, ``l <= positions[b, s]`` masked with
  ``-inf``, softmax in f32, weights cast to the cache dtype, output in the
  cache dtype.  The arithmetic after the gather, :func:`decode_attention`,
  is also the decode path of ``nn/attention.py``.

None of them holds a (T, T) score matrix in global memory.  A CPU tensor
takes the plain version.  On a CUDA tensor K8 runs inside an autograd
function whose backward is the reference's (``_fused_attention_bwd``:
autograd of the chunked plain form, recomputed, no kernel); a CPU K8 call
is autograd of its plain version.  K9 runs inside the reference's custom
VJP (``_streaming_attention``) on either device: its forward writes the
logsumexp only when autograd will need it, and its backward runs K10 and
K11, or ``flash_bwd_plain`` on CPU tensors.  K12 has no backward, as the
reference's has none.  K8-K11 are built for head dims ``HEAD_DIMS``;
another head dim up to 256 is zero-padded to the next of them, which is
exact for every product once the outputs are sliced back; a larger one
raises ``ValueError`` before any launch.  Each wrapper
counts its launches in ``<wrapper>.launches``.

The plain versions of K8 and K9 compute in float32 whatever the input
dtype (as the kernels do: bf16 products are exact in f32) and round once
to q's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.core.precision import promote
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
# head dims K8-K11 are built for; a smaller one is zero-padded up
HEAD_DIMS = (16, 32, 64, 128, 256)


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


def attention_stream_plain(q, k, v, causal=False, scale=None, bias=None,
                           with_lse=False):
    """K9's plain version: the online softmax over key blocks of
    ``BLOCK_K`` with K9's masking, in f32.  ``bias``: optional (B, Tk)
    additive key-padding row (0 valid, ``NEG_INF`` padded).  The kernel's
    block skips are left out: a skipped block's update is the identity
    (``p = 0`` and ``alpha = 1``).  With ``with_lse`` it also returns the
    row logsumexp ``m + log(max(l, 1e-20))``, (B, H, T) float32, which the
    flash backward reads (``_stream_kernel``'s ``with_lse``; the reference
    stores it over ``LSE_W`` lanes, the port once per row)."""
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
    l = l.clamp_min(1e-20)
    o = (acc / l).to(q.dtype)
    if with_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def flash_bwd_delta_plain(o, do):
    """``delta = rowsum(dO·O)`` (B, H, T) float32, the plain version of
    :func:`flash_bwd_delta`: dO cast to o's (q's) dtype first, the
    products summed in f32, as ``_bwd_dq_kernel`` computes it."""
    return (do.to(o.dtype).float() * o.float()).sum(dim=-1)


def flash_bwd_plain(q, k, v, o, lse, do, causal=False, scale=None,
                    bias=None, delta=None):
    """The flash backward's plain version (``_flash_streaming_bwd``, K10
    and K11): dQ, dK and dV of K9's attention from its output ``o`` and
    row logsumexp ``lse`` (B, H, T), key block by key block of
    ``BLOCK_K``, ``p = exp(s - lse)`` recomputed per block (0 where
    ``s <= NEG_INF/2``, so a row with every key padded gives nothing),
    ``delta = rowsum(dO·O)`` (``delta``, (B, H, T) float32, or computed
    here by :func:`flash_bwd_delta_plain`),
    ``ds = p·(dO·vᵀ - delta)·scale``.  It rounds where the reference
    rounds: ``ds`` to q's dtype before ``ds·k`` and ``dsᵀ·q``, ``p`` to
    dO's (q's) dtype before ``pᵀ·dO``; every product accumulates in f32.
    dK and dV sum over the query heads that share a KV head (GQA).
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    scale_ = _scale(q.shape[-1], scale)
    b, h, t, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    group = h // hk
    do = do.to(q.dtype)
    ke, ve = expand_kv_heads(q, k, v)
    qf, dof = q.float(), do.float()
    if delta is None:
        delta = flash_bwd_delta_plain(o, do)
    delta = delta.float()[..., None]
    lse = lse.float()[..., None]
    q_pos = torch.arange(t, device=q.device)[:, None]
    dq = torch.zeros((b, h, t, d), device=q.device)
    dks, dvs = [], []
    for k0 in range(0, tk, BLOCK_K):
        kb = ke[:, :, k0:k0 + BLOCK_K].float()
        vb = ve[:, :, k0:k0 + BLOCK_K].float()
        s = torch.matmul(qf, kb.transpose(-1, -2)) * scale_
        if causal:
            k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)
            s = torch.where(q_pos >= k_pos[None, :], s, NEG_INF)
        if bias is not None:
            s = s + bias[:, None, None, k0:k0 + BLOCK_K]
        p = torch.where(s > NEG_INF / 2, torch.exp(s - lse), 0.0)
        dp = torch.matmul(dof, vb.transpose(-1, -2))
        ds = (p * (dp - delta) * scale_).to(q.dtype).float()
        dq = dq + torch.matmul(ds, kb)
        dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
        n = kb.shape[2]
        dks.append(dk.reshape(b, hk, group, n, d).sum(dim=2))
        dvs.append(dv.reshape(b, hk, group, n, d).sum(dim=2))
    empty = torch.zeros((b, hk, 0, d), device=q.device)
    return (dq.to(q.dtype), torch.cat(dks or [empty], dim=2).to(k.dtype),
            torch.cat(dvs or [empty], dim=2).to(v.dtype))


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


def _kernel_head_dim(name: str, d: int) -> int:
    """The head dim K8-K11 run ``d`` at: the smallest of ``HEAD_DIMS`` that
    holds it (a block's tiles of 64 rows must fit its 227 KB of shared
    memory)."""
    for kd in HEAD_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"{name} kernel takes head dims up to {HEAD_DIMS[-1]} "
                     f"(its tiles in a block's shared memory), got {d}")


def _pad_head(d: int, kd: int, *tensors):
    """Tensors zero-padded from head dim ``d`` to ``kd`` (none when equal)
    and made kernel operands."""
    if kd != d:
        tensors = [F.pad(x, (0, kd - d)) for x in tensors]
    return [_kernel_operand(x) for x in tensors]


def _rows_check(name: str, rows: int) -> None:
    if rows > 65535:
        raise ValueError(f"{name} kernel takes at most 65535 (batch, head) "
                         f"rows, got {rows}")


def _launch(wrapper, entry, q, k, v, bias, causal, scale, with_lse=False):
    """One K8 or K9 launch; K9 with ``with_lse`` also writes the (B, H, T)
    float32 row logsumexp, returned beside ``o``."""
    b, h, t, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    name = wrapper.__name__
    kd = _kernel_head_dim(name, d)
    _rows_check(name, b * h)
    q, k, v = _pad_head(d, kd, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if t:
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
        if entry == "bigdl_attention_stream_fwd":
            args.append(0 if bias is None else
                        _kernel_operand(bias).data_ptr())
        args.append(o.data_ptr())
        if entry == "bigdl_attention_stream_fwd":
            args.append(0 if lse is None else lse.data_ptr())
        rc = getattr(_build.load(), entry)(
            *args, _build.DTYPE_CODES[q.dtype], b * h, h, hk, t, tk, kd,
            scale, int(bool(causal)), _build.stream_ptr(q))
        _build.check(rc, name)
        wrapper.launches += 1
    o = o if kd == d else o[..., :d].contiguous()
    return (o, lse) if with_lse else o


class _K8(torch.autograd.Function):
    """K8 with the reference's backward (``_fused_attention_bwd``):
    autograd of :func:`_chunked_attention_reference`, recomputed from q, k
    and v, one query chunk of scores at a time; no kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _launch(attention_fwd, "bigdl_attention_fwd", q, k, v, None,
                       causal, scale)

    @staticmethod
    def backward(ctx, do):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_()
                       for t in ctx.saved_tensors)
            o = _chunked_attention_reference(q, k, v, ctx.causal, ctx.scale)
        return (*torch.autograd.grad(o, (q, k, v), do), None, None)


class _K9(torch.autograd.Function):
    """The reference's ``_streaming_attention`` custom VJP: K9 forward,
    writing its row logsumexp only when autograd will need it (as K1/K2
    write their index/scale), and the flash backward, K10 (dQ) and K11
    (dK, dV), from the saved ``q, k, v, bias, o, lse``.  The key-padding
    bias gets no gradient (the reference defines it as zero).  On CPU
    tensors the same function runs the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, scale):
        need = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            out = attention_stream_plain(q, k, v, causal, scale, bias,
                                         with_lse=need)
        else:
            out = _launch(attention_stream_fwd, "bigdl_attention_stream_fwd",
                          q, k, v, bias, causal, scale, with_lse=need)
        if not need:
            return out
        o, lse = out
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        args = (q, k, v, o, lse, do, ctx.causal, ctx.scale, bias)
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_plain(*args)
        else:   # one delta pass, shared by K10 and K11
            delta = flash_bwd_delta(o, do)
            dq = attention_stream_bwd_dq(*args, delta=delta)
            dk, dv = attention_stream_bwd_dkv(*args, delta=delta)
        return dq, dk, dv, None, None, None


def attention_fwd(q, k, v, causal=False, scale=None):
    """K8: exact softmax attention with one max per row, for (B, H, T, D)
    q and (B, Hk, Tk, D) k, v in float32 or bfloat16."""
    _check_operands("attention_fwd", q, k, v)
    scale_ = _scale(q.shape[-1], scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, scale_)
    return _K8.apply(q, k, v, bool(causal), scale_)


def attention_stream_fwd(q, k, v, causal=False, scale=None, bias=None):
    """K9: online-softmax attention over key blocks, with an optional
    (B, Tk) float32 additive key-padding ``bias``; differentiable through
    the flash backward (K10, K11)."""
    _check_operands("attention_stream_fwd", q, k, v, bias)
    return _K9.apply(q, k, v, bias, bool(causal), _scale(q.shape[-1], scale))


def _check_bwd(what, q, k, v, o, lse, do, bias, delta=None):
    _check_operands(what, q, k, v, bias)
    b, h, t, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"{what}: o and do must be shaped like q "
                         f"{tuple(q.shape)} (o in q's dtype), got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x is not None and (tuple(x.shape) != (b, h, t) or
                              x.dtype != torch.float32):
            raise ValueError(f"{what}: {name} must be (B, H, T) = "
                             f"{(b, h, t)} float32, got {tuple(x.shape)} "
                             f"{x.dtype}")
    rows = (o, lse, do) if delta is None else (o, lse, do, delta)
    if any(x.device != q.device for x in rows):
        raise ValueError(f"{what}: operands on different devices")
    if q.device.type == "cuda":   # before the delta pass launches
        _kernel_head_dim(what, q.shape[-1])


def flash_bwd_delta(o, do):
    """The delta pass of the flash backward: ``rowsum(dO·O)`` (B, H, T)
    float32 for o (B, H, T, D) and do like it (cast to o's dtype), once
    per backward for K10 and K11 to share."""
    if o.dim() != 4 or do.shape != o.shape or \
            o.dtype not in _build.DTYPE_CODES or do.device != o.device:
        raise ValueError("flash_bwd_delta takes (B, H, T, D) float32 or "
                         "bfloat16 o and do of its shape on its device, got "
                         f"{tuple(o.shape)} {o.dtype} and {tuple(do.shape)}")
    if o.device.type == "cpu":
        return flash_bwd_delta_plain(o, do)
    if o.device.type != "cuda":
        raise RuntimeError(f"flash_bwd_delta has no path for device "
                           f"{o.device}")
    b, h, t, d = o.shape
    o, do = _kernel_operand(o), _kernel_operand(do.to(o.dtype))
    delta = torch.empty((b, h, t), dtype=torch.float32, device=o.device)
    if delta.numel():
        rc = _build.load().bigdl_flash_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(),
            _build.DTYPE_CODES[o.dtype], b * h * t, d, _build.stream_ptr(o))
        _build.check(rc, "flash_bwd_delta")
        flash_bwd_delta.launches += 1
    return delta


def _launch_bwd(wrapper, entry, q, k, v, delta, lse, do, causal, scale,
                bias):
    """One K10 or K11 launch: head dims padded as K8/K9 pad them (zero
    columns of q, k, v and dO add nothing to any score or product, and give
    zero gradient columns, sliced away)."""
    b, h, t, d = q.shape
    hk, tk = k.shape[1], k.shape[2]
    name = wrapper.__name__
    kd = _kernel_head_dim(name, d)
    _rows_check(name, b * h)
    q, k, v, do = _pad_head(d, kd, q, k, v, do.to(q.dtype))
    lse, delta = _kernel_operand(lse), _kernel_operand(delta)
    bias_ptr = 0 if bias is None else _kernel_operand(bias).data_ptr()
    if entry == "bigdl_flash_bwd_dq":
        outs = [torch.empty_like(q)]
    else:
        outs = [torch.empty_like(k), torch.empty_like(v)]
    if t * tk == 0:   # nothing to attend: the gradients are zero
        outs = [x.zero_() for x in outs]
    else:
        rc = getattr(_build.load(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), delta.data_ptr(),
            lse.data_ptr(), do.data_ptr(), bias_ptr,
            *(x.data_ptr() for x in outs), _build.DTYPE_CODES[q.dtype],
            b, h, hk, t, tk, kd, scale, int(bool(causal)),
            _build.stream_ptr(q))
        _build.check(rc, name)
        wrapper.launches += 1
    if kd != d:
        outs = [x[..., :d].contiguous() for x in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def attention_stream_bwd_dq(q, k, v, o, lse, do, causal=False, scale=None,
                            bias=None, delta=None):
    """K10: dQ of K9's attention (``_bwd_dq_kernel``), from its output
    ``o`` and row logsumexp ``lse`` (B, H, T) float32; dQ in q's dtype.
    ``delta``: :func:`flash_bwd_delta` of (o, do), run here when None."""
    _check_bwd("attention_stream_bwd_dq", q, k, v, o, lse, do, bias, delta)
    scale_ = _scale(q.shape[-1], scale)
    if delta is None:
        delta = flash_bwd_delta(o, do)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale_, bias,
                               delta)[0]
    return _launch_bwd(attention_stream_bwd_dq, "bigdl_flash_bwd_dq", q, k,
                       v, delta, lse, do, causal, scale_, bias)


def attention_stream_bwd_dkv(q, k, v, o, lse, do, causal=False, scale=None,
                             bias=None, delta=None):
    """K11: dK and dV of K9's attention (``_bwd_dkv_kernel``), each summed
    over the query heads that share its KV head; in k's and v's dtype.
    ``delta`` as for :func:`attention_stream_bwd_dq`."""
    _check_bwd("attention_stream_bwd_dkv", q, k, v, o, lse, do, bias, delta)
    scale_ = _scale(q.shape[-1], scale)
    if delta is None:
        delta = flash_bwd_delta(o, do)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale_, bias,
                               delta)[1:]
    return _launch_bwd(attention_stream_bwd_dkv, "bigdl_flash_bwd_dkv", q, k,
                       v, delta, lse, do, causal, scale_, bias)


# -- paged attention (K12) ----------------------------------------------------

# query rows (GQA group heads x positions) a K12 block owns at most, and
# output elements a thread accumulates at most (rows x D <= 1024)
PAGED_ROWS = 16
_PAGED_OUT = 1024
_PAGED_KEYS = 64                     # keys per K/V tile of a K12 block
_SMEM_FLOATS = 232448 // 4           # a block's shared memory on Hopper


def decode_attention(q, kk, vv, valid, scale):
    """The reference's decode attention after the cache read
    (``bigdl_tpu/nn/attention.py`` ``apply_decode*``): ``q`` (B, H, S, D)
    against ``kk``/``vv`` (B, Hk, L, D) in the cache dtype, ``valid``
    broadcastable to (B, H, S, L).  Scores in the promoted operand dtype
    (bf16 x bf16 stays bf16, as ``jnp.einsum`` does), scaled in that
    dtype, masked with ``-inf``; softmax in f32; the weights cast to the
    cache dtype for ``w·v``, so the output has the cache dtype."""
    kk, vv = expand_kv_heads(q, kk, vv)
    qs, ks = promote(q, kk)
    scores = torch.matmul(qs, ks.transpose(-1, -2)) * scale
    scores = torch.where(valid, scores, float("-inf"))
    w = torch.softmax(scores.float(), dim=-1)
    return torch.matmul(w.to(vv.dtype), vv)


def paged_attention_plain(q, k_pool, v_pool, pages, positions, scale):
    """K12's plain version, the reference's gather path: each row's pages
    gathered into a (B, Hkv, Lp*ps, D) view, trash-page positions zeroed
    (a NaN dumped on the trash page reaches no row), key slot ``l``
    visible to token ``s`` of row ``b`` iff ``l <= positions[b, s]``."""
    b, d = q.shape[0], q.shape[3]
    hkv, ps = k_pool.shape[1], k_pool.shape[2]
    trash = k_pool.shape[0] - 1
    pages = pages.long()
    lp = pages.shape[1]
    tmask = (pages == trash).repeat_interleave(ps, dim=1)[:, None, :, None]

    def view(pool):
        v = pool[pages].transpose(1, 2).reshape(b, hkv, lp * ps, d)
        return torch.where(tmask, 0, v)

    valid = torch.arange(lp * ps, device=q.device)[None, None, :] <= \
        positions.long()[:, :, None]
    return decode_attention(q, view(k_pool), view(v_pool), valid[:, None],
                            scale)


def _check_paged(q, k_pool, v_pool, pages, positions):
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_attention takes (B, H, S, D) q and equal "
                         f"(P+1, Hkv, ps, D) pools, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    b, h, s, d = q.shape
    if k_pool.shape[3] != d or h % k_pool.shape[1]:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} and pool "
                         f"{tuple(k_pool.shape)} do not agree")
    if pages.dim() != 2 or pages.shape[0] != b or \
            tuple(positions.shape) != (b, s):
        raise ValueError(f"paged_attention: pages must be (B, Lp) and "
                         f"positions (B, S) = {(b, s)}, got "
                         f"{tuple(pages.shape)} and "
                         f"{tuple(positions.shape)}")
    if pages.is_floating_point() or positions.is_floating_point():
        raise TypeError("paged_attention: pages and positions must be "
                        "integer tensors")
    if k_pool.dtype != v_pool.dtype or \
            q.dtype not in _build.DTYPE_CODES or \
            k_pool.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"pools of one dtype, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if any(t.device != q.device
           for t in (k_pool, v_pool, pages, positions)):
        raise ValueError("paged_attention: operands on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"paged_attention has no path for device "
                           f"{q.device}")


def paged_rows_per_block(d: int, lp: int, ps: int, rows: int) -> int:
    """K12's query rows per block: at most ``PAGED_ROWS``, at most
    1024 / D (the output elements a thread holds), and as many (D + L)
    float rows as the block's shared memory holds beside one K/V tile and
    the row's ``lp`` page ids (L = lp * ps)."""
    length = lp * ps
    fixed = 2 * _PAGED_KEYS + PAGED_ROWS + _PAGED_KEYS * (d + 1) + lp
    fit = (_SMEM_FLOATS - fixed) // (d + length)
    ts = min(PAGED_ROWS, rows, _PAGED_OUT // d, fit)
    if ts < 1:
        raise ValueError(
            f"paged_attention kernel: head dim {d} with a {length}-token "
            f"page table does not fit a block (head dim <= {_PAGED_OUT}, "
            f"and one score row of {length} floats beside a tile of "
            f"{_PAGED_KEYS} keys in {_SMEM_FLOATS * 4} bytes)")
    return ts


def paged_attention(q, k_pool, v_pool, pages, positions, scale):
    """K12: masked attention over a block-paged KV pool, with the
    reference's signature (``bigdl_tpu/ops/attention.py:813``): ``q``
    (B, H, S, D); pools (P+1, Hkv, ps, D) whose last page is the trash
    page; ``pages`` (B, Lp) int page table; ``positions`` (B, S), key slot
    ``l`` visible to token ``s`` iff ``l <= positions[b, s]``; GQA shares
    KV head ``h // (H / Hkv)``.  Returns (B, H, S, D) in the cache dtype.
    Forward only: it has no backward, as the reference's has none."""
    _check_paged(q, k_pool, v_pool, pages, positions)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, pages, positions,
                                     scale)
    if torch.is_grad_enabled() and q.requires_grad:
        raise RuntimeError("paged_attention kernel has no backward "
                           "(inference only, as in the reference)")
    if q.dtype == torch.bfloat16 and k_pool.dtype == torch.float32:
        q = q.float()   # exact: the product is promoted to f32 anyway
    b, h, s, d = q.shape
    hkv, ps = k_pool.shape[1], k_pool.shape[2]
    lp = pages.shape[1]
    if b > 65535 or hkv > 65535:
        raise ValueError(f"paged_attention kernel takes at most 65535 rows "
                         f"and KV heads, got {b} and {hkv}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_attention kernel takes contiguous pools "
                         "(a copy of the pool would defeat paging)")
    q = q.contiguous()
    pages = pages.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    o = torch.empty((b, h, s, d), dtype=k_pool.dtype, device=q.device)
    if b * h * s == 0:
        return o
    rows = (h // hkv) * s
    ts = paged_rows_per_block(d, lp, ps, rows)
    rc = _build.load().bigdl_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        pages.data_ptr(), positions.data_ptr(), o.data_ptr(),
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_pool.dtype], b,
        h, hkv, s, d, ps, lp, k_pool.shape[0] - 1, float(scale), ts,
        _build.stream_ptr(q))
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return o


for _fn in (attention_fwd, attention_stream_fwd, attention_stream_bwd_dq,
            attention_stream_bwd_dkv, flash_bwd_delta, paged_attention):
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
