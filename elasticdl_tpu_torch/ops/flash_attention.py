"""Flash attention for the H100: hand-written CUDA kernels for the forward,
dQ and dK/dV passes (ops/csrc/), with plain PyTorch versions beside them.

Counterpart of elasticdl_tpu/ops/flash_attention.py. Layout and semantics
follow it: q, k, v are [B, H, S, D], scale is D**-0.5, causal masking uses a
finite NEG_INF, the forward saves lse = m + log(l) per row, and the backward
is two atomic-free passes (dQ per q tile, dK/dV per k tile) fed by
delta = rowsum(dO * O). Differences from the TPU kernels:

- lse and delta are compact [B*H, S] float32; the TPU's 128-lane
  replication is a tiling artifact and is not kept.
- A sequence length that is not a multiple of a tile is masked inside the
  kernels; there is no fallback for it.
- Every product runs on the tensor cores as 3xTF32 mma.sync (f32
  accuracy; ops/csrc/flash_mma.cuh), with the MMAs of zero small parts
  skipped where the operands are exact in TF32 (bfloat16 values). Tiles
  are fixed: 128 resident rows against 64 streamed rows in the forward,
  32 (D = 128) or 64 in the backward kernels. The TPU's 1024-wide blocks
  were sized for VMEM.
- The forward applies the scale to the scores in f32; the TPU kernel
  scales Q first. The two differ by rounding only.
- Head sizes are 32, 64 and 128, each its own instantiation.

Dispatch is by the tensors' device: CUDA tensors always go to the kernels,
CPU tensors to the plain versions. On CUDA an unsupported dtype, head size
or layout raises; nothing falls back. Every kernel wrapper adds one to
`launches[name]` where it launches its kernel, and nowhere else; the
shards of an AllReduce worker launch from their own threads, so the count
takes a lock, and a thread inside `counting_into(counter)` adds its
launches to that counter too (one per shard).
"""

import collections
import contextlib
import threading

import torch

from elasticdl_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel name -> launches since the last reset; the names are those of
# chip_smoke.py's report.
launches = collections.Counter()
KERNEL_NAMES = ("flash_fwd", "flash_fwd_lse", "flash_dq", "flash_dkv")


_count_lock = threading.Lock()
_thread = threading.local()


def reset_launch_counts():
    with _count_lock:
        launches.clear()


def _count(name):
    with _count_lock:
        launches[name] += 1
    extra = getattr(_thread, "counter", None)
    if extra is not None:
        extra[name] += 1


@contextlib.contextmanager
def counting_into(counter):
    """Launches of this thread inside the block also go to `counter`."""
    prior = getattr(_thread, "counter", None)
    _thread.counter = counter
    try:
        yield counter
    finally:
        _thread.counter = prior


# ---------- plain versions (the CPU path and the kernels' oracle) ----------


def _masked_scores(q, k, causal):
    """scale * Q K^T in float32, NEG_INF above the causal diagonal."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(
            s_q, s_k, dtype=torch.bool, device=q.device
        ).tril(s_k - s_q)
        scores = scores.masked_fill(~mask, NEG_INF)
    return scores


def reference_attention(q, k, v, causal=False):
    """[B, H, S, D] full attention in plain PyTorch (float32 inside)."""
    weights = torch.softmax(_masked_scores(q, k, causal), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v.float())
    return out.to(q.dtype)


def _fwd_plain(q, k, v, causal):
    """Plain version of flash_fwd_lse: (out, lse [B, H, S] float32)."""
    scores = _masked_scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, g, lse, delta, causal):
    p = torch.exp(_masked_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    return p, p * (dp - delta[..., None])


def _dq_plain(q, k, v, g, lse, delta, causal):
    """Plain version of flash_dq."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, causal)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def _dkv_plain(q, k, v, g, lse, delta, causal):
    """Plain version of flash_dkv: (dk, dv)."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, causal)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * q.shape[-1] ** -0.5
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(g, out):
    """delta = rowsum(dO * O), [B, H, S] float32 (an elementwise pass, as
    the JAX package leaves it to XLA)."""
    return (g.float() * out.float()).sum(-1)


def _bwd_reference(q, k, v, out, g, causal):
    """Full-matrix backward (counterpart of the JAX package's _bwd_xla):
    lse recomputed from the scores, then dQ, dK, dV."""
    lse = torch.logsumexp(_masked_scores(q, k, causal), dim=-1)
    delta = _delta(g, out)
    dq = _dq_plain(q, k, v, g, lse, delta, causal)
    dk, dv = _dkv_plain(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


# ---------- kernel wrappers ----------


def _check_cuda(name, tensors, row_stats=()):
    """Validates what the kernels take; returns (dtype code, b, h, s, d)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(
            f"{name}: tensors must be on a CUDA device or the CPU, "
            f"got {q.device}"
        )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {q.dtype} unsupported; the kernels take "
            f"float32 or bfloat16"
        )
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"{name}: expected [B, H, S, D] with D in {HEAD_DIMS}, got "
            f"{tuple(q.shape)}"
        )
    for t in tensors:
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name}: q, k, v (and dO) must share shape, dtype and "
                f"device"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    for t in row_stats:
        if (t.shape != q.shape[:3] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"{name}: lse and delta must be contiguous float32 "
                f"{tuple(q.shape[:3])} on {q.device}"
            )
    b, h, s, d = q.shape
    return _DTYPE_CODES[q.dtype], b, h, s, d


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, causal, emit_lse):
    """Forward pass -> (out, lse or None). Kernel `flash_fwd_lse` when
    emit_lse (training), `flash_fwd` otherwise (inference)."""
    if q.device.type == "cpu":
        if emit_lse:
            return _fwd_plain(q, k, v, causal)
        return reference_attention(q, k, v, causal), None
    code, b, h, s, d = _check_cuda("flash_fwd", (q, k, v))
    out = torch.empty_like(q)
    lse = (
        torch.empty(b, h, s, dtype=torch.float32, device=q.device)
        if emit_lse else None
    )
    with torch.cuda.device(q.device):
        _build.call(
            "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr() if emit_lse else None,
            b * h, s, d, code, int(causal), d**-0.5, _stream(q),
        )
    _count("flash_fwd_lse" if emit_lse else "flash_fwd")
    return out, lse


def flash_dq(q, k, v, g, lse, delta, causal):
    """dQ pass (kernel `flash_dq`)."""
    if q.device.type == "cpu":
        return _dq_plain(q, k, v, g, lse, delta, causal)
    code, b, h, s, d = _check_cuda("flash_dq", (q, k, v, g), (lse, delta))
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.call(
            "flash_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b * h, s, d, code, int(causal), d**-0.5, _stream(q),
        )
    _count("flash_dq")
    return dq


def flash_dkv(q, k, v, g, lse, delta, causal):
    """dK/dV pass (kernel `flash_dkv`) -> (dk, dv)."""
    if q.device.type == "cpu":
        return _dkv_plain(q, k, v, g, lse, delta, causal)
    code, b, h, s, d = _check_cuda("flash_dkv", (q, k, v, g), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _build.call(
            "flash_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, s, d, code, int(causal), d**-0.5,
            _stream(q),
        )
    _count("flash_dkv")
    return dk, dv


# ---------- public API with autograd ----------


class FlashAttentionFunction(torch.autograd.Function):
    """Forward saves (q, k, v, out, lse); backward computes delta, then
    runs the dQ and dK/dV passes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal, emit_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        # The backward of a CUDA graph runs on the autograd engine's
        # device thread: its launches go to the forward thread's counter.
        ctx.counter = getattr(_thread, "counter", None)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = _delta(g, out)
        with counting_into(ctx.counter):
            dq = flash_dq(q, k, v, g, lse, delta, ctx.causal)
            dk, dv = flash_dkv(q, k, v, g, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """Attention over [B, H, S, D] (self-attention: q, k, v share a shape).
    Differentiable; without autograd (e.g. under torch.no_grad) it runs the
    forward without lse, as the JAX package's primal does."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal)
    return flash_fwd(q, k, v, causal, emit_lse=False)[0]
