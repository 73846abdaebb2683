"""Decoder-only transformer LM (counterpart of
elasticdl_tpu/models/transformer/transformer_lm.py), the long-context
flagship model.

The port reproduces the flax model's arithmetic, so weights moved through
common/params.py give the same outputs:
- bfloat16 activations (activation_dtype) with float32 parameters; a Dense
  casts its input, kernel and bias to the activation dtype, as flax
  Dense(dtype=...) does, with explicit casts (no autocast);
- LayerNorm computes its statistics in float32 with eps 1e-6 and
  Var = E[x^2] - E[x]^2 (flax's fast variance), then casts to the
  activation dtype;
- GELU is the tanh approximation (flax nn.gelu);
- attention runs in float32 through ops/flash_attention.py (the CUDA kernels
  on the card), and the LM head in float32.
Submodules carry flax's names (tok_emb, Block_0/MultiHeadAttention_0/qkv,
...), which is what the weight bridge relies on.

custom_model() returns the module on the meta device, without storage, as
flax's custom_model() returns an unbound module: the trainer materializes it
on its device and initializes it from its seed (init_weights) at the first
batch. Initializers follow flax's defaults (truncated-normal fan-in for
kernels and embeddings, zeros for biases, ones for LayerNorm scales), but
draw other numbers: parity with the JAX package needs imported weights.

Model spec contract (common/model_utils.py): custom_model / loss /
optimizer / feed / eval_metrics_fn, and the AllReduce trainer's hooks
param_specs (tensor parallelism) and context_parallel_model (sequence
parallelism).
"""

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from elasticdl_tpu_torch.common.evaluation_utils import MeanMetric
from elasticdl_tpu_torch.common.model_utils import Modes
from elasticdl_tpu_torch.data.example import batch_examples
from elasticdl_tpu_torch.ops import optimizers
from elasticdl_tpu_torch.ops.flash_attention import flash_attention
from elasticdl_tpu_torch.parallel import tensor_parallel as tp

VOCAB = 256
D_MODEL = 128
N_HEADS = 4
N_LAYERS = 2
MAX_LEN = 256
LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)
# flax's truncated-normal initializers divide the stddev by this, the std
# of a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978
# remat policies the port has: recompute everything (nn.remat's default).
REMAT_POLICIES = (None, "nothing_saveable")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int = VOCAB
    d_model: int = D_MODEL
    n_heads: int = N_HEADS
    n_layers: int = N_LAYERS
    max_len: int = MAX_LEN
    dropout: float = 0.0
    # attention(q, k, v) with causal masking baked in; None -> local flash.
    attention: Optional[Callable] = None
    activation_dtype: str = "bfloat16"
    # Recompute each Block in the backward pass (torch.utils.checkpoint, as
    # nn.remat(Block) does): activation memory O(layers), ~1/3 more FLOPs.
    remat: bool = False
    # A jax.checkpoint_policies name refining what remat saves; only the
    # save-nothing policies in REMAT_POLICIES are ported.
    remat_policy: Optional[str] = None

    def __post_init__(self):
        validate_remat_policy(self.remat, self.remat_policy)


def validate_remat_policy(remat, remat_policy):
    if remat_policy is not None and not remat:
        raise ValueError(
            "remat_policy is set but remat=False — the policy would be "
            "silently ignored; enable remat or drop the policy"
        )
    if remat_policy not in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {remat_policy!r} is not ported to "
            f"elasticdl_tpu_torch; it has {REMAT_POLICIES}"
        )


def flagship_config(max_len: int = 4096) -> LMConfig:
    """The flagship long-context config (222M parameters: vocab 32768,
    d_model 1024, 8 heads of 128, 12 layers), remat off."""
    return LMConfig(
        vocab=32768,
        d_model=1024,
        n_heads=8,
        n_layers=12,
        max_len=max_len,
        remat=False,
    )


def _default_attention(q, k, v):
    return flash_attention(q, k, v, True)


def _dtype(cfg):
    return getattr(torch, cfg.activation_dtype)


class Dense(nn.Linear):
    """flax Dense / DenseGeneral: input, kernel and bias cast to `dtype`.
    `features`, when given, is a DenseGeneral's output shape (the weight
    bridge reshapes its kernel to [in, *features])."""

    def __init__(self, in_features, out_features, dtype, features=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        if features is not None:
            self.features = tuple(features)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax LayerNorm: float32 statistics, fast variance, eps 1e-6."""

    def __init__(self, features, dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class MultiHeadAttention(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        cfg = self.config = config
        head_dim = cfg.d_model // cfg.n_heads
        dtype = _dtype(cfg)
        self.qkv = Dense(
            cfg.d_model, 3 * cfg.d_model, dtype,
            features=(3, cfg.n_heads, head_dim),
        )
        self.proj = Dense(cfg.d_model, cfg.d_model, dtype)

    def forward(self, x):
        cfg = self.config
        b, s, _ = x.shape
        # -1 heads: a tensor-parallel shard's qkv yields H / mp of them.
        qkv = self.qkv(x).view(b, s, 3, -1, cfg.d_model // cfg.n_heads)
        # [B, S, 3, H, Dh] -> three [B, H, S, Dh]
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        attend = cfg.attention or _default_attention
        # Softmax path in float32 for stability; back to compute dtype.
        out = attend(q.float(), k.float(), v.float()).to(x.dtype)
        out = out.transpose(1, 2).reshape(b, s, -1)
        return self.proj(out)


class Block(nn.Module):
    def __init__(self, config: LMConfig):
        super().__init__()
        cfg = self.config = config
        dtype = _dtype(cfg)
        self.LayerNorm_0 = LayerNorm(cfg.d_model, dtype)
        self.MultiHeadAttention_0 = MultiHeadAttention(cfg)
        self.LayerNorm_1 = LayerNorm(cfg.d_model, dtype)
        self.Dense_0 = Dense(cfg.d_model, 4 * cfg.d_model, dtype)
        self.Dense_1 = Dense(4 * cfg.d_model, cfg.d_model, dtype)

    def forward(self, x):
        x = x + self.MultiHeadAttention_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        h = self.Dense_1(h)
        if self.config.dropout:
            h = F.dropout(h, self.config.dropout, self.training)
        return x + h


class Embed(nn.Embedding):
    """flax Embed(dtype=...): the table cast to `dtype`, then the gather.
    A module call per table, so that automatic PS placement
    (common/model_handler.py) can move the table and hand in its rows."""

    def __init__(self, num_embeddings, features, dtype):
        # An empty table: the model initializes it after materializing
        # (init_lm_weights), and nn.Embedding's own normal_ on the meta
        # device would import torch._dynamo (8.8 s of a worker's start on
        # an H100 host, PERF.md).
        super().__init__(num_embeddings, features,
                         _weight=torch.empty(num_embeddings, features))
        self.compute_dtype = dtype

    def forward(self, ids):
        return F.embedding(ids.long(), self.weight.to(self.compute_dtype))


def embed_input(lm, tokens):
    """Token + positional embedding in the activation dtype. The positions
    are the ids arange(S), as the JAX LM looks them up; a sequence-parallel
    shard holds the block of S that starts at its `position_offset`. Under
    automatic PS placement both tables return the PS's float32 rows
    instead, and the residual stream is float32, as in the JAX package."""
    cfg = lm.config
    offset = getattr(lm, "position_offset", 0)
    s = tokens.shape[1]
    if offset + s > cfg.max_len:
        raise ValueError(
            f"sequence length {offset + s} exceeds max_len {cfg.max_len}"
        )
    x = lm.tok_emb(tokens)
    pos = lm.pos_emb(torch.arange(offset, offset + s, device=tokens.device))
    return x + pos[None]


def head_output(lm, x):
    """Final LayerNorm + LM head; logits in float32."""
    return lm.lm_head(lm.LayerNorm_0(x))


class TransformerLM(nn.Module):
    def __init__(self, config: LMConfig = LMConfig()):
        super().__init__()
        cfg = self.config = config
        self.tok_emb = Embed(cfg.vocab, cfg.d_model, _dtype(cfg))
        self.pos_emb = Embed(cfg.max_len, cfg.d_model, _dtype(cfg))
        for i in range(cfg.n_layers):
            setattr(self, f"Block_{i}", Block(cfg))
        self.LayerNorm_0 = LayerNorm(cfg.d_model, _dtype(cfg))
        self.lm_head = Dense(cfg.d_model, cfg.vocab, torch.float32)

    def forward(self, tokens):
        x = embed_input(self, tokens)
        remat = self.config.remat and torch.is_grad_enabled()
        for i in range(self.config.n_layers):
            block = getattr(self, f"Block_{i}")
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return head_output(self, x)

    def init_weights(self, generator: torch.Generator):
        init_lm_weights(self, generator)


@torch.no_grad()
def init_lm_weights(model, generator):
    """flax's default initializers on an LM, drawn from `generator` (which
    must live on the parameters' device); a module with initializers of its
    own (layers/moe.py's SwitchMoE experts) applies them through its
    `init_flax(generator)`."""

    def trunc_normal(w, fan_in):
        std = fan_in**-0.5 / _TRUNC_STD
        nn.init.trunc_normal_(
            w, std=std, a=-2 * std, b=2 * std, generator=generator
        )

    for mod in model.modules():
        if isinstance(mod, nn.Embedding):
            trunc_normal(mod.weight, mod.embedding_dim)
        elif isinstance(mod, nn.Linear):
            trunc_normal(mod.weight, mod.in_features)
            mod.bias.zero_()
        elif isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif hasattr(mod, "init_flax"):
            mod.init_flax(generator)


# ---------- model spec contract ----------


def custom_model(config: LMConfig = None):
    """The LM on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return TransformerLM(config or LMConfig())


def loss(labels, logits):
    """Next-token CE; labels [B, S] int, logits [B, S, V]. A
    tensor-parallel shard's head hands over its vocabulary slice (a
    VocabShard), and the CE is then taken vocab-parallel."""
    if isinstance(logits, tp.VocabShard):
        return tp.vocab_parallel_cross_entropy(logits, labels).mean()
    return F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        labels.reshape(-1).long(),
    )


def optimizer():
    return optimizers.adam(learning_rate=3e-4)


def param_specs(variables):
    """Model-spec hook for hybrid DP x TP (worker --model_parallel_size):
    the Megatron layout over the "model" axis for {wire name: array} (the
    flax-named state of common/params.py), everything else replicated."""
    return tp.transformer_param_specs(variables)


def context_parallel_model(group, head_axis=None, impl="zigzag",
                           config=None):
    """Model-spec hook for sequence/context parallelism (worker
    --context_parallel_size): the LM with its attention bound to a seq
    axis group (parallel/distributed.py:AxisGroup) — zigzag ring
    (balanced causal ring, parallel/ring_attention.py), plain ring, or
    Ulysses all-to-all (parallel/ulysses.py). The attention callable is
    parameterless, so the param tree is IDENTICAL to the plain LM's:
    elastic transitions between SP worlds and pure-DP worlds carry
    (params, opt_state) untouched, and checkpoints are interchangeable.
    head_axis names a tensor-parallel axis that also shards the heads
    (ring only: each model shard runs its own ring over its heads) for the
    3-D DP x TP x SP composition."""
    cfg = config or LMConfig()
    if impl == "zigzag":
        from elasticdl_tpu_torch.parallel.ring_attention import (
            zigzag_ring_attention,
        )

        attn = functools.partial(zigzag_ring_attention, group=group,
                                 causal=True)
    elif impl == "ring":
        from elasticdl_tpu_torch.parallel.ring_attention import (
            ring_attention,
        )

        attn = functools.partial(ring_attention, group=group, causal=True)
    elif impl == "ulysses":
        if head_axis is not None:
            raise ValueError(
                "ulysses re-shards heads itself (all-to-all) and cannot "
                "also shard them over a tensor-parallel axis; use "
                "impl='zigzag' for the 3-D composition"
            )
        from elasticdl_tpu_torch.parallel.ulysses import ulysses_attention

        attn = functools.partial(ulysses_attention, group=group,
                                 causal=True)
    else:
        raise ValueError(f"unknown context-parallel impl {impl!r}")
    return custom_model(dataclasses.replace(cfg, attention=attn))


def feed(records, mode, metadata):
    """Serialized Example records, each {"tokens": int[S+1]}, ->
    (features, labels), as the worker loop hands them over."""
    batch = batch_examples(records)
    tokens = batch["tokens"].astype(np.int32)  # [B, S+1]
    features = tokens[:, :-1]
    labels = tokens[:, 1:] if mode != Modes.PREDICTION else None
    return features, labels


# Rows of logits per chunk of token_ce: 64 rows at the flagship's vocab
# (32768) are an 8 MiB scratch buffer, which stays in the host's cache.
TOKEN_CE_CHUNK_ELEMS = 1 << 21


def token_ce(outputs, labels):
    """Per-token CE from logits [..., V] (numpy; eval-metric building
    block) -> [..., 1] float32. One pass over the logits in chunks of rows,
    each shifted by its maximum, exponentiated and summed in one scratch
    buffer: no temporary of the logits' size."""
    logits = np.asarray(outputs, np.float32)
    labels = np.asarray(labels).astype(np.int64)
    vocab = logits.shape[-1]
    flat = logits.reshape(-1, vocab)
    flat_labels = labels.reshape(-1)
    out = np.empty(flat_labels.shape, np.float32)
    chunk = max(1, TOKEN_CE_CHUNK_ELEMS // vocab)
    scratch = np.empty((min(chunk, len(flat)), vocab), np.float32)
    for start in range(0, len(flat), chunk):
        rows = flat[start:start + chunk]
        shifted = scratch[:len(rows)]
        np.subtract(rows, rows.max(-1, keepdims=True), out=shifted)
        picked = np.take_along_axis(
            shifted, flat_labels[start:start + chunk, None], -1)[:, 0]
        np.exp(shifted, out=shifted)
        out[start:start + len(rows)] = np.log(shifted.sum(-1)) - picked
    return out.reshape(labels.shape + (1,))


def token_ce_plain(outputs, labels):
    """The unchunked token_ce (the JAX package's formula), its plain
    reference in the tests."""
    logits = np.asarray(outputs, np.float32)
    labels = np.asarray(labels).astype(np.int64)
    logits = logits - logits.max(-1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return -np.take_along_axis(logp, labels[..., None], -1)


def eval_metrics_fn():
    return {"token_ce": MeanMetric(token_ce)}
