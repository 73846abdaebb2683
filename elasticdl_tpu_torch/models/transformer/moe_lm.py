"""Switch-MoE decoder LM (counterpart of
elasticdl_tpu/models/transformer/moe_lm.py): the flagship family with every
`moe_every`-th block's dense FFN swapped for a SwitchMoE layer
(layers/moe.py: top-1 routing, fixed capacity, dispatch and combine by
index).

Output contract, as the JAX model's: in training mode (`self.training`) the
model returns {"logits", "aux_loss"}, aux_loss being the Switch
load-balancing terms summed over the expert blocks and ALREADY scaled by the
config's aux_loss_weight, so the spec's `loss` just adds it; in eval mode it
returns plain logits, so the master's chunked token_ce and the output
processors stay the dense LM's.

The dense blocks are transformer_lm's Block (attention through the flash
kernels), and the weights carry flax's names: flax counts Block_i and
MoEBlock_i separately (layers 0, 2, 4, ... are Block_0, Block_1, ...;
layers 1, 3, ... MoEBlock_0, MoEBlock_1, ... at moe_every=2), and the
expert layer is MoEBlock_k/SwitchMoE_0 with its router (a Dense kernel) and
the raw w_in/w_out params. The JAX model under remat names its blocks
CheckpointBlock_i and CheckpointMoEBlock_i; the port keeps the plain names.

`param_specs` lays the model out for DP x EP: the experts split over the
model axis (layers/moe.py:ExpertParallelMoE), the rest replicated.
"""

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from elasticdl_tpu_torch.layers import remat as remat_lib
from elasticdl_tpu_torch.layers.moe import SwitchMoE
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.models.transformer.transformer_lm import (
    Dense,
    Embed,
    LayerNorm,
    MultiHeadAttention,
    embed_input,
    head_output,
    init_lm_weights,
)


@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    max_len: int = 256
    num_experts: int = 4
    moe_every: int = 2  # every k-th block is an expert block
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    dropout: float = 0.0
    attention: Optional[Callable] = None
    activation_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: Optional[str] = None

    def __post_init__(self):
        tlm.validate_remat_policy(self.remat, self.remat_policy)
        if self.moe_every < 1:
            raise ValueError(
                f"moe_every must be >= 1, got {self.moe_every} (use the "
                f"dense transformer_lm for a model with no expert blocks)"
            )
        if self.num_experts < 2:
            raise ValueError(
                f"num_experts must be >= 2, got {self.num_experts}"
            )


def flagship_config(max_len: int = 4096) -> MoELMConfig:
    """The flagship's widths (vocab 32768, d_model 1024, 8 heads of 128, 12
    layers) with the config's own expert defaults: 4 experts in every
    second block, capacity factor 1.25, aux weight 1e-2; 373,481,496
    parameters. Remat off."""
    return MoELMConfig(vocab=32768, d_model=1024, n_heads=8, n_layers=12,
                       max_len=max_len)


class MoEBlock(nn.Module):
    """Transformer block whose FFN is a routed expert layer; returns
    (x, aux_loss)."""

    def __init__(self, config: MoELMConfig):
        super().__init__()
        cfg = self.config = config
        dtype = tlm._dtype(cfg)
        self.LayerNorm_0 = LayerNorm(cfg.d_model, dtype)
        self.MultiHeadAttention_0 = MultiHeadAttention(cfg)
        self.LayerNorm_1 = LayerNorm(cfg.d_model, dtype)
        self.SwitchMoE_0 = SwitchMoE(
            cfg.d_model, cfg.num_experts, 4 * cfg.d_model,
            cfg.capacity_factor, dtype)

    def forward(self, x):
        x = x + self.MultiHeadAttention_0(self.LayerNorm_0(x))
        out, aux = self.SwitchMoE_0(self.LayerNorm_1(x))
        if self.config.dropout:
            # Same regularization as the dense Block's FFN output.
            out = tlm.dropout(out, self.config.dropout, self.training)
        return x + out, aux


def _is_moe(config, i):
    return (i + 1) % config.moe_every == 0


class MoETransformerLM(nn.Module):
    def __init__(self, config: MoELMConfig = MoELMConfig()):
        super().__init__()
        cfg = self.config = config
        dtype = tlm._dtype(cfg)
        self.tok_emb = Embed(cfg.vocab, cfg.d_model, dtype)
        self.pos_emb = Embed(cfg.max_len, cfg.d_model, dtype)
        self.block_names = []
        counts = {"Block": 0, "MoEBlock": 0}
        for i in range(cfg.n_layers):
            kind, cls = (("MoEBlock", MoEBlock) if _is_moe(cfg, i)
                         else ("Block", tlm.Block))
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            self.add_module(name, cls(cfg))
            self.block_names.append(name)
        self.LayerNorm_0 = LayerNorm(cfg.d_model, dtype)
        self.lm_head = Dense(cfg.d_model, cfg.vocab, torch.float32)

    def forward(self, tokens):
        cfg = self.config
        x = embed_input(self, tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, name in enumerate(self.block_names):
            block = getattr(self, name)
            out = (remat_lib.remat_call(block, x, cfg.remat_policy,
                                        block.parameters())
                   if remat else block(x))
            if _is_moe(cfg, i):
                x, aux = out
                aux_total = aux_total + aux
            else:
                x = out
        logits = head_output(self, x)
        if not self.training:
            return logits
        # Pre-scaled by the instance config, so sweeping aux_loss_weight
        # takes effect in the spec loss.
        return {"logits": logits,
                "aux_loss": cfg.aux_loss_weight * aux_total}

    def init_weights(self, generator: torch.Generator):
        init_lm_weights(self, generator)


# ---------- model spec contract ----------


def custom_model(config: MoELMConfig = None):
    """The MoE LM on the meta device; the trainer materializes it."""
    with torch.device("meta"):
        return MoETransformerLM(config or MoELMConfig())


def loss(labels, outputs):
    """Next-token CE + the Switch load-balancing term (the model pre-scales
    it by its config's aux_loss_weight)."""
    return tlm.loss(labels, outputs["logits"]) + outputs["aux_loss"]


def optimizer():
    return tlm.optimizer()


def feed(records, mode, metadata):
    return tlm.feed(records, mode, metadata)


def param_specs(variables):
    """Model-spec hook for DP x EP (worker --model_parallel_size): over
    {wire name: array}, the expert weights w_in/w_out split over the
    "model" axis (parallel/tensor_parallel.py:moe_param_specs; each shard
    holds num_experts / mp experts), everything else replicated."""
    from elasticdl_tpu_torch.parallel.tensor_parallel import (
        moe_param_specs,
    )

    return moe_param_specs(variables)


def eval_metrics_fn():
    # Evaluation sees plain logits, so the dense LM's metrics apply.
    return tlm.eval_metrics_fn()
