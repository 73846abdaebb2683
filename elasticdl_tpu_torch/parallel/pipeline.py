"""Pipeline parallelism over the intra-process stage axis (counterpart of
elasticdl_tpu/parallel/pipeline.py): GPipe, 1F1B and, in
pipeline_interleaved.py, interleaved 1F1B.

The JAX package runs a schedule as one SPMD program: a lax.scan over ticks
inside shard_map, every device computing (and masking) every slot, the
hops ppermutes on the ICI. The port runs each stage in a thread of its
own (parallel/shards.py: a process's stage x data positions, shard i on
cuda:(i mod count)), over a gloo group of the stage axis
(parallel/distributed.py:AxisGroup). A stage knows the static schedule,
so it runs only its own slots and sends only what a neighbour will
consume: an idle slot does no work and sends nothing, where JAX computes
masked zeros. The result is the same. Every hop names its (kind, chunk,
microbatch) in its tag, and both sides post it from the same tick of the
same tables, so neighbours never wait on each other's order.

- GPipe (`pipeline_apply`, `make_pipeline`, `make_lm_pipeline`): stage 0
  takes fresh microbatches, each tick every stage runs the stage function
  of the microbatch that reached it, activations hop forward, and the last
  stage banks the outputs, broadcast to every stage. The backward follows
  through autograd: one differentiable op per stage (collectives.py:
  with_backward) whose backward walks the ticks in reverse, each stage's
  saved graph of each microbatch giving its parameter and input gradients
  and the input gradient hopping back. Every stage must differentiate the
  same function of the replicated outputs (the JAX contract: one loss);
  the last stage's own output gradient seeds the backward, the others'
  are not read. Activations of every microbatch stay alive to the
  backward: O(M) per stage, as scan autodiff banks them.
- 1F1B (`make_lm_pipeline_1f1b`): T = M + 2(N-1) ticks; stage i runs the
  forward of microbatch m at tick m + i without autograd, and its backward
  at tick m + 2(N-1) - i by recomputing the stage's forward under
  autograd (JAX's jax.vjp), so a stage keeps only the inputs of its
  microbatches in flight: a stash 2N deep, O(stages) whatever M is. The
  embedding is folded into stage 0. The LM head is vocab-parallel over the
  stage group (`vocab_parallel_head_loss`): the last stage's output is
  broadcast, each stage computes its V/N slice of the logits, the
  log-sum-exp and the label logit are all-reduced. Its gradient
  conventions are the model axis' (collectives.py): the sums are
  reduce_from (all-reduce forward, identity backward), so each stage's
  logits gradient is exactly its slice of the true one, the output
  gradient's parts are summed over the stage group in float32 and the
  head's gradients are each stage's part: no factor of N (the JAX code
  divides by N because psum transposes to psum under
  shard_map(check_vma=False)).
- `make_lm_sequential`: the schedule-free forward over the staged tree,
  for evaluation, prediction, export and a world that cannot host the
  stage axis.

A stage's gradients land in its copy's `.grad`, and summed over the stage
group they are the step's: each stage row's on the stage that holds it,
the embedding's on stage 0, the head's on the last stage (GPipe) or in
parts on every stage (1F1B, interleaved). The trainer gathers them into
the process's staged tree (parallel/shards.py).

The staged tree (`StagedLM`) is the JAX package's {"embed", "stages",
"head"}: every leaf of a stage row stacked over rows in layer order, one
parameter per wire name (common/params.py), so the checkpoints, the
rank-0 sync and the optimizer state carry it as they carry any model.
"""

import collections
import hashlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from elasticdl_tpu_torch.layers.remat import remat_call
from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
from elasticdl_tpu_torch.parallel.collectives import reduce_from, with_backward
from elasticdl_tpu_torch.parallel.mesh import (  # noqa: F401 - one copy
    STAGE_AXIS,
    data_shard,
    microbatch,
    stage_axis_demand,
    unmicrobatch,
)

# What a model spec's `pipeline_spec(...)` hook hands the AllReduce trainer
# (worker --pipeline_stages; the stage-hook twin of the param_specs hook):
#   init_fn() -> the staged model on the meta device, as custom_model()
#       returns a model: the trainer materializes it and draws its weights
#       from its seed
#   loss_and_grads_fn(model, features, labels, group, rng=None,
#       data_index=0, stats=None) -> loss: one stage's part of the
#       scheduled step, in that stage's thread, over its stage `group`;
#       `model` holds the stage's rows (stage_rows_fn), the embedding and
#       the head, and the step's gradients are left in its `.grad`
#   apply_fn(model, features) -> outputs: schedule-free forward over the
#       whole staged model, valid in any world; kept to match the JAX
#       hook's signature (the staged model's own forward is this apply, and
#       the trainer calls the model)
#   param_specs_fn(variables) -> {wire name: spec} for the staged tree
#   stage_rows_fn(stage) -> the stage rows that stage holds, in its order
PipelineBuild = collections.namedtuple(
    "PipelineBuild",
    ["init_fn", "loss_and_grads_fn", "apply_fn", "param_specs_fn",
     "stage_rows_fn"],
)


def stack_stage_params(per_stage):
    """List of per-stage {name: tensor} -> one {name: tensor} with a
    leading stage dim (what pipeline_apply takes)."""
    return {k: torch.stack([p[k] for p in per_stage]) for k in per_stage[0]}


def _tag(kind, chunk, micro, num_micro):
    """A hop's gloo tag: its kind (0 activation, 1 gradient), chunk and
    microbatch."""
    return (kind << 24) | (chunk * num_micro + micro)


def _seed(rng, *coords):
    """A dropout seed from the step's rng and a slot's coordinates."""
    text = ":".join(str(int(c)) for c in (rng, *coords))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") & ((1 << 63) - 1)


# ---------- GPipe ----------


def pipeline_apply(stage_fn, stage_params, x_micro, group, rng=None,
                   data_index=0):
    """Runs microbatches through the pipeline: call in every stage's
    thread, each with its member of the stage `group`.

    stage_fn(params, x) -> y shaped like x (the inter-stage contract), or
      (params, x, seed) when `rng` is given, seed distinct per (stage,
      microbatch, data position) so that stochastic layers draw
      independent bits.
    stage_params: {name: tensor} with a leading stage dim; the stage takes
      its own row.
    x_micro: [M, mb, ...]; only stage 0 reads its values (the others its
      shape and dtype).
    Returns [M, mb, ...] outputs on every stage (the last stage's,
    broadcast). Differentiable: see the module docstring.
    """
    lead = next(iter(stage_params.values())).shape[0]
    if lead != group.size:
        raise ValueError(
            f"stage_params leading dim {lead} != stage group size "
            f"{group.size}")
    own = {k: v[group.rank] for k, v in stage_params.items()}
    return _gpipe(stage_fn, own, x_micro, group, rng, data_index)


def _gpipe(stage_fn, params, x_micro, group, rng=None, data_index=0,
           replicate=True):
    """pipeline_apply's schedule over this stage's own `params`. With
    `replicate` off only the last stage returns the outputs, and the
    others an empty placeholder (a caller that reads the last stage's
    outputs alone skips the broadcast)."""
    n, stage = group.size, group.rank
    names = sorted(params)
    tensors = [params[k] for k in names]
    num_micro = x_micro.shape[0]
    ticks = num_micro + n - 1
    like = x_micro[0]
    track = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x_micro] + tensors)
    graphs = {}
    leaves = {}

    def call(p, x, m):
        if rng is None:
            return stage_fn(p, x)
        return stage_fn(p, x, _seed(rng, stage, m, data_index))

    def forward(x_micro, *tensors):
        leaves.update({k: t.detach().requires_grad_(t.requires_grad)
                       for k, t in zip(names, tensors)})
        bank = [None] * num_micro
        received = None
        with torch.set_grad_enabled(track):
            for t in range(ticks):
                m = t - stage
                y = None
                if 0 <= m < num_micro:
                    x = x_micro[m] if stage == 0 else received
                    x = x.detach().requires_grad_(
                        track and (stage > 0 or x_micro.requires_grad))
                    y = call(leaves, x, m)
                    if track:
                        graphs[m] = (x, y)
                    if stage == n - 1:
                        bank[m] = y.detach()
                sends = ([(y.detach(), stage + 1, _tag(0, 0, m, num_micro))]
                         if y is not None and stage < n - 1 else [])
                nxt = t + 1 - stage
                recvs = ([(like, stage - 1, _tag(0, 0, nxt, num_micro))]
                         if stage > 0 and 0 <= nxt < num_micro else [])
                got = group.p2p(sends, recvs)
                received = got[0] if recvs else None
        if stage == n - 1:
            out = torch.stack(bank)
        elif replicate:
            out = torch.empty((num_micro, *like.shape), dtype=like.dtype,
                              device=like.device)
        else:
            return torch.empty((0,), dtype=like.dtype, device=like.device)
        return group.broadcast(out, n - 1) if replicate else out

    def backward(g):
        wrt = [leaves[k] for k in names if leaves[k].requires_grad]
        sums = [None] * len(wrt)
        dx_micro = (torch.zeros_like(x_micro)
                    if stage == 0 and x_micro.requires_grad else None)
        received = None
        for u in range(ticks):
            # Tick u of the mirrored schedule: the last stage takes the
            # last microbatch first.
            m = num_micro - 1 - u + (n - 1 - stage)
            dx = None
            if 0 <= m < num_micro:
                x, y = graphs.pop(m)
                gy = g[m] if stage == n - 1 else received
                inputs = wrt + ([x] if x.requires_grad else [])
                got = torch.autograd.grad(y, inputs, gy, allow_unused=True)
                for j, gp in enumerate(got[:len(wrt)]):
                    if gp is not None:
                        sums[j] = gp if sums[j] is None else sums[j] + gp
                if x.requires_grad:
                    dx = got[-1]
                    if dx_micro is not None:
                        dx_micro[m] = dx
            sends = ([(dx, stage - 1, _tag(1, 0, m, num_micro))]
                     if dx is not None and stage > 0 else [])
            prev = m - 1
            recvs = ([(like, stage + 1, _tag(1, 0, prev, num_micro))]
                     if stage < n - 1 and 0 <= prev < num_micro
                     and u + 1 < ticks else [])
            got = group.p2p(sends, recvs)
            received = got[0] if recvs else None
        grads = iter(sums)
        return (dx_micro, *[next(grads) if leaves[k].requires_grad else None
                            for k in names])

    return with_backward(forward, backward, x_micro, *tensors)


def _rematerialized(stage_fn, remat, remat_policy):
    """stage_fn, rematerialized under remat_policy (layers/remat.py) when
    `remat`, as JAX wraps it in jax.checkpoint."""
    if not remat:
        return stage_fn

    def fn(p, x, *seed):
        return remat_call(lambda xx: stage_fn(p, xx, *seed), x,
                          remat_policy, p.values())

    return fn


def make_pipeline(stage_fn, remat=False, remat_policy=None):
    """pipeline_apply over stage_fn, rematerialized when `remat`: returns
    run(stage_params, x_micro, group, rng=None, data_index=0)."""
    stage_fn = _rematerialized(stage_fn, remat, remat_policy)

    def run(stage_params, x_micro, group, rng=None, data_index=0):
        return pipeline_apply(stage_fn, stage_params, x_micro, group, rng,
                              data_index)

    return run


# ---------- the staged LM ----------


class _EmbedIn(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.config = cfg
        self.tok_emb = tlm.Embed(cfg.vocab, cfg.d_model, tlm._dtype(cfg))
        self.pos_emb = tlm.Embed(cfg.max_len, cfg.d_model, tlm._dtype(cfg))

    def forward(self, tokens):
        return tlm.embed_input(self, tokens)


class _HeadOut(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.LayerNorm_0 = tlm.LayerNorm(cfg.d_model, tlm._dtype(cfg))
        self.lm_head = tlm.Dense(cfg.d_model, cfg.vocab, torch.float32)

    def forward(self, x):
        return tlm.head_output(self, x)


class _Row(nn.Module):
    """One stage row: `per_row` Blocks (JAX's Stage module)."""

    def __init__(self, cfg, per_row):
        super().__init__()
        for j in range(per_row):
            setattr(self, f"Block_{j}", tlm.Block(cfg))
        self.per_row = per_row

    def forward(self, x):
        for j in range(self.per_row):
            x = getattr(self, f"Block_{j}")(x)
        return x


class _StackedRows(nn.Module):
    """A row's module tree whose every parameter is stacked over rows,
    [rows, *shape] (`stacked_rows`: common/params.py lays each row out as
    flax does)."""

    def __init__(self, cfg, per_row, n_rows):
        super().__init__()
        for name, child in _Row(cfg, per_row).named_children():
            self.add_module(name, child)
        for mod in self.modules():
            mod.stacked_rows = True
            for pname, p in list(mod._parameters.items()):
                mod._parameters[pname] = nn.Parameter(torch.empty(
                    n_rows, *p.shape, dtype=p.dtype, device=p.device))


class StagedLM(nn.Module):
    """The pipelined flagship's param tree as a module: `embed`, `stages`
    (the rows in `row_ids`, stacked) and `head`. Its forward is the
    schedule-free sequential apply over its rows (make_lm_sequential)."""

    def __init__(self, config, total_rows, rows=None):
        super().__init__()
        cfg = self.config = config
        _check_rows(cfg, total_rows, f"{total_rows} stage rows")
        self.total_rows = total_rows
        self.per_row = cfg.n_layers // total_rows
        self.row_ids = list(range(total_rows) if rows is None else rows)
        self.embed = _EmbedIn(cfg)
        self.stages = _StackedRows(cfg, self.per_row, len(self.row_ids))
        self.head = _HeadOut(cfg)
        # The functional row every stacked row runs through (outside the
        # module tree: its parameters are the stacked ones' slices).
        with torch.device("meta"):
            self._row = [_Row(cfg, self.per_row)]

    def rows_forward(self, x, rows=None, params=None):
        """The local rows `rows` (all, in order, by default) over x, with
        the stacked `params` ({name: [rows, ...]}; the module's own by
        default)."""
        if params is None:
            params = dict(self.stages.named_parameters())
        row = self._row[0].train(self.training)
        for r in range(len(self.row_ids)) if rows is None else rows:
            x = torch.func.functional_call(
                row, {k: v[r] for k, v in params.items()}, (x,))
        return x

    def forward(self, tokens):
        return self.head(self.rows_forward(self.embed(tokens)))

    def init_weights(self, generator):
        tlm.init_lm_weights(self, generator)

    def stage_copy(self, rows):
        """The same tree holding only `rows`, on the meta device."""
        with torch.device("meta"):
            return StagedLM(self.config, self.total_rows, rows)


def _check_rows(cfg, total_rows, what):
    if cfg.n_layers % total_rows:
        raise ValueError(
            f"n_layers {cfg.n_layers} not divisible by {what}")


def _check_vocab(cfg, n_stages, what):
    if cfg.vocab % n_stages:
        raise ValueError(
            f"vocab {cfg.vocab} not divisible by {n_stages} stages "
            f"({what} is vocab-parallel over the stage axis)"
        )


def _own_row(stage):
    """The rows of a GPipe or 1F1B stage: its own."""
    return [stage]


def make_lm_pipeline(cfg, n_stages, num_microbatches, loss_fn=None):
    """A pipelined build of the flagship LM under GPipe: the embedding and
    the head run outside the pipeline, the Block stack splits into
    `n_stages` rows. Returns (init_fn, loss_and_grads_fn, stage_rows_fn).
    The embedding runs on every stage (stage 0's feeds the pipeline), the
    head and the loss on the last stage, whose loss every stage returns."""
    _check_rows(cfg, n_stages, f"{n_stages} stages")
    loss_fn = loss_fn or tlm.loss

    def init_fn():
        with torch.device("meta"):
            return StagedLM(cfg, n_stages)

    def loss_and_grads_fn(model, tokens, labels, group, rng=None,
                          data_index=0, stats=None):
        if cfg.dropout and model.training and rng is None:
            raise ValueError(
                "training with cfg.dropout > 0 requires an rng (per-stage "
                "and microbatch seeds are derived inside the pipeline)"
            )
        device = model.head.lm_head.weight.device
        tokens = torch.as_tensor(np.asarray(tokens)).to(device)
        x_micro = microbatch(model.embed(tokens), num_microbatches)

        def stage_fn(params, x, *seed):
            if not seed:
                return model.rows_forward(x, params=params)
            with tlm.dropout_seed(seed[0], x.device):
                return model.rows_forward(x, params=params)

        y = _gpipe(_rematerialized(stage_fn, cfg.remat, cfg.remat_policy),
                   dict(model.stages.named_parameters()), x_micro, group,
                   rng, data_index, replicate=False)
        last = group.size - 1
        if group.rank == last:
            labels = torch.as_tensor(np.asarray(labels)).to(device)
            loss = loss_fn(labels, model.head(unmicrobatch(y)))
            loss.backward()
            loss = loss.detach().reshape(1)
        else:
            # The other stages hold an empty placeholder: differentiating
            # it runs their part of the backward schedule.
            torch.autograd.backward(y, torch.zeros_like(y))
            loss = torch.empty(1, device=device)
        return group.broadcast(loss, last)[0]

    return init_fn, loss_and_grads_fn, _own_row


def make_lm_sequential(cfg, total_rows):
    """Schedule-free forward over the staged tree: embed, the rows in
    order, head. Mathematically the plain LM (the stacked rows are the
    layer stack in order: GPipe and 1F1B stack stages 0..N-1, the
    interleaved build keeps its rows in chunk order). Needs no stage axis:
    evaluation and prediction, export, and the trainer's pure-DP fallback
    where a world cannot host the stage axis, on the same tree.

    total_rows: rows of the tree (n_stages, or n_stages * virtual chunks
    for the interleaved build)."""
    _check_rows(cfg, total_rows, f"{total_rows} stage rows")

    def apply_fn(model, tokens):
        return model(tokens)

    return apply_fn


# ---------- 1F1B ----------


def vocab_parallel_head_loss(head, y, labels_m, group):
    """Vocab-parallel CE for one microbatch, shared by the 1F1B and
    interleaved schedules: each stage computes its [V/N] slice of the
    logits; a max and sums over the stage group assemble the log-sum-exp
    and the label logit. Returns the microbatch's mean CE (every stage's
    the same). The max only stabilizes the exp and takes no gradient; the
    sums are reduce_from (all-reduce forward, identity backward), so this
    stage's gradients are exactly its slice's part."""
    n, s = group.size, group.rank
    v_loc = head.lm_head.weight.shape[0] // n
    z = head.LayerNorm_0(y).float()
    w = head.lm_head.weight[s * v_loc:(s + 1) * v_loc].float()
    b = head.lm_head.bias[s * v_loc:(s + 1) * v_loc].float()
    logits = F.linear(z, w, b)  # [mb, S, v_loc]
    m_glob = group.all_reduce(logits.detach().amax(-1).contiguous(),
                              op="max")
    sumexp = torch.exp(logits - m_glob[..., None]).sum(-1)
    lse = m_glob + torch.log(reduce_from(sumexp, group))
    rel = labels_m.long() - s * v_loc
    in_range = (rel >= 0) & (rel < v_loc)
    gathered = logits.gather(-1, rel.clamp(0, v_loc - 1)[..., None])[..., 0]
    label_logit = reduce_from(
        torch.where(in_range, gathered, torch.zeros_like(gathered)), group)
    return (lse - label_logit).mean()


def _head_slot(model, y, like, labels_m, group, scale, src):
    """The head of one microbatch on every stage: src's output y broadcast
    (the others pass None; `like` gives its shape), this stage's vocabulary
    slice forward and backward (its head gradients accumulated, scaled by
    `scale`), the output gradient's parts summed in float32. Returns
    (loss, dy on every stage)."""
    y_last = group.broadcast(like if y is None else y, src)
    leaf = y_last.detach().float().requires_grad_()
    with torch.enable_grad():
        loss = vocab_parallel_head_loss(model.head, leaf, labels_m, group)
        (loss * scale).backward()
    return loss.detach(), group.all_reduce(leaf.grad)


def _stage_forward(model, rows, x_in, tokens_m, seed):
    """One stage's (or chunk's) rows over its input; stage 0's input is its
    tokens' embedding (the embedding folded into stage 0)."""
    def run():
        h = model.embed(tokens_m) if x_in is None else x_in
        return model.rows_forward(h, rows)

    if seed is None:
        return run()
    with tlm.dropout_seed(seed, tokens_m.device):
        return run()


def _stage_backward(model, rows, x_b, tokens_m, seed, g):
    """The backward slot: the stage's forward recomputed under autograd
    from its stashed input, its gradients accumulated; returns the input's
    gradient (None on the first stage, which embeds)."""
    with torch.enable_grad():
        x = None if x_b is None else x_b.detach().requires_grad_()
        y = _stage_forward(model, rows, x, tokens_m, seed)
        torch.autograd.backward(y, g)
    return None if x is None else x.grad


def _to_device(model, tokens, labels, num_microbatches):
    device = model.head.lm_head.weight.device
    tokens = torch.as_tensor(np.asarray(tokens)).to(device)
    labels = torch.as_tensor(np.asarray(labels)).to(device)
    return (microbatch(tokens, num_microbatches),
            microbatch(labels, num_microbatches))


def _activation_like(cfg, tokens_mb):
    """An (uninitialized) activation of one microbatch: what a hop
    receives."""
    mb, seq = tokens_mb.shape[1], tokens_mb.shape[2]
    return torch.empty((mb, seq, cfg.d_model), dtype=tlm._dtype(cfg),
                       device=tokens_mb.device)


def _require_rng(cfg, rng):
    if cfg.dropout and rng is None:
        raise ValueError(
            "training with cfg.dropout > 0 requires an explicit rng "
            "(per-stage/microbatch keys are derived inside the pipeline)"
        )


def make_lm_pipeline_1f1b(cfg, n_stages, num_microbatches):
    """1F1B-scheduled pipelined LM training: returns (init_fn,
    loss_and_grads_fn, stage_rows_fn) over make_lm_pipeline's tree (the
    init functions are interchangeable). See the module docstring for the
    schedule, the stash and the head."""
    _check_rows(cfg, n_stages, f"{n_stages} stages")
    _check_vocab(cfg, n_stages, "the 1F1B head")
    dtype = tlm._dtype(cfg)

    def init_fn():
        with torch.device("meta"):
            return StagedLM(cfg, n_stages)

    def loss_and_grads_fn(model, tokens, labels, group, rng=None,
                          data_index=0, stats=None):
        _require_rng(cfg, rng)
        n, s = group.size, group.rank
        num_micro = num_microbatches
        tokens_mb, labels_mb = _to_device(model, tokens, labels, num_micro)
        like = _activation_like(cfg, tokens_mb)
        depth = 2 * n
        stash = [None] * depth
        live = peak = 0
        inbox_f, inbox_b = {}, {}
        loss_sum = torch.zeros((), device=tokens_mb.device)

        def seed(m):
            return None if rng is None else _seed(rng, s, m, data_index)

        for t in range(num_micro + 2 * (n - 1)):
            # ---- forward slot: microbatch t - s ----
            m_f = t - s
            y = None
            if 0 <= m_f < num_micro:
                x_in = None if s == 0 else inbox_f.pop(m_f)
                with torch.no_grad():
                    y = _stage_forward(model, None, x_in, tokens_mb[m_f],
                                       seed(m_f))
                stash[m_f % depth] = (m_f, x_in)
                live += 1
                peak = max(peak, live)
            # ---- head slot: the microbatch that just left the last stage
            m_h = t - (n - 1)
            g_last = None
            if 0 <= m_h < num_micro:
                loss_m, dy = _head_slot(
                    model, y if s == n - 1 else None, like, labels_mb[m_h],
                    group, 1.0 / num_micro, n - 1)
                loss_sum = loss_sum + loss_m / num_micro
                g_last = dy.to(dtype)
            # ---- backward slot: microbatch t - 2(N-1) + s ----
            m_b = t - 2 * (n - 1) + s
            dx = None
            if 0 <= m_b < num_micro:
                m_stashed, x_b = stash[m_b % depth]
                assert m_stashed == m_b, (m_stashed, m_b)
                stash[m_b % depth] = None
                live -= 1
                g = g_last if s == n - 1 else inbox_b.pop(m_b)
                dx = _stage_backward(model, None, x_b, tokens_mb[m_b],
                                     seed(m_b), g)
            # ---- neighbour hops ----
            sends, recvs = [], []
            if y is not None and s < n - 1:
                sends.append((y, s + 1, _tag(0, 0, m_f, num_micro)))
            if dx is not None:
                sends.append((dx.to(dtype), s - 1,
                              _tag(1, 0, m_b, num_micro)))
            nxt_f = t + 1 - s
            if s > 0 and 0 <= nxt_f < num_micro:
                recvs.append((like, s - 1, _tag(0, 0, nxt_f, num_micro)))
            nxt_b = t + 1 - 2 * (n - 1) + s
            if s < n - 1 and 0 <= nxt_b < num_micro:
                recvs.append((like, s + 1, _tag(1, 0, nxt_b, num_micro)))
            got = iter(group.p2p(sends, recvs))
            if s > 0 and 0 <= nxt_f < num_micro:
                inbox_f[nxt_f] = next(got)
            if s < n - 1 and 0 <= nxt_b < num_micro:
                inbox_b[nxt_b] = next(got)
        if stats is not None:
            stats.update(stash_depth=depth, stash_peak=peak)
        return loss_sum

    return init_fn, loss_and_grads_fn, _own_row


def lm_pipeline_param_specs(variables, axis_name=STAGE_AXIS):
    """Specs of the staged tree's {wire name: array}: the stage rows split
    over the stage axis on their stacked leading dim, embed and head
    replicated."""
    return {name: ((axis_name,) + (None,) * (np.ndim(v) - 1)
                   if name.startswith("stages/") else ())
            for name, v in variables.items()}
