"""The port's CUDA flash-attention kernels on the card, against their plain
PyTorch versions. Each test skips without a CUDA device; the kernels have no
CPU mode. This file imports nothing of JAX, so it runs on a machine without
it; there, skip the JAX-importing conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu
"""

import collections

import pytest
import torch

from elasticdl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

# float32: the same arithmetic summed in another order. bfloat16: outputs
# rounded to an 8-bit mantissa on both sides, values up to magnitude ~2.
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, n=4, requires_grad=False):
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [
        torch.randn(shape, device="cuda", generator=gen).to(dtype)
        .requires_grad_(requires_grad)
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "shape,causal,dtype",
    [
        ((1, 2, 300, 128), True, torch.float32),
        ((2, 3, 1000, 64), False, torch.float32),
        ((1, 2, 333, 128), True, torch.bfloat16),
        ((1, 1, 1, 64), True, torch.float32),  # one row of one tile
        ((3, 2, 17, 128), False, torch.bfloat16),
        ((2, 3, 200, 32), True, torch.float32),
        ((1, 2, 333, 32), False, torch.bfloat16),
    ],
)
def test_kernels_match_plain(cuda, shape, causal, dtype):
    q, k, v, g = _inputs(shape, dtype)
    fa.reset_launch_counts()
    out, lse = fa.flash_fwd(q, k, v, causal, emit_lse=True)
    delta = fa._delta(g, out)
    got = (out, lse, fa.flash_dq(q, k, v, g, lse, delta, causal),
           *fa.flash_dkv(q, k, v, g, lse, delta, causal))
    want = (*fa._fwd_plain(q, k, v, causal),
            fa._dq_plain(q, k, v, g, lse, delta, causal),
            *fa._dkv_plain(q, k, v, g, lse, delta, causal))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=ATOL[dtype],
                                   rtol=0)
    assert fa.launches == {"flash_fwd_lse": 1, "flash_dq": 1, "flash_dkv": 1}


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_plain_autograd(cuda, causal):
    """The autograd Function (forward with lse, delta, dQ and dK/dV
    kernels) against torch autograd through the plain forward, on
    non-contiguous inputs as the model hands them over."""
    base = _inputs((2, 200, 3, 128), torch.float32, n=1)[0]
    g = _inputs((2, 3, 200, 128), torch.float32, n=1)[0]
    grads = []
    for attend in (fa.flash_attention, fa.reference_attention):
        x = base.clone().requires_grad_()
        q = x.transpose(1, 2)  # [B, H, S, D], not contiguous
        out = attend(q, q * 0.5, q.flip(-1), causal)
        out.backward(g)
        grads.append((out.detach(), x.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(grads[0][1], grads[1][1], atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl,causal,n", [
    ("ring", False, 2), ("ring", True, 2), ("ring", True, 3),
    ("zigzag", True, 2)])
def test_ring_blocks_match_the_plain_merge(cuda, impl, causal, n):
    """Ring and zigzag attention over a seq group of n members (threads,
    gloo through pinned host buffers), every block on the kernels, against
    the JAX module's blockwise fold (ring_attention_plain) under torch
    autograd; each member launches the forward, dQ and dK/dV kernels once
    per block it may see."""
    from elasticdl_tpu_torch.parallel import ring_attention as ra
    from elasticdl_tpu_torch.parallel.shards import run_group

    q, k, v, g = _inputs((1, 2, 96 * n, 128), torch.float32)
    fn = ra.ring_attention if impl == "ring" else ra.zigzag_ring_attention
    s = q.shape[2] // n

    def member(group):
        r = group.rank
        ts = [t[:, :, r * s:(r + 1) * s].clone().requires_grad_()
              for t in (q, k, v)]
        with fa.counting_into(collections.Counter()) as c:
            out = fn(*ts, group, causal=causal)
            out.backward(g[:, :, r * s:(r + 1) * s])
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in ts], dict(c)

    results = run_group(n, member)
    got = [torch.cat([res[0][i] for res in results], dim=2)
           for i in range(4)]
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    want_out = ra.ring_attention_plain(*ts, n, causal)
    want_out.backward(g)
    for a, b in zip(got, [want_out.detach()] + [t.grad for t in ts]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    for r, (_, counts) in enumerate(results):
        blocks = (2 * n + 1 if impl == "zigzag"
                  else r + 1 if causal else n)
        assert counts == {"flash_fwd_lse": blocks, "flash_dq": blocks,
                          "flash_dkv": blocks}, (r, counts)


def test_backward_kernels_are_deterministic(cuda):
    """No atomics anywhere: the same inputs give bitwise equal out and lse
    from the forward, and dQ, dK and dV from the two backward passes."""
    q, k, v, g = _inputs((2, 4, 700, 128), torch.float32)
    out, lse = fa.flash_fwd(q, k, v, True, emit_lse=True)
    delta = fa._delta(g, out)
    runs = [(*fa.flash_fwd(q, k, v, True, emit_lse=True),
             fa.flash_dq(q, k, v, g, lse, delta, True),
             *fa.flash_dkv(q, k, v, g, lse, delta, True)) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_forward_on_bf16_exact_inputs(cuda, d):
    """bfloat16 values in float32 tensors, as the LM hands them over: the
    forward takes its TF32-exact path (1 + 2 MMAs per step) and stays
    within the float32 tolerance, with and without lse."""
    q, k, v = (t.bfloat16().float()
               for t in _inputs((2, 3, 515, d), torch.float32, n=3))
    out, lse = fa.flash_fwd(q, k, v, True, emit_lse=True)
    out_nolse, none = fa.flash_fwd(q, k, v, True, emit_lse=False)
    want_out, want_lse = fa._fwd_plain(q, k, v, True)
    assert none is None and torch.equal(out, out_nolse)
    torch.testing.assert_close(out, want_out, atol=ATOL[torch.float32],
                               rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=ATOL[torch.float32],
                               rtol=0)


def test_default_lm_config_trains_on_the_card(cuda):
    """The default LMConfig (head size 32) takes a step on the card
    through all three kernels."""
    from elasticdl_tpu_torch.data.gen.synthetic import synthetic_lm_tokens
    from elasticdl_tpu_torch.models.transformer import transformer_lm as tlm
    from elasticdl_tpu_torch.worker.trainer import LocalTrainer

    cfg = tlm.LMConfig()
    assert cfg.d_model // cfg.n_heads == 32
    tokens = synthetic_lm_tokens(2, 129, vocab=cfg.vocab, seed=0)
    trainer = LocalTrainer(tlm.custom_model(cfg), tlm.loss, tlm.optimizer(),
                           device=cuda)
    fa.reset_launch_counts()
    _, version, loss = trainer.train_minibatch(tokens[:, :-1], tokens[:, 1:])
    assert version == 1 and torch.isfinite(loss).item()
    assert fa.launches == {"flash_fwd_lse": cfg.n_layers,
                           "flash_dq": cfg.n_layers,
                           "flash_dkv": cfg.n_layers}


def test_unsupported_inputs_raise(cuda):
    q, k, v, _ = _inputs((1, 1, 64, 48), torch.float32)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_fwd(q, k, v, True, emit_lse=False)
    q, k, v, _ = _inputs((1, 1, 64, 64), torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q, k, v, True, emit_lse=False)
    q, k, v, g = _inputs((1, 1, 64, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(2, 3), k, v, True, emit_lse=False)
    lse = torch.zeros(1, 1, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="lse and delta"):
        fa.flash_dq(q, k, v, g, lse, lse, True)
    shifted = torch.empty(q.numel() + 1, device="cuda")[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_fwd(shifted, k, v, True, emit_lse=False)


def test_ps_host_apply_matches_numpy_reference(cuda):
    """The parameter server's host library, built on the card's machine,
    against its numpy reference: Adam on a dense parameter and on table
    rows (float32, the same arithmetic in another order)."""
    import numpy as np

    from elasticdl_tpu_torch.ops import optimizers
    from elasticdl_tpu_torch.ps.embedding_table import EmbeddingTable
    from elasticdl_tpu_torch.ps.optimizer import PSOptimizer, numpy_rule

    spec = optimizers.adam(0.01)
    rng = np.random.default_rng(0)
    param = rng.normal(size=(64, 16)).astype(np.float32)
    ref = param.copy()
    table = EmbeddingTable("t", 8, seed=1)
    ids = np.arange(32, dtype=np.int64)
    ref_rows = table.lookup(ids).copy()
    opt = PSOptimizer(spec)
    slots = {}

    def slot_of(key):
        def get(name, init):
            return slots.setdefault((key, name), np.full(
                ref.shape if key is None else 8, init, np.float32))
        return get

    for step in range(1, 4):
        grad = rng.normal(size=param.shape).astype(np.float32)
        rows = rng.normal(size=(32, 8)).astype(np.float32)
        opt.begin_apply()
        opt.apply_dense("p", param, grad)
        opt.apply_sparse(table, ids, rows)
        opt.end_apply()
        numpy_rule(spec, ref, grad, 0.01, step, slot_of(None))
        for j in range(32):
            numpy_rule(spec, ref_rows[j], rows[j], 0.01, step, slot_of(j))
    np.testing.assert_allclose(param, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(table.lookup(ids), ref_rows, rtol=0,
                               atol=1e-6)


def test_host_codecs_match_their_plain_versions(cuda):
    """The host library's columnar Example decode and bfloat16 rounding,
    built on the card's machine, against the Python codec and the numpy
    rounding."""
    import numpy as np

    from elasticdl_tpu_torch.common import tensor_utils
    from elasticdl_tpu_torch.data.example import (
        batch_examples,
        stack_examples,
    )
    from elasticdl_tpu_torch.data.gen.criteo import iter_criteo_records

    records = list(iter_criteo_records(300, seed=5, chunk=128))
    got, want = batch_examples(records), stack_examples(records)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert got[name].tobytes() == want[name].tobytes(), name
    rng = np.random.default_rng(0)
    high = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
    low = rng.integers(0, 1 << 16, size=(2, 1 << 16)).astype(np.uint32)
    values = (high | low).reshape(-1).view(np.float32)
    np.testing.assert_array_equal(
        tensor_utils.float32_to_bfloat16_bits(values),
        tensor_utils.float32_to_bfloat16_bits_plain(values))
