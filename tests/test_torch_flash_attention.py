"""The port's flash attention (elasticdl_tpu_torch/ops/flash_attention.py)
against the JAX package's: the Pallas kernels run in interpret mode on the
CPU, the port's wrappers take their plain versions for CPU tensors. The
CUDA kernels themselves are held against the plain versions on the card
(test_torch_kernels_gpu.py and chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

import jax
from elasticdl_tpu.ops import flash_attention as jfa
from elasticdl_tpu_torch.ops import _build
from elasticdl_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

SHAPE = (1, 2, 256, 32)
BLOCK = 128
# Float32 end to end on both sides; the sums run in different orders.
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture
def inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("EDL_FORCE_PALLAS_INTERPRET", "1")


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas_interpret(inputs, interpret, causal):
    q, k, v, _ = inputs
    ref = np.asarray(jfa.flash_attention(q, k, v, causal, BLOCK, BLOCK))
    out = tfa.flash_attention(*_t(q, k, v), causal).numpy()
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL)
    plain = tfa.reference_attention(*_t(q, k, v), causal).numpy()
    np.testing.assert_allclose(plain, ref, atol=FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_pallas_interpret(inputs, interpret, causal):
    q, k, v, g = inputs
    _, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal, BLOCK, BLOCK),
        q, k, v,
    )
    ref = vjp(g)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfa.flash_attention(tq, tk, tv, causal)
    out.backward(torch.tensor(g))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL)
    plain = tfa._bwd_reference(*_t(q, k, v), out.detach(), torch.tensor(g),
                               causal)
    for got, want in zip(plain, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_each_plain_version_matches_its_pallas_kernel(inputs, interpret,
                                                      causal):
    """Each kernel's plain version against the Pallas kernel it ports, on
    the same residuals: forward (out, lse), dQ, and dK/dV."""
    q, k, v, g = inputs
    jout, jlse = jfa._flash_forward(q, k, v, causal, BLOCK, BLOCK, True)
    out, lse = tfa.flash_fwd(*_t(q, k, v), causal, emit_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL)

    jdq, jdk, jdv = jfa._flash_backward(q, k, v, jout, jlse, g, causal,
                                        BLOCK, BLOCK)
    tq, tk, tv, tg = _t(q, k, v, g)
    delta = tfa._delta(tg, torch.tensor(np.asarray(jout)))
    tlse = torch.tensor(np.asarray(jlse))
    dq = tfa.flash_dq(tq, tk, tv, tg, tlse, delta, causal)
    dk, dv = tfa.flash_dkv(tq, tk, tv, tg, tlse, delta, causal)
    for got, want in zip((dq, dk, dv), (jdq, jdk, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_ATOL)


def _tf32(x):
    """float32 rounded to TF32 (10-bit mantissa) to nearest, ties away from
    zero, on the bit pattern, as cvt.rna.tf32.f32 does."""
    bits = (x.view(torch.int32) + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _mm_1xtf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


def _mm_3xtf32(a, b):
    """The backward kernels' products: x = big + small with big = tf32(x);
    a b = a_big b_small + a_small b_big + a_big b_big, summed in float32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = a - a_big, b - b_big
    return (torch.matmul(a_big, b_small) + torch.matmul(a_small, b_big)
            + torch.matmul(a_big, b_big))


def _backward_with(mm, q, k, v, g, lse, delta, causal):
    """_dq_plain's and _dkv_plain's formulas with every product taken by
    `mm`."""
    scale = q.shape[-1] ** -0.5
    scores = mm(q, k.transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(scores.shape[-2:], dtype=torch.bool).tril()
        scores = scores.masked_fill(~mask, tfa.NEG_INF)
    p = torch.exp(scores - lse[..., None])
    ds = p * (mm(g, v.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale
    dv = mm(p.transpose(-1, -2), g)
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_products_hold_float32_accuracy(causal):
    """The arithmetic of the card's dQ and dK/dV kernels, emulated: 3xTF32
    products stay within 1e-5 of the float32 plain versions, and plain
    TF32 errs at least ten times more (why the kernels split)."""
    rng = np.random.default_rng(1)
    q, k, v, g = _t(*[rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
                      for _ in range(4)])
    out, lse = tfa._fwd_plain(q, k, v, causal)
    delta = tfa._delta(g, out)
    want = (tfa._dq_plain(q, k, v, g, lse, delta, causal),
            *tfa._dkv_plain(q, k, v, g, lse, delta, causal))
    err3, err1 = (
        max(float((a - b).abs().max()) for a, b in zip(
            _backward_with(mm, q, k, v, g, lse, delta, causal), want))
        for mm in (_mm_3xtf32, _mm_1xtf32)
    )
    assert err3 <= 1e-5
    assert err1 >= 10 * err3


def _mm_split(a, b, a_exact, b_exact):
    """One product as the kernels' mma_3xtf32<!a_exact, !b_exact>: the
    small-part terms first, each skipped where its operand is exact in TF32
    (its small part is then zero), then big times big."""
    a_big, b_big = _tf32(a), _tf32(b)
    terms = []
    if not a_exact:
        terms.append(torch.matmul(a - a_big, b_big))
    if not b_exact:
        terms.append(torch.matmul(a_big, b - b_big))
    terms.append(torch.matmul(a_big, b_big))
    return sum(terms[1:], terms[0])


_FWD_TILE_K = 64  # rows of flash_fwd.cu's streamed K, V tiles (kRowsK)


def _fwd_kernel_emulated(q, k, v, causal, exact):
    """flash_fwd.cu's arithmetic in plain torch -> (out, lse): K, V tiles
    of the kernel's rows; scores scaled in f32 with log2(e) folded into the
    scale; an online max (log2 units) and sum; 3xTF32 products, P always
    split, and with `exact` (Q, K, V exact in TF32) 1 + 2 MMAs in place of
    3 + 3."""
    s, d = q.shape[-2:]
    scale_log2 = (torch.tensor(d**-0.5, dtype=torch.float32)
                  * torch.tensor(1.4426950408889634, dtype=torch.float32))
    m = torch.full(q.shape[:-1], tfa.NEG_INF)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    rows = torch.arange(s)[:, None]
    tile = _FWD_TILE_K
    for k0 in range(0, s, tile):
        kt, vt = k[..., k0:k0 + tile, :], v[..., k0:k0 + tile, :]
        cols = torch.arange(k0, k0 + kt.shape[-2])[None, :]
        vis = cols <= rows if causal else torch.ones_like(cols <= rows)
        sc = _mm_split(q, kt.transpose(-1, -2), exact, exact) * scale_log2
        m_new = torch.maximum(
            m, torch.where(vis, sc, tfa.NEG_INF).amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.where(vis, torch.exp2(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + _mm_split(p, vt, False, exact)
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    return o / l_safe[..., None], math.log(2.0) * (m + torch.log2(l_safe))


@pytest.mark.parametrize("s,causal,bf16_exact", [
    (128, False, False), (128, True, False), (128, True, True),
    (100, True, False),  # ragged: the last K, V tile is partial
])
def test_forward_kernel_arithmetic_matches_plain_and_pallas(interpret, s,
                                                            causal,
                                                            bf16_exact):
    """The arithmetic of the card's forward kernel, emulated, holds out and
    lse within 1e-5 of the plain version and of the Pallas _fwd_kernel in
    interpret mode, on the exact path (1 + 2 MMAs) for bfloat16-exact
    inputs."""
    rng = np.random.default_rng(2)
    q, k, v = _t(*[rng.standard_normal((1, 2, s, 64)).astype(np.float32)
                   for _ in range(3)])
    if bf16_exact:
        q, k, v = (t.bfloat16().float() for t in (q, k, v))
    out, lse = _fwd_kernel_emulated(q, k, v, causal, exact=bf16_exact)
    plain_out, plain_lse = tfa._fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out, plain_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, plain_lse, atol=1e-5, rtol=0)
    block = min(s, BLOCK)
    jout, jlse = jfa._flash_forward(q.numpy(), k.numpy(), v.numpy(), causal,
                                    block, block, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5)


def test_no_grad_forward_skips_lse(inputs):
    """Without autograd the wrapper takes the lse-free forward, as the JAX
    primal does; the CPU path counts no kernel launch."""
    tfa.reset_launch_counts()
    q, k, v, _ = inputs
    with torch.no_grad():
        out = tfa.flash_attention(*_t(q, k, v), True)
    np.testing.assert_allclose(
        out.numpy(), tfa.reference_attention(*_t(q, k, v), True).numpy(),
        atol=FWD_ATOL,
    )
    assert sum(tfa.launches.values()) == 0


def test_non_cpu_tensors_never_fall_back(inputs):
    """A tensor that is not on the CPU goes to the kernel path, which
    validates and raises instead of computing the plain version."""
    q = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        tfa.flash_fwd(q, q, q, True, emit_lse=True)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        tfa.flash_dq(q, q, q, q, None, None, True)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
