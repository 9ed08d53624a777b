"""Kernels K1 and K2 of the port (``paddle_tpu_torch.ops.flash_attention``).

On the CPU the port's plain ``(out, lse)`` and ``(dq, dk, dv)`` are held
against ``paddle_tpu``'s Pallas ``_flash_fwd`` and ``_flash_bwd`` run through
the Pallas interpreter, with blocks shrunk below the sequence so the
streaming loops and the causal tile skips run (as
``tests/test_flash_interpret.py`` does). The ``cuda``-marked tests hold the
CUDA kernels against the plain versions on the card; they skip where there
is no card. JAX is imported only where it is installed (a machine with a
card may have none); the tests that need it skip without it.
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from paddle_tpu.ops import flash_attention as jfa
except ImportError:  # no JAX installed: only the cuda tests can run
    jnp = jfa = None

from paddle_tpu_torch.nn.functional import attention as attn
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import registry

B, S, H, D = 2, 128, 2, 64
BLOCK = 64  # < S: the Pallas kernel streams more than one K/V tile


def _needs_jax():
    if jfa is None:
        pytest.skip("needs jax and paddle_tpu for the reference")


@pytest.fixture
def interpret_small_blocks():
    _needs_jax()
    prior = jfa.set_interpret(True)
    saved = (jfa._BLOCK_Q, jfa._BLOCK_K)
    jfa._BLOCK_Q = jfa._BLOCK_K = BLOCK
    yield
    jfa.set_interpret(prior)
    jfa._BLOCK_Q, jfa._BLOCK_K = saved


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_pallas_forward(interpret_small_blocks, causal):
    q, k, v = _qkv((B, S, H, D))
    want_out, want_lse = jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    out, lse = fa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert out.shape == (B, S, H, D) and out.dtype == torch.float32
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=5e-6, rtol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=5e-6, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_ragged_seq_matches_reference(causal):
    """A ragged s (no multiple of any tile) against paddle_tpu's jnp
    reference; lse against a float64 numpy logsumexp."""
    _needs_jax()
    s = 100
    q, k, v = _qkv((2, s, 3, 64), seed=1)
    want = jfa._reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    out, lse = fa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=5e-6, rtol=1e-5)
    logits = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64)) / 8.0
    if causal:
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    want_lse = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=5e-6, rtol=1e-5)


def test_availability_predicate():
    ok = fa.flash_attention_available
    assert ok((2, 1024, 16, 64))
    assert ok((2, 1000, 16, 128), dtype=torch.bfloat16)  # ragged s is fine on the card
    assert ok((1, 1, 1, 64))
    assert ok((2, 64, 2, 64), device_type="cpu")          # CPU tensors take the plain version
    assert not ok((2, 128, 2, 32))                        # d outside the compiled head dims
    assert not ok((2, 128, 2, 96))
    assert not ok((2, 128, 2, 64), dtype=torch.float16)
    assert not ok((2, 128, 2, 64), (2, 64, 2, 64))        # cross-length attention
    assert not ok((2, 128, 64))
    assert not ok((2, 128, 70000, 64))                    # heads beyond grid.y
    assert not ok((2, 128, 2, 64), device_type="mps")


def test_cpu_path_is_counted_nowhere_and_forward_only():
    """The CPU path launches nothing, forward or backward, and its backward
    (once forward-only, now the plain K2) equals autograd through the plain
    forward. The name is kept from the forward-only days of the port."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv((1, 64, 2, 64)))
    before = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out, _ = fa.flash_attention_fwd(q, k, v, True)
    out.sum().backward()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == before
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa._reference_attention(q2, k2, v2, True)[0].sum().backward()
    for got, want in ((q, q2), (k, k2), (v, v2)):
        torch.testing.assert_close(got.grad, want.grad, atol=2e-5, rtol=1e-4)


# gradients: the reference's tolerance for its own kernel pair
# (tests/test_flash_interpret.py), true f32 on both sides
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_pallas_backward(interpret_small_blocks, causal):
    """``_reference_attention_bwd`` against the Pallas ``_flash_bwd`` on the
    same q, k, v, out, lse and dout (out and lse from the Pallas forward)."""
    q, k, v = _qkv((B, S, H, D))
    dout = np.random.default_rng(7).standard_normal((B, S, H, D)).astype(np.float32)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jout, jlse = jfa._flash_fwd(jq, jk, jv, causal)
    want = jfa._flash_bwd(jq, jk, jv, jout, jlse, jnp.asarray(dout), causal)
    got = fa._reference_attention_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, jout)),
        torch.from_numpy(np.array(jlse)[..., 0]), torch.from_numpy(dout), causal)
    for g, w in zip(got, want):
        assert g.shape == (B, S, H, D) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_autograd_of_plain_forward(s, causal):
    """The closed-form backward against autograd through
    ``_reference_attention``, at a tile-friendly and a ragged s."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((2, s, 3, 64), seed=4))
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal((2, s, 3, 64)).astype(np.float32))
    out, lse = fa._reference_attention(q, k, v, causal)
    got = fa._reference_attention_bwd(q, k, v, out, lse, dout, causal)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa._reference_attention(*leaves, causal)[0].backward(dout)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def test_packed_core_gradient_lands_in_one_tensor(monkeypatch):
    """``attention_core``/``flash`` over a packed ``[b, s, 3, h, d]`` qkv: K2
    gets three slices of ONE packed gradient buffer, which becomes the
    gradient of qkv, equal to the plain ``xla`` core's."""
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.standard_normal((2, 96, 3, 2, 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 96, 2, 64)).astype(np.float32))
    seen = []
    real_bwd = attn.flash_attention_bwd

    def spy(*args, grads=None, **kw):
        seen.append(grads)
        return real_bwd(*args, grads=grads, **kw)

    monkeypatch.setattr(attn, "flash_attention_bwd", spy)
    registry.clear_cache()
    qkv = base.clone().requires_grad_()
    assert registry.select("attention_core", qkv, 0.0, None).name == "flash"
    registry.dispatch("attention_core", qkv, 0.0, None).backward(g)
    (grads,) = seen
    packed = grads[0]._base
    assert packed is not None and tuple(packed.shape) == tuple(qkv.shape)
    assert all(t._base is packed for t in grads)
    assert [t.data_ptr() - packed.data_ptr() for t in grads] == [
        i * packed.stride(2) * packed.element_size() for i in range(3)]
    ref = base.clone().requires_grad_()
    attn._core_xla(ref, 0.0, None).backward(g)
    torch.testing.assert_close(qkv.grad, ref.grad, atol=GRAD_ATOL, rtol=GRAD_RTOL)


# ------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in true f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 2, 64), (2, 1000, 3, 128), (1, 77, 2, 64)])
def test_kernel_matches_plain_on_card(card, shape, causal, dtype):
    """f32: atol 1e-5 / rtol 1e-4 (f32 FMA sums in another order). bf16: the
    kernel's bf16 output against the plain version in f32 on the same bf16
    inputs, atol 2e-2 (one bf16 rounding of values of order 1); its lse is
    computed in f32 from those inputs and held to the f32 tolerance."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(card, dt) for x in _qkv(shape, seed=2))
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert out.dtype == dt and out.shape == shape and lse.shape == (shape[0], shape[2], shape[1])
    want_out, want_lse = fa._reference_attention(q.float(), k.float(), v.float(), causal)
    atol = 1e-5 if dtype == "float32" else 2e-2
    rtol = 1e-4 if dtype == "float32" else 0.0
    torch.testing.assert_close(out.float(), want_out, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_reads_packed_qkv_strides_on_card(card):
    """q, k, v as strided views of one packed [b, s, 3, h, d] projection, as
    the ``attention_core`` wrapper passes them: no copy, same result."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 256, 3, 4, 64)).astype(np.float32)).to(card)
    out, lse = fa.flash_attention_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True)
    want_out, want_lse = fa._reference_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True)
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-4)
    q_strided_d = torch.zeros((2, 256, 4, 128), device=card)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention_fwd(q_strided_d, qkv[:, :, 1], qkv[:, :, 2], True)


def _bwd_inputs(shape, dt, causal, device, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dt)
                     for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 2, 64), (2, 1000, 3, 128), (1, 77, 2, 64)])
def test_bwd_kernel_matches_plain_on_card(card, shape, causal, dtype):
    """K2 against ``_reference_attention_bwd`` on the same q, k, v, out, lse
    and dout. f32: atol 2e-5 / rtol 1e-4 (f32 sums in another order). bf16:
    the kernel's bf16 gradients against the plain version in f32 on the same
    bf16 inputs, atol 2e-2 / rtol 1e-2 (one bf16 rounding of the result is
    2**-8 relative; gradients reach a few units)."""
    dt = getattr(torch, dtype)
    q, k, v, out, lse, dout = _bwd_inputs(shape, dt, causal, card, seed=8)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa._reference_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), causal)
    atol, rtol = (2e-5, 1e-4) if dtype == "float32" else (2e-2, 1e-2)
    for g, w in zip(got, want):
        assert g.dtype == dt and g.shape == shape
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_bwd_kernel_writes_packed_qkv_strides_on_card(card):
    """Through ``attention_core``/``flash`` on the card: K1 reads, and K2
    writes, strided slices of packed ``[b, s, 3, h, d]`` tensors; the packed
    gradient equals the plain ``xla`` core's."""
    rng = np.random.default_rng(9)
    base = torch.from_numpy(rng.standard_normal((2, 200, 3, 4, 64)).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.standard_normal((2, 200, 4, 64)).astype(np.float32)).to(card)
    registry.clear_cache()
    qkv = base.clone().requires_grad_()
    before = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    registry.dispatch("attention_core", qkv, 0.0, None).backward(g)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = base.clone().requires_grad_()
    attn._core_xla(ref, 0.0, None).backward(g)
    torch.testing.assert_close(qkv.grad, ref.grad, atol=2e-5, rtol=1e-4)


def test_tma_alignment_rule():
    """The bf16 kernels read q, k, v and dout by TMA and store bf16 pairs:
    a bf16 operand needs a 16-byte aligned base and 16-byte aligned b, s, h
    byte strides. Views of a packed projection pass; a view one element
    past a boundary, or with a row pitch of 68 elements, raises; f32 is
    exempt (the SIMT kernels take any strides)."""
    qkv = torch.zeros((2, 64, 3, 2, 64), dtype=torch.bfloat16)
    fa.check_tma_alignment("test", (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]))
    fa.check_tma_alignment("test", (torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)[:, :, :, :],))
    flat = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)
    offset = flat[1:].view(2, 64, 2, 64)
    pitch = torch.zeros((2, 64, 2, 68), dtype=torch.bfloat16)[..., :64]
    for bad in (offset, pitch):
        with pytest.raises(ValueError, match="16-byte"):
            fa.check_tma_alignment("test", (qkv[:, :, 0], bad))
    fa.check_tma_alignment("test", (torch.zeros(2 * 64 * 2 * 64 + 1)[1:].view(2, 64, 2, 64),))


# The bf16 kernels' tiling: 128-row q tiles and 64-key K/V tiles, TMA's zero
# fill past s, lengths on both sides of each tile edge, both head dims.
# Tolerances as in the bf16 cases above.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129])
def test_bf16_tiling_edges_on_card(card, s, causal, d):
    shape = (2, s, 3, d)
    q, k, v, out, lse, dout = _bwd_inputs(shape, torch.bfloat16, causal, card, seed=20 + s)
    want_out, want_lse = fa._reference_attention(q.float(), k.float(), v.float(), causal)
    torch.testing.assert_close(out.float(), want_out, atol=2e-2, rtol=0.0)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-4)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    want = fa._reference_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                                       dout.float(), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == shape
        torch.testing.assert_close(g.float(), w, atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_bf16_packed_qkv_on_card(card):
    """The O2 step's call: bf16 views of one packed ``[b, s, 3, h, d]``
    projection through ``attention_core``/``flash``; K1 reads and K2 writes
    strided slices (TMA over the views' own strides), and both agree with
    the plain composite in f32 on the same bf16 inputs (bf16 tolerances as
    above)."""
    rng = np.random.default_rng(21)
    base = torch.from_numpy(rng.standard_normal((2, 200, 3, 4, 64)).astype(np.float32)).to(
        card, torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 200, 4, 64)).astype(np.float32)).to(
        card, torch.bfloat16)
    registry.clear_cache()
    qkv = base.clone().requires_grad_()
    before = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out = registry.dispatch("attention_core", qkv, 0.0, None)
    out.backward(g)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref = base.float().requires_grad_()
    want = attn._core_xla(ref, 0.0, None)
    want.backward(g.float())
    torch.testing.assert_close(out.float(), want, atol=2e-2, rtol=0.0)
    torch.testing.assert_close(qkv.grad.float(), ref.grad, atol=2e-2, rtol=1e-2)
