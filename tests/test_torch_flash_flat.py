"""Kernels K3 and K3b of the port (``paddle_tpu_torch.ops.flash_attention_flat``).

On the CPU the port's ``flash_flat``, ``flash_packed``, ``flash_flat_masked``
and ``flash_flat_gqa`` (their plain versions) are held against
``paddle_tpu``'s, whose Pallas ``_fwd_kernel``/``_bwd_kernel`` run through
the Pallas interpreter with blocks shrunk below the sequence so the
streaming loops and causal tile logic run (as ``tests/test_flash_interpret.py``
does): outputs and q/k/v gradients on the same numpy inputs. Tolerances are
the reference's own for its kernels: forward atol 5e-6 / rtol 1e-5,
gradients atol 2e-5 / rtol 1e-4 (f32 sums in another order).

The ``cuda``-marked tests hold the CUDA kernels against the plain versions
on the card; they skip where there is none. JAX is imported only where it
is installed (a machine with a card may have none).
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops import flash_attention_flat as jfaf
except ImportError:  # no JAX installed: only the cuda tests can run
    jax = jnp = jfaf = None

from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.nn.functional import attention as attn
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import flash_attention_flat as ff
from paddle_tpu_torch.ops import registry

B, S, H, D = 2, 128, 2, 64
BLOCK = 64  # < S: the Pallas kernels stream more than one tile
FWD = dict(atol=5e-6, rtol=1e-5)
GRAD = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def jax_interpret():
    if jfaf is None:
        pytest.skip("needs jax and paddle_tpu for the reference")
    prior = jfaf.set_interpret(True)
    blocks = jfaf.set_blocks(BLOCK, BLOCK, BLOCK)
    yield
    jfaf.set_interpret(prior)
    jfaf.set_blocks(*blocks)


@pytest.fixture
def flash_flat_on():
    set_flags({"FLAGS_flash_flat": True})
    registry.clear_cache()
    yield
    set_flags({"FLAGS_flash_flat": False})
    registry.clear_cache()


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _padding_bias(batch, lengths=(37, S)):
    """0 where key j < len_b, -1e30 elsewhere: ``[batch, 1, S, S]``."""
    keep = np.arange(S)[None, None, None, :] < np.asarray(lengths[:batch])[:, None, None, None]
    return np.broadcast_to(np.where(keep, 0.0, -1e30), (batch, 1, S, S)).astype(np.float32)


def _banded_bias():
    return np.where(np.triu(np.ones((S, S), bool), -32), 0.0, -1e30)[None, None].astype(np.float32)


def _port(fn, arrays, g, *extra):
    """``fn(*tensors, *extra)`` on the port, with the gradient of
    ``sum(out * g)`` w.r.t. each tensor."""
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*leaves, *extra)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax(fn, arrays, g, *extra):
    args = [jnp.asarray(a) for a in arrays]
    out, vjp = jax.vjp(lambda *a: fn(*a, *extra), *args)
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _assert_match(port, ref):
    np.testing.assert_allclose(port[0], ref[0], **FWD)
    for got, want in zip(port[1], ref[1]):
        np.testing.assert_allclose(got, want, **GRAD)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_flat_matches_pallas(jax_interpret, causal):
    q, k, v, g = _arrays([(B, S, H, D)] * 4, seed=0)
    _assert_match(_port(ff.flash_flat, [q, k, v], g, causal),
                  _jax(jfaf.flash_flat, [q, k, v], g, causal))


def test_flash_packed_matches_pallas(jax_interpret):
    """Causal over the packed ``[b, s, 3, h, d]`` projection; the port's
    gradient is one packed tensor, as the reference's concatenation."""
    qkv, g = _arrays([(B, S, 3, H, D), (B, S, H, D)], seed=1)
    _assert_match(_port(ff.flash_packed, [qkv], g, True), _jax(jfaf.flash_packed, [qkv], g, True))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", ["padding_b", "padding_1", "banded_1"])
def test_flash_flat_masked_matches_pallas(jax_interpret, bias, causal):
    """``[b, 1, s, s]`` and ``[1, 1, s, s]`` (read with batch stride 0)
    additive biases, causal and not."""
    q, k, v, g = _arrays([(B, S, H, D)] * 4, seed=2)
    mask = {"padding_b": _padding_bias(B), "padding_1": _padding_bias(1, lengths=(90,)),
            "banded_1": _banded_bias()}[bias]
    _assert_match(_port(ff.flash_flat_masked, [q, k, v], g, torch.from_numpy(mask), causal),
                  _jax(jfaf.flash_flat_masked, [q, k, v], g, jnp.asarray(mask), causal))


@pytest.mark.parametrize("masked", [False, True])
def test_flash_flat_gqa_matches_pallas(jax_interpret, masked):
    """4 query heads over 2 K/V heads: the repeated K/V's gradients are
    summed back onto each K/V head."""
    q, g = _arrays([(B, S, 4, D)] * 2, seed=3)
    k, v = _arrays([(B, S, 2, D)] * 2, seed=4)
    mask = _padding_bias(B) if masked else None
    port = _port(lambda q, k, v: ff.flash_flat_gqa(
        q, k, v, causal=False, mask=None if mask is None else torch.from_numpy(mask)), [q, k, v], g)
    ref = _jax(lambda q, k, v: jfaf.flash_flat_gqa(
        q, k, v, causal=False, mask=None if mask is None else jnp.asarray(mask)), [q, k, v], g)
    _assert_match(port, ref)
    with pytest.raises(ValueError, match="h_kv"):
        ff.flash_flat_gqa(torch.zeros(1, 8, 4, D), torch.zeros(1, 8, 3, D), torch.zeros(1, 8, 3, D))


def _jnp_composite(q, k, v, bias, causal):
    """softmax(q k^T / sqrt(d) + bias) v in jnp, causal pairs excluded."""
    qh, kh, vh = (jnp.swapaxes(t, 1, 2) for t in (q, k, v))
    x = jnp.einsum("bhqd,bhkd->bhqk", qh, kh) / (D ** 0.5) + bias
    if causal:
        x = jnp.where(jnp.tril(jnp.ones((S, S), bool)), x, -jnp.inf)
    return jnp.swapaxes(jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(x, axis=-1), vh), 1, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_fully_masked_row_is_uniform_and_differentiable(jax_interpret, causal):
    """Query row 5 has every key masked by -1e30: its output is the uniform
    average of the visible V rows, as the composite gives (and as the
    reference's Pallas forward gives), never NaN. Its gradients are the
    composite's: the port keeps m and log l apart, where the reference's
    Pallas backward recomputes p from m + log l, which rounds to m at -1e30
    and gives p = 1 (ROADMAP.md, Queue 3); so the gradients are held against
    ``jax.vjp`` of the jnp composite."""
    q, k, v, g = _arrays([(B, S, H, D)] * 4, seed=5)
    mask = _padding_bias(B).copy()
    mask[:, :, 5, :] = -1e30
    port = _port(ff.flash_flat_masked, [q, k, v], g, torch.from_numpy(mask), causal)
    assert np.isfinite(port[0]).all() and all(np.isfinite(x).all() for x in port[1])
    visible = 6 if causal else S
    np.testing.assert_allclose(port[0][:, 5], v[:, :visible].mean(axis=1), **FWD)
    pallas = np.asarray(jfaf.flash_flat_masked(*(jnp.asarray(x) for x in (q, k, v)),
                                               jnp.asarray(mask), causal))
    np.testing.assert_allclose(port[0], pallas, **FWD)
    _assert_match(port, _jax(lambda q, k, v: _jnp_composite(q, k, v, jnp.asarray(mask), causal),
                             [q, k, v], g))


def test_bool_mask_equals_its_float_twin(flash_flat_on):
    """Through ``sdpa``: a bool mask becomes 0 / -1e30 f32 before K3, so it
    gives the float twin's output and gradients exactly; both pick
    ``flash_flat_gqa``, and agree with the plain ``xla`` composite."""
    q, k, v, g = _arrays([(B, S, H, D)] * 4, seed=6)
    keep = _padding_bias(B) == 0.0
    metrics.reset_counters("kernels.sdpa.")
    results = [_port(lambda q, k, v: attn.scaled_dot_product_attention(q, k, v, attn_mask=m),
                     [q, k, v], g)
               for m in (torch.from_numpy(keep), torch.from_numpy(_padding_bias(B)))]
    assert metrics.counters("kernels.sdpa.") == {"kernels.sdpa.picked": 2,
                                                 "kernels.sdpa.fallback": 0}
    assert registry.select("sdpa", *(torch.zeros(B, S, H, D),) * 3, torch.from_numpy(keep), False,
                           0.0, None).name == "flash_flat_gqa"
    np.testing.assert_array_equal(results[0][0], results[1][0])
    for a, b in zip(results[0][1], results[1][1]):
        np.testing.assert_array_equal(a, b)
    _assert_match(results[0], _port(lambda q, k, v: attn._sdpa_reference(
        q, k, v, torch.from_numpy(keep)), [q, k, v], g))


def test_registry_selection_and_flag(flash_flat_on):
    """With ``FLAGS_flash_flat`` on, a masked ``sdpa`` picks
    ``flash_flat_gqa`` (not with dropout), an unmasked one ``flash``, and
    ``attention_core`` picks ``flash_packed``; with it off, a masked
    ``sdpa`` falls back to ``xla`` and ``attention_core`` takes ``flash``."""
    x = torch.zeros(B, S, H, D)
    mask = torch.zeros(B, 1, S, S)
    qkv = torch.zeros(B, S, 3, H, D)
    assert registry.select("sdpa", x, x, x, mask, False, 0.0, None).name == "flash_flat_gqa"
    assert registry.select("sdpa", x, x, x, mask, False, 0.1, None).name == "xla"  # dropout
    assert registry.select("sdpa", x, x, x, None, False, 0.0, None).name == "flash"
    assert registry.select("attention_core", qkv, 0.0, None).name == "flash_packed"
    set_flags({"FLAGS_flash_flat": False})
    assert registry.select("sdpa", x, x, x, mask, False, 0.0, None).name == "xla"
    assert registry.select("attention_core", qkv, 0.0, None).name == "flash"


def test_availability_rules():
    """The kernels' own limits, not the reference's TPU rules: a ragged and
    a short s are taken, d must be 64 or 128, the mask ``[b|1, 1, s, s]``;
    the flag gates everything."""
    set_flags({"FLAGS_flash_flat": True})
    try:
        assert ff.enabled() and ff.enabled((2, 100, 3, 4, 64)) and ff.enabled((1, 3000, 3, 2, 128))
        assert not ff.enabled((2, 128, 3, 4, 32)) and not ff.enabled((2, 128, 3, 4, 64), torch.float16)
        assert not ff.enabled((2, 128, 3, 4, 64), torch.float32, "meta")
    finally:
        set_flags({"FLAGS_flash_flat": False})
    assert not ff.enabled() and not ff.enabled((2, 128, 3, 4, 64))
    assert ff.mask_supported(2, 100, 4, 64, (2, 1, 100, 100))
    assert ff.mask_supported(2, 2048, 4, 64, (1, 1, 2048, 2048))
    for shape in [(2, 4, 100, 100), (3, 1, 100, 100), (2, 1, 1, 100), (2, 100, 100)]:
        assert not ff.mask_supported(2, 100, 4, 64, shape)


def test_plain_path_counts_no_launch_and_other_devices_raise():
    """A CPU tensor takes the plain versions (no launch counted); a tensor
    on neither a CPU nor a CUDA device raises."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays([(1, 70, 2, D)] * 4, seed=7))
    before = ff.flash_flat_fwd.launches, ff.flash_flat_bwd.launches
    out, stats = ff.flash_flat_fwd(q, k, v, torch.zeros(1, 1, 70, 70), True)
    ff.flash_flat_bwd(q, k, v, None, out, stats, g, True)
    assert (ff.flash_flat_fwd.launches, ff.flash_flat_bwd.launches) == before
    assert stats.shape == (2, 1, 2, 70) and stats.dtype == torch.float32
    meta = torch.empty((1, 70, 2, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ff.flash_flat_fwd(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        ff.flash_flat_bwd(meta, meta, meta, None, meta, stats, meta)


# ------------------------------------------------------------------ card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in true f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _card_bias(kind, b, s, device, dtype):
    rng = np.random.default_rng(10)
    if kind == "none":
        return None
    if kind == "padding":
        lens = rng.integers(1, s + 1, b)
        keep = np.arange(s)[None, None, None, :] < lens[:, None, None, None]
        bias = np.broadcast_to(np.where(keep, 0.0, -1e30), (b, 1, s, s)).copy()
        bias[0, 0, 3] = -1e30  # one fully masked query row
    elif kind == "broadcast":
        bias = rng.standard_normal((1, 1, s, s))
    else:  # banded
        bias = np.where(np.triu(np.ones((s, s), bool), -40), 0.0, -1e30)[None, None]
    return torch.from_numpy(bias.astype(np.float32)).to(device, dtype)


# K3 / K3b against their plain versions on the same inputs. f32: atol 1e-5 /
# rtol 1e-4 forward, 2e-5 / 1e-4 gradients (f32 sums in another order).
# bf16: the kernel's bf16 results against the plain version in f32 on the
# same bf16 inputs, atol 2e-2 (forward) and 2e-2 / rtol 1e-2 (gradients):
# one bf16 rounding of values of a few units.
def _check_kernels_on_card(card, kind, shape, causal, dt):
    b, s, h, d = shape
    qkv = torch.from_numpy(_arrays([(b, s, 3, h, d)], seed=11)[0]).to(card, dt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # strided views
    dout = torch.from_numpy(_arrays([shape], seed=12)[0]).to(card, dt)
    bias = _card_bias(kind, b, s, card, dt)
    before = ff.flash_flat_fwd.launches, ff.flash_flat_bwd.launches
    out, stats = ff.flash_flat_fwd(q, k, v, bias, causal)
    dqkv = torch.empty_like(qkv)
    grads = ff.flash_flat_bwd(q, k, v, bias, out, stats, dout, causal,
                              grads=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
    torch.cuda.synchronize()
    assert (ff.flash_flat_fwd.launches, ff.flash_flat_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_out, want_stats = ff._reference_flat_fwd(q.float(), k.float(), v.float(), bias, causal)
    want = ff._reference_flat_bwd(q.float(), k.float(), v.float(), bias, out.float(), stats,
                                  dout.float(), causal)
    f32 = dt == torch.float32
    torch.testing.assert_close(out.float(), want_out, atol=1e-5 if f32 else 2e-2, rtol=1e-4 if f32 else 0.0)
    torch.testing.assert_close(stats[1], want_stats[1], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(stats[0] - want_stats[0], torch.zeros_like(stats[0]), atol=1e-5,
                               rtol=0.0)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w, atol=2e-5 if f32 else 2e-2,
                                   rtol=1e-4 if f32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", [("padding", (2, 512, 2, 64)), ("broadcast", (2, 200, 3, 64)),
                                  ("banded", (1, 256, 2, 128)), ("none", (2, 130, 2, 64))])
def test_kernels_match_plain_on_card(card, case, causal, dtype):
    kind, shape = case
    _check_kernels_on_card(card, kind, shape, causal, getattr(torch, dtype))


# The bf16 kernels' tiling: 128-row q tiles and 64-key K/V tiles, TMA's zero
# fill past s, lengths on both sides of each tile edge, both head dims, with
# and without a padding bias (whose rows have the odd stride s).
@pytest.mark.cuda
@pytest.mark.parametrize("bias", ["none", "padding"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129])
def test_bf16_tiling_edges_on_card(card, s, causal, d, bias):
    kind = bias if s > 3 else "none"  # the padding bias masks query row 3 whole
    _check_kernels_on_card(card, kind, (2, s, 2, d), causal, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_broadcast_bias_on_card(card, d):
    """A ``[1, 1, s, s]`` bias read with batch stride 0 by every batch of
    the bf16 kernels, causal and not."""
    for causal in (False, True):
        _check_kernels_on_card(card, "broadcast", (3, 129, 2, d), causal, torch.bfloat16)


@pytest.mark.cuda
def test_gqa_and_packed_routes_on_card(card, flash_flat_on):
    """Through the registry on the card: masked GQA ``sdpa`` picks
    ``flash_flat_gqa`` and the packed ``attention_core`` picks
    ``flash_packed``; each launches K3 once forward and K3b once backward
    and agrees with the plain ``xla`` composite."""
    rng = np.random.default_rng(13)
    q, g = (torch.from_numpy(rng.standard_normal((2, 256, 8, 64)).astype(np.float32)).to(card)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 256, 2, 64)).astype(np.float32)).to(card)
            for _ in range(2))
    mask = _card_bias("padding", 2, 256, card, torch.float32)
    qkv = torch.from_numpy(rng.standard_normal((2, 256, 3, 8, 64)).astype(np.float32)).to(card)
    for route in ("sdpa", "attention_core"):
        leaves = [t.clone().requires_grad_() for t in ((q, k, v) if route == "sdpa" else (qkv,))]
        before = ff.flash_flat_fwd.launches, ff.flash_flat_bwd.launches
        if route == "sdpa":
            out = attn.scaled_dot_product_attention(*leaves, attn_mask=mask)
            ref_fn = lambda q, k, v: attn._sdpa_reference(  # noqa: E731
                q, k.repeat_interleave(4, 2), v.repeat_interleave(4, 2), mask)
        else:
            out = registry.dispatch("attention_core", leaves[0], 0.0, None)
            ref_fn = lambda qkv: attn._core_xla(qkv, 0.0, None)  # noqa: E731
        out.backward(g)
        torch.cuda.synchronize()
        assert (ff.flash_flat_fwd.launches, ff.flash_flat_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        want = ref_fn(*ref)
        want.backward(g)
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
        for a, b in zip(leaves, ref):
            torch.testing.assert_close(a.grad, b.grad, atol=2e-5, rtol=1e-4)
