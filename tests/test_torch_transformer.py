"""The transformer layers of the port (``nn.layer.transformer``) against
``paddle_tpu``'s, on the CPU, and K3/K3b's float16 instance's plain
version.

A ``paddle_tpu`` layer made from a seed is carried across by name
(``utils.convert.state_dict_by_name``, the ``[in, out]`` Linear layout
kept). ``MultiHeadAttention`` is held against the reference without a
cache and step by step through each of its four caches; decoding through
``gen_cache`` (``FixedCache``) against the full causal forward; the
encoder (with BERT's ``[b, 1, s, s]`` padding mask, which takes the port's
``sdpa`` to ``flash_flat_gqa``, K3/K3b's plain version here), the decoder
and ``Transformer`` in eval, and ``Transformer`` in training with
dropout, both sides fed the same masks (the reference's
``jax.random.bernoulli`` and the port's ``dropout_mask`` patched by
``monkeypatch``). f32 tolerances: values atol 1e-5 / rtol 1e-4, gradients
atol 2e-5 / rtol 1e-4 (f32 sums in another order); the int8 cache's
rounding is the reference's, so its outputs hold to the same.

The float16 K3/K3b: the predicate takes float16, and the plain version in
float16 is held against the reference's Pallas kernel, interpreted in
float16 with blocks shrunk below the sequence, at atol 5e-3 / rtol 5e-3
(outputs) and 2e-2 / 2e-2 (gradients): float16 rounding of values of a few
units, where the reference also rounds p and dS to float16 inside.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
from paddle_tpu.ops import flash_attention_flat as jfaf  # noqa: E402

from paddle_tpu_torch.framework.flags import set_flags  # noqa: E402
from paddle_tpu_torch.nn import layer as L  # noqa: E402
from paddle_tpu_torch.nn.functional import attention  # noqa: E402
from paddle_tpu_torch.nn.functional import common as tcommon  # noqa: E402
from paddle_tpu_torch.observability import metrics  # noqa: E402
from paddle_tpu_torch.ops import flash_attention_flat as ff  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_by_name  # noqa: E402

VALUE = dict(atol=1e-5, rtol=1e-4)
GRAD = dict(atol=2e-5, rtol=1e-4)
E, H, F_ = 128, 2, 256  # d = 64: the kernels' head dim


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _carry(jm, pm):
    pm.load_state_dict(state_dict_by_name(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}, pm))
    return pm


def _np(t):
    return np.asarray(t.numpy()) if not isinstance(t, torch.Tensor) else t.detach().numpy()


@pytest.fixture
def flat_on():
    set_flags({"FLAGS_flash_flat": True})
    registry.clear_cache()
    yield
    set_flags({"FLAGS_flash_flat": False})
    registry.clear_cache()


def _mha_pair(seed=1):
    paddle.seed(seed)
    jm = jnn.MultiHeadAttention(E, H)
    pm = _carry(jm, L.MultiHeadAttention(E, H, device="cpu"))
    jm.eval()
    pm.eval()
    return jm, pm


@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
def test_mha_matches_reference(mask):
    jm, pm = _mha_pair()
    q, kv = _x((2, 6, E), 2), _x((2, 9, E), 3)
    m = {"none": None, "bool": np.tril(np.ones((6, 9), bool), 3),
         "additive": np.where(np.arange(9)[None, None, None] < 7, 0.0, -1e30)
         .astype(np.float32).repeat(6, axis=2).repeat(2, axis=0)}[mask]
    want = jm(paddle.to_tensor(q), paddle.to_tensor(kv), paddle.to_tensor(kv),
              attn_mask=None if m is None else paddle.to_tensor(m))
    got = pm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
             attn_mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_np(got), _np(want), **VALUE)


def test_mha_concat_cache_passes_the_callers_mask():
    """``Cache`` steps of several tokens: the caller's mask is used as given
    over all the keys so far (a padding mask here, then none: every new
    query sees every key, as in the reference), not replaced by a causal
    one."""
    jm, pm = _mha_pair(seed=7)
    xs, mem = _x((2, 7, E), 8), _x((2, 3, E), 9)
    jc, tc = jm.gen_cache(paddle.to_tensor(mem)), pm.gen_cache(torch.from_numpy(mem))
    for lo, hi, padded in ((0, 3, True), (3, 5, True), (5, 7, False)):
        step = xs[:, lo:hi]
        m = None
        if padded:  # batch row 1's key 1 is padding
            m = np.zeros((2, 1, hi - lo, hi), np.float32)
            m[1, :, :, 1] = -1e30
        jo, jc = jm(*(paddle.to_tensor(step),) * 3, attn_mask=None if m is None else
                    paddle.to_tensor(m), cache=jc)
        to, tc = pm(*(torch.from_numpy(step),) * 3, attn_mask=None if m is None else
                    torch.from_numpy(m), cache=tc)
        np.testing.assert_allclose(_np(to), _np(jo), err_msg=f"tokens {lo}:{hi}", **VALUE)
    assert tc.k.shape[1] == 7
    for jt, tt in zip(jc, tc):
        np.testing.assert_allclose(_np(tt), _np(jt), **VALUE)


@pytest.mark.parametrize("kind", ["Cache", "StaticCache", "FixedCache", "QuantizedFixedCache"])
def test_mha_caches_match_reference_step_by_step(kind):
    """Four one-token steps through each cache: every step's output, and
    the cache's contents after the last."""
    jm, pm = _mha_pair(seed=4)
    xs, mem = _x((2, 4, E), 5), _x((2, 7, E), 6)
    jx, tx = paddle.to_tensor(mem), torch.from_numpy(mem)
    if kind == "Cache":
        jc, tc = jm.gen_cache(jx), pm.gen_cache(tx)
    elif kind == "StaticCache":
        jc = jm.gen_cache(jx, jx, type=jnn.MultiHeadAttention.StaticCache)
        tc = pm.gen_cache(tx, tx, type=L.MultiHeadAttention.StaticCache)
    else:
        kv = "int8" if kind == "QuantizedFixedCache" else None
        jc = jm.gen_cache(jx, static=True, max_seq=6, kv_dtype=kv)
        tc = pm.gen_cache(tx, static=True, max_seq=6, kv_dtype=kv)
    assert type(tc).__name__ == kind
    for t in range(4):
        step = xs[:, t:t + 1]
        if kind == "StaticCache":
            jo, jc = jm(paddle.to_tensor(step), cache=jc)
            to, tc = pm(torch.from_numpy(step), cache=tc)
        else:
            jo, jc = jm(paddle.to_tensor(step), paddle.to_tensor(step), paddle.to_tensor(step),
                        cache=jc)
            to, tc = pm(torch.from_numpy(step), torch.from_numpy(step), torch.from_numpy(step),
                        cache=tc)
        np.testing.assert_allclose(_np(to), _np(jo), err_msg=f"step {t}", **VALUE)
    for jt, tt in zip(jc, tc):
        if isinstance(tt, int):
            assert tt == int(_np(jt))
        else:
            np.testing.assert_allclose(_np(tt).astype(np.float32), _np(jt).astype(np.float32),
                                       **VALUE)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_gen_cache_decoding_equals_full_forward(kv_dtype):
    """A decoder stack decoding one token at a time through ``FixedCache``
    self-attention caches and the memory's ``StaticCache`` equals its full
    forward under the causal mask (the int8 cache to its rounding)."""
    dec = L.TransformerDecoder(L.TransformerDecoderLayer(E, H, F_, dropout=0.0, device="cpu",
                                                         generator=torch.Generator().manual_seed(7)),
                               2).eval()
    tgt, mem = torch.from_numpy(_x((2, 5, E), 8)), torch.from_numpy(_x((2, 7, E), 9))
    with torch.no_grad():
        full = dec(tgt, mem, tgt_mask=L.Transformer.generate_square_subsequent_mask(5))
        cache = [(layer.self_attn.gen_cache(tgt, static=True, max_seq=5, kv_dtype=kv_dtype),
                  layer.cross_attn.gen_cache(mem, mem, type=L.MultiHeadAttention.StaticCache))
                 for layer in dec.layers]
        steps = []
        for t in range(5):
            out, cache = dec(tgt[:, t:t + 1], mem, cache=cache)
            steps.append(out)
    tol = VALUE if kv_dtype is None else dict(atol=0.1, rtol=0.1)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), **tol)


def _encoder_pair(seed):
    paddle.seed(seed)
    jm = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(E, H, F_, dropout=0.1,
                                                            activation="gelu",
                                                            attn_dropout=0.0), 2)
    pm = L.TransformerEncoder(L.TransformerEncoderLayer(E, H, F_, dropout=0.1, activation="gelu",
                                                        attn_dropout=0.0, device="cpu"), 2)
    return jm, _carry(jm, pm)


def test_encoder_with_padding_mask_matches_reference(flat_on):
    """BERT's padding bias ``[b, 1, s, s]``: the port's ``sdpa`` picks
    ``flash_flat_gqa`` (K3/K3b), once per signature; eval outputs."""
    jm, pm = _encoder_pair(10)
    jm.eval()
    pm.eval()
    src = _x((2, 8, E), 11)
    mask = np.where(np.arange(8)[None, None, None] < np.array([5, 8])[:, None, None, None],
                    0.0, -1e30).astype(np.float32).repeat(8, axis=2)
    metrics.reset_counters("kernels.sdpa.")
    got = pm(torch.from_numpy(src), src_mask=torch.from_numpy(mask))
    assert metrics.counters("kernels.sdpa.") == {"kernels.sdpa.picked": 1,
                                                 "kernels.sdpa.fallback": 0}
    assert registry.select("sdpa", *(torch.zeros(2, 8, H, 64),) * 3, torch.from_numpy(mask), False,
                           0.0, None).name == "flash_flat_gqa"
    want = jm(paddle.to_tensor(src), src_mask=paddle.to_tensor(mask))
    np.testing.assert_allclose(_np(got), _np(want), **VALUE)


def test_decoder_and_transformer_match_reference():
    """Eval: the decoder stack (with a final norm, ``normalize_before``) and
    ``Transformer`` (post-norm) under the causal mask; names carry across."""
    paddle.seed(12)
    jt = jnn.Transformer(E, H, 1, 2, F_, normalize_before=True)
    pt = _carry(jt, L.Transformer(E, H, 1, 2, F_, normalize_before=True, device="cpu"))
    assert set(pt.state_dict()) == set(jt.state_dict())
    jt.eval()
    pt.eval()
    src, tgt = _x((2, 7, E), 13), _x((2, 5, E), 14)
    jmask = jnn.Transformer.generate_square_subsequent_mask(5)
    tmask = L.Transformer.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    want = jt(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=jmask)
    got = pt(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    np.testing.assert_allclose(_np(got), _np(want), **VALUE)
    mem = pt.encoder(torch.from_numpy(src))
    np.testing.assert_allclose(_np(pt.decoder(torch.from_numpy(tgt), mem, tgt_mask=tmask)),
                               _np(got), **VALUE)


class _Masks:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def next(self, shape, keep):
        self.shapes.append(tuple(int(s) for s in shape))
        return self.rng.random(self.shapes[-1]) < keep


def test_transformer_trains_with_dropout_like_reference(monkeypatch):
    """Training with dropout 0.1 (attention, residuals and activation
    dropouts) fed the same masks on both sides: output and every
    parameter's gradient of ``sum(out * g)``."""
    ref, port = _Masks(15), _Masks(15)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(ref.next(shape, p)))
    monkeypatch.setattr(tcommon, "dropout_mask", lambda shape, p, generator=None, device=None:
                        torch.from_numpy(port.next(shape, 1.0 - p)))
    paddle.seed(16)
    jt = jnn.Transformer(E, H, 1, 1, F_, dropout=0.1)
    pt = _carry(jt, L.Transformer(E, H, 1, 1, F_, dropout=0.1, device="cpu"))
    src, tgt, g = _x((2, 6, E), 17), _x((2, 4, E), 18), _x((2, 4, E), 19)
    jmask = jnn.Transformer.generate_square_subsequent_mask(4)
    jout = jt(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=jmask)
    (jout * paddle.to_tensor(g)).sum().backward()
    tout = pt(torch.from_numpy(src), torch.from_numpy(tgt),
              tgt_mask=L.Transformer.generate_square_subsequent_mask(4))
    (tout * torch.from_numpy(g)).sum().backward()
    assert ref.shapes == port.shapes and len(port.shapes) == 4 + 6
    np.testing.assert_allclose(_np(tout), _np(jout), **VALUE)
    jgrads = {n: _np(p.grad) for n, p in jt.named_parameters()}
    for n, p in pt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[n], err_msg=n, **GRAD)


# -- K3/K3b in float16 --------------------------------------------------------------------
def test_float16_flat_predicate_and_mask_dtypes(flat_on):
    """float16 operands take the flat kernels (their own dtypes); the
    kernels take a bias of f32 or of the operands' type, and ``sdpa``
    gives them a float16 mask, or a bf16 one, as f32; f64 is refused."""
    assert ff.enabled((2, 128, 3, 4, 64), torch.float16)
    assert not ff.enabled((2, 128, 3, 4, 64), torch.float64)
    assert ff.bias_dtype_ok(torch.float16, torch.float16) and ff.bias_dtype_ok(torch.float32,
                                                                               torch.float16)
    assert not ff.bias_dtype_ok(torch.bfloat16, torch.float16)
    assert ff.bias_dtype_ok(torch.bfloat16, torch.float32)
    q = torch.from_numpy(_x((2, 16, 2, 64), 20)).half()
    mask = torch.zeros(2, 1, 16, 16)
    for m in (mask, mask.half(), mask.bfloat16()):
        assert registry.select("sdpa", q, q, q, m, False, 0.0, None).name == "flash_flat_gqa"
        out = registry.dispatch("sdpa", q, q, q, m, False, 0.0, None)
        assert out.dtype == torch.float16 and out.shape == q.shape
    with pytest.raises(ValueError, match="bias"):  # what the CUDA wrapper checks
        ff._check_bias(mask.bfloat16(), 2, 16, torch.float16, q.device, "flash_flat_fwd")


def test_float16_inf_mask_reaches_the_flat_kernels_finite(flat_on, monkeypatch):
    """A float16 padding mask holding -inf (what a -1e30 mask cast to
    float16 holds) reaches K3/K3b as f32 with -inf at -1e30, and the output
    equals the plain composite's on the -inf mask (float16 operands, atol
    5e-3 / rtol 5e-3)."""
    seen, real = [], ff.flash_flat_gqa
    monkeypatch.setattr(ff, "flash_flat_gqa", lambda *a, mask=None, **k: seen.append(mask)
                        or real(*a, mask=mask, **k))
    q, k, v = (torch.from_numpy(_x((2, 16, 2, 64), 40 + i)).half() for i in range(3))
    keep = torch.arange(16)[None, None, None, :] < torch.tensor([5, 16])[:, None, None, None]
    mask = torch.where(keep, 0.0, -1e30).expand(2, 1, 16, 16).half()
    assert torch.isinf(mask).any()
    out = attention.scaled_dot_product_attention(q, k, v, attn_mask=mask, training=False)
    (got,) = seen
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, torch.where(keep, 0.0, -1e30).expand(2, 1, 16, 16))
    want = attention._sdpa_reference(q, k, v, mask)
    np.testing.assert_allclose(out.float().numpy(), want.float().numpy(), atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_float16_flat_plain_version_matches_interpreted_reference(causal):
    """K3/K3b's plain versions on float16 q, k, v with BERT's padding bias
    against the reference's Pallas kernels interpreted in float16: the
    output and the q, k, v gradients of ``sum(out * g)``."""
    prior = jfaf.set_interpret(True)
    blocks = jfaf.set_blocks(64, 64, 64)
    try:
        b, s = 2, 128
        q, k, v, g = (_x((b, s, H, 64), 21 + i).astype(np.float16) for i in range(4))
        keep = np.arange(s)[None, None, None, :] < np.array([37, s])[:, None, None, None]
        mask = np.broadcast_to(np.where(keep, 0.0, -1e30), (b, 1, s, s)).astype(np.float32)
        args = [jnp.asarray(a) for a in (q, k, v)]
        jout, vjp = jax.vjp(lambda *a: jfaf.flash_flat_masked(*a, jnp.asarray(mask), causal), *args)
        jgrads = vjp(jnp.asarray(g))
        leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in (q, k, v)]
        out = ff.flash_flat_masked(*leaves, torch.from_numpy(mask), causal)
        out.backward(torch.from_numpy(g))
    finally:
        jfaf.set_interpret(prior)
        jfaf.set_blocks(*blocks)
    assert out.dtype == torch.float16 and str(jout.dtype) == "float16"
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(jout, np.float32),
                               atol=5e-3, rtol=5e-3)
    for t, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(jg, np.float32), atol=2e-2,
                                   rtol=2e-2)
