"""GPT-MoE of the port against ``paddle_tpu``'s, and kernels K4/K4b on the card.

On the CPU the same numpy inputs go through ``paddle_tpu`` and the port: the
grouped expert FFN (the reference's Pallas kernels run by the Pallas
interpreter with blocks shrunk below the problem, as
``tests/test_kernel_registry.py`` runs them), the sort-based and dense
dispatch/combine, the three gates, ``MoELayer``, a tiny GPT-MoE whose
weights ``paddle_tpu`` made and ``utils/convert`` carried across, and three
AdamW ``TrainStep``s of it. GShard's random routing draws from threefry in
the reference and from the layer's ``torch.Generator`` here, so the parity
tests switch ``random_routing`` off on both sides' instances (or pass one
explicit ``drop_mask`` to both), and the jitter is checked by its keep rate.

Tolerances, f32: forward values atol 1e-5 / rtol 1e-5 and gradients atol
1e-4 / rtol 1e-4 (both sides sum in f32, in another order). bf16 and the
card's tolerances are stated where they are used. The ``cuda``-marked tests
hold K4 and K4b against their plain versions on the card and skip without
one; JAX is imported only where it is installed.
"""
import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.distributed import moe as jmoe
    from paddle_tpu.framework.flags import _REGISTRY as _JFLAGS
    from paddle_tpu.jit import TrainStep as JTrainStep
    from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
    from paddle_tpu.models.gpt import GPTForPretraining as JGPT
    from paddle_tpu.models.gpt import GPTPretrainingCriterion as JCriterion
    from paddle_tpu.ops import moe_pallas as jmp
    from paddle_tpu.ops import registry as jregistry
except ImportError:  # no JAX installed: only the cuda tests can run
    jax = None

from paddle_tpu_torch.distributed import moe as tmoe
from paddle_tpu_torch.framework.flags import _REGISTRY as _FLAGS
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForPretraining, GPTPretrainingCriterion
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import moe_pallas as mp
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils.convert import state_dict_from_paddle_tpu

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
# bf16 carries 8 significant bits: one rounding is 2**-8 relative, and the
# two sides round the same f32 values, at most one ulp apart
BF16 = dict(atol=1e-2, rtol=1e-2)


def _needs_jax():
    if jax is None:
        pytest.skip("needs jax and paddle_tpu for the reference")


@pytest.fixture
def interpret():
    """The reference's MoE kernels through the Pallas interpreter, so its
    registry picks ``pallas_sorted`` on the CPU, as the port's does."""
    _needs_jax()
    prior = jmp.set_interpret(True)
    jregistry.clear_cache()
    registry.clear_cache()
    saved = (_FLAGS["FLAGS_kernel_overrides"], _JFLAGS["FLAGS_kernel_overrides"])
    yield
    jmp.set_interpret(prior)
    _FLAGS["FLAGS_kernel_overrides"], _JFLAGS["FLAGS_kernel_overrides"] = saved
    jregistry.clear_cache()
    registry.clear_cache()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _ffn_weights(E, D, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, D, H)).astype(np.float32) / math.sqrt(D),
            0.1 * rng.normal(size=(E, 1, H)).astype(np.float32),
            rng.normal(size=(E, H, D)).astype(np.float32) / math.sqrt(H),
            0.1 * rng.normal(size=(E, 1, D)).astype(np.float32))


# ------------------------------------------------------- (a) grouped FFN

@pytest.mark.parametrize("bm,bh", [(8, 64), (8, 128), (16, 64)])
def test_grouped_ffn_matches_pallas_kernels(interpret, bm, bh):
    """The port's plain grouped FFN (forward, s, and the backward by
    autograd through ``_GroupedFFN``) against the interpreted Pallas
    ``_grouped_ffn``: bm = 8 < cap runs several row blocks per expert,
    bh = 64 < H the hidden-tiled kernels, bh = H the single-tile kernels
    that write s."""
    E, cap, D, H = 4, 16, 32, 128
    rng = np.random.default_rng(0)
    xg = rng.normal(size=(E * cap, D)).astype(np.float32)
    gy = rng.normal(size=(E * cap, D)).astype(np.float32)
    w = _ffn_weights(E, D, H, seed=1)
    jargs = tuple(jnp.asarray(a) for a in (xg, *w))

    y_j, res = jmp._grouped_ffn_fwd(*jargs, jax.nn.gelu, bm, bh)
    grads_j = jax.grad(lambda *a: jnp.sum(jmp._grouped_ffn(*a, jax.nn.gelu, bm, bh) * gy),
                       argnums=(0, 1, 2, 3, 4))(*jargs)
    s_ref = jmp._reference_ffn_fwd(*jargs, jax.nn.gelu, E, cap)[1].reshape(E * cap, H)

    leaves = [_t(a).requires_grad_() for a in (xg, *w)]
    y = mp.grouped_ffn(*leaves, "gelu")
    (y * _t(gy)).sum().backward()
    _, s = mp.moe_grouped_ffn_fwd(*(t.detach() for t in leaves), "gelu")
    np.testing.assert_allclose(y.detach().numpy(), _np(y_j), **FWD)
    np.testing.assert_allclose(s.numpy(), _np(s_ref), **FWD)
    if res[5] is not None:  # the single-hidden-tile kernel's residual
        np.testing.assert_allclose(s.numpy(), _np(res[5]), **FWD)
    for t, g, name in zip(leaves, grads_j, ("dx", "dw1", "db1", "dw2", "db2")):
        np.testing.assert_allclose(t.grad.numpy(), _np(g), err_msg=name, **GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_plain_ffn_matches_reference_lowering(act, dtype):
    """``_reference_ffn_fwd``/``_bwd`` of both packages on the same inputs,
    s and dy: every activation, and bf16 with its rounding points (s f32,
    h and dh cast to bf16 before their products, sums in f32)."""
    _needs_jax()
    E, cap, D, H = 3, 8, 16, 40
    rng = np.random.default_rng(2)
    xg, dy = (rng.normal(size=(E * cap, D)).astype(np.float32) for _ in range(2))
    w = _ffn_weights(E, D, H, seed=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = tuple(jnp.asarray(a, jdt) for a in (xg, *w))
    targs = tuple(_t(a, tdt) for a in (xg, *w))
    jact = getattr(jax.nn, act)
    y_j, s_j = jmp._reference_ffn_fwd(*jargs, jact, E, cap)
    y, s = mp._reference_ffn_fwd(*targs, act)
    want = jmp._reference_ffn_bwd(*jargs, s_j, jnp.asarray(dy, jdt), jact, E, cap)
    got = mp._reference_ffn_bwd(*targs, s, _t(dy, tdt), act)
    tol_f, tol_g = (FWD, GRAD) if dtype == "float32" else (BF16, BF16)
    assert y.dtype == tdt and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), _np(y_j), **tol_f)
    np.testing.assert_allclose(s.numpy(), _np(s_j).reshape(E * cap, H), **FWD)
    for g, w_, name in zip(got, want, ("dx", "dw1", "db1", "dw2", "db2")):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(), _np(w_), err_msg=name, **tol_g)


# ------------------------------------------------ (b) dispatch and combine


def _routing(T, E, K, seed, skew=0.0):
    """Random top-k routing ``(gate_vals, gate_idx)`` from softmax scores;
    ``skew`` raises expert 0's logit so it overflows its capacity."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(T, E)).astype(np.float32)
    logits[:, 0] += skew
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :K].astype(np.int32)
    return np.take_along_axis(probs, idx, -1).astype(np.float32), idx


@pytest.mark.parametrize("impl", ["pallas_sorted", "dense"])
@pytest.mark.parametrize("K,drop", [(1, False), (2, False), (2, True)])
def test_dispatch_combine_matches_paddle_tpu(interpret, impl, K, drop):
    """Skewed routing that overflows expert 0's capacity, with and without a
    ``drop_mask``: the output and its gradients with respect to the tokens,
    the gate values and the four weights."""
    T, D, H, E, capacity = 24, 16, 32, 4, 5
    gv, gi = _routing(T, E, K, seed=4, skew=2.5)
    assert (gi == 0).sum() > capacity  # expert 0 overflows: dropping runs
    rng = np.random.default_rng(5)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    g = rng.normal(size=(T, D)).astype(np.float32)
    dm = None
    if drop:
        dm = np.zeros((T, K), bool)
        dm[:, 1] = rng.random(T) < 0.5
    w = _ffn_weights(E, D, H, seed=6)
    jfn = {"pallas_sorted": jmp.moe_dispatch_combine, "dense": jmoe.dense_dispatch_combine}[impl]
    tfn = {"pallas_sorted": mp.moe_dispatch_combine, "dense": tmoe.dense_dispatch_combine}[impl]

    def jloss(tok, gvals, w1, b1, w2, b2):
        out = jfn(tok, gvals, jnp.asarray(gi), None if dm is None else jnp.asarray(dm),
                  w1, b1, w2, b2, capacity=capacity, activation=jax.nn.gelu)
        return jnp.sum(out * g), out

    jargs = tuple(jnp.asarray(a) for a in (tokens, gv, *w))
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(*jargs)
    leaves = [_t(a).requires_grad_() for a in (tokens, gv, *w)]
    out = tfn(leaves[0], leaves[1], torch.from_numpy(gi), None if dm is None else torch.from_numpy(dm),
              *leaves[2:], capacity=capacity, activation="gelu")
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(want), **FWD)
    for t, jg, name in zip(leaves, jgrads, ("tokens", "gate_vals", "w1", "b1", "w2", "b2")):
        np.testing.assert_allclose(t.grad.numpy(), _np(jg), err_msg=name, **GRAD)


# ----------------------------------------------------- (b2) live rows


def _spy_port(monkeypatch):
    """Record the port's grouped-FFN call as the dispatch makes it: xg,
    rows, and dy (the gradient reaching the FFN's output)."""
    seen = {}
    real = mp.grouped_ffn

    def spy(xg, w1, b1, w2, b2, activation="gelu", rows=None):
        seen["xg"], seen["rows"] = xg.detach().clone(), rows
        y = real(xg, w1, b1, w2, b2, activation, rows)
        if y.requires_grad:
            y.register_hook(lambda g: seen.__setitem__("dy", g.detach().clone()))
        return y

    monkeypatch.setattr(mp, "grouped_ffn", spy)
    return seen


def _spy_reference(monkeypatch):
    """Record the reference dispatch's own per-expert counts (its
    ``bincount``) and its padded ``xg``."""
    seen = {}
    real_bincount, real_ffn = jmp.jnp.bincount, jmp._grouped_ffn

    def bincount(x, *args, **kwargs):
        out = real_bincount(x, *args, **kwargs)
        seen["counts"] = np.asarray(out)
        return out

    def ffn(xg, *args):
        seen["xg"] = np.asarray(xg)
        return real_ffn(xg, *args)

    monkeypatch.setattr(jmp.jnp, "bincount", bincount)
    monkeypatch.setattr(jmp, "_grouped_ffn", ffn)
    return seen


def _dispatch_inputs(drop, T=24, D=16, H=32, E=4, K=2):
    gv, gi = _routing(T, E, K, seed=4, skew=2.5)
    rng = np.random.default_rng(5)
    tokens = rng.normal(size=(T, D)).astype(np.float32)
    dm = None
    if drop:
        dm = np.zeros((T, K), bool)
        dm[:, 1] = rng.random(T) < 0.5
    return tokens, gv, gi, dm, _ffn_weights(E, D, H, seed=6)


@pytest.mark.parametrize("drop", [False, True])
def test_dispatch_rows_are_the_references_counts(interpret, monkeypatch, drop):
    """The dispatch hands the grouped FFN ``rows = min(count, capacity)``
    (int32), from the same counts the reference's dispatch makes, with and
    without a drop mask (dropped pairs count for no expert); its xg equals
    the reference's on the first ``capacity`` rows of each expert, and is
    the zero token past ``rows[e]``."""
    capacity, E = 12, 4
    tokens, gv, gi, dm, w = _dispatch_inputs(drop, E=E)
    jseen, tseen = _spy_reference(monkeypatch), _spy_port(monkeypatch)
    jmp.moe_dispatch_combine(jnp.asarray(tokens), jnp.asarray(gv), jnp.asarray(gi),
                             None if dm is None else jnp.asarray(dm),
                             *(jnp.asarray(a) for a in w), capacity=capacity,
                             activation=jax.nn.gelu)
    with torch.no_grad():
        mp.moe_dispatch_combine(torch.from_numpy(tokens), torch.from_numpy(gv),
                                torch.from_numpy(gi), None if dm is None else torch.from_numpy(dm),
                                *(torch.from_numpy(a) for a in w), capacity=capacity,
                                activation="gelu")
    want = np.minimum(jseen["counts"][:E], capacity)
    rows = tseen["rows"]
    assert rows.dtype == torch.int32 and rows.shape == (E,)
    np.testing.assert_array_equal(rows.numpy(), want)
    assert want[0] == capacity and want.min() < capacity  # a full and a padded expert
    xg = tseen["xg"].numpy().reshape(E, capacity, -1)
    jxg = jseen["xg"].reshape(E, -1, xg.shape[-1])
    np.testing.assert_array_equal(xg, jxg[:, :capacity])
    for e in range(E):
        assert not xg[e, want[e]:].any() and xg[e, :want[e]].any(axis=-1).all()


def test_dispatch_padding_rows_get_zero_gradient(interpret, monkeypatch):
    """Backward through the dispatch: dy, the gradient reaching the grouped
    FFN's output, is exactly 0 on every row past ``rows[e]``, as in the
    reference's dispatch (its combine gathers no padding row with a nonzero
    weight); the port's gradients equal the reference's."""
    capacity, E = 12, 4
    tokens, gv, gi, dm, w = _dispatch_inputs(True, E=E)
    g = np.random.default_rng(7).normal(size=tokens.shape).astype(np.float32)
    tseen = _spy_port(monkeypatch)
    leaves = [_t(a).requires_grad_() for a in (tokens, gv, *w)]
    out = mp.moe_dispatch_combine(leaves[0], leaves[1], torch.from_numpy(gi),
                                  torch.from_numpy(dm), *leaves[2:], capacity=capacity,
                                  activation="gelu")
    (out * _t(g)).sum().backward()
    rows, dy = tseen["rows"], tseen["dy"].reshape(E, capacity, -1)
    for e in range(E):
        assert not dy[e, int(rows[e]):].any()
    assert dy.abs().sum() > 0

    def jloss(tok, gvals, w1, b1, w2, b2):
        return jnp.sum(jmp.moe_dispatch_combine(tok, gvals, jnp.asarray(gi), jnp.asarray(dm), w1,
                                                b1, w2, b2, capacity=capacity,
                                                activation=jax.nn.gelu) * g)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*(jnp.asarray(a) for a in (tokens, gv, *w)))
    for t, jg in zip(leaves, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), _np(jg), **GRAD)


def _ffn_call(xg, w, dy, rows):
    """y, s and the five gradients of the plain grouped FFN (CPU autograd
    through ``_GroupedFFN``)."""
    leaves = [_t(a).requires_grad_() for a in (xg, *w)]
    y = mp.grouped_ffn(*leaves, "gelu", rows)
    (y * _t(dy)).sum().backward()
    _, s = mp.moe_grouped_ffn_fwd(*(t.detach() for t in leaves), "gelu", rows)
    return [y.detach(), s] + [t.grad for t in leaves]


def test_plain_ffn_rows_on_zero_token_padding_change_nothing():
    """On inputs the dispatch makes (zero tokens and zero gradients past
    ``rows[e]``), the plain grouped FFN with ``rows`` gives exactly what it
    gives without them: ``rows`` only names what is already padding."""
    E, cap, D, H = 3, 8, 16, 40
    rows = torch.tensor([8, 3, 0], dtype=torch.int32)
    rng = np.random.default_rng(30)
    xg, dy = (rng.normal(size=(E * cap, D)).astype(np.float32) for _ in range(2))
    live = (np.arange(cap)[None, :] < rows.numpy()[:, None]).reshape(-1, 1)
    xg, dy = xg * live, dy * live
    w = _ffn_weights(E, D, H, seed=31)
    for a, b, name in zip(_ffn_call(xg, w, dy, rows), _ffn_call(xg, w, dy, None),
                          ("y", "s", "dx", "dw1", "db1", "dw2", "db2")):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)


def test_plain_ffn_rows_ignore_junk_padding():
    """With ``rows``, whatever xg and dy hold past ``rows[e]`` changes
    nothing: the padding rows are the zero token (s = b1, y the zero
    token's) with a zero gradient (dx = 0 there)."""
    E, cap, D, H = 3, 8, 16, 40
    rows = torch.tensor([5, 0, 8], dtype=torch.int32)
    rng = np.random.default_rng(32)
    junk_x, junk_dy = (rng.normal(size=(E * cap, D)).astype(np.float32) for _ in range(2))
    live = (np.arange(cap)[None, :] < rows.numpy()[:, None]).reshape(-1, 1)
    w = _ffn_weights(E, D, H, seed=33)
    got = _ffn_call(junk_x, w, junk_dy, rows)
    want = _ffn_call(junk_x * live, w, junk_dy * live, rows)
    for a, b, name in zip(got, want, ("y", "s", "dx", "dw1", "db1", "dw2", "db2")):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=name)
    y, s, dx = (t.reshape(E, cap, -1) for t in got[:3])
    torch.testing.assert_close(s[1], _t(w[1])[1].expand(cap, -1), atol=0, rtol=0)
    assert not dx[0, 5:].any() and not dx[1].any()
    b1, w2, b2 = (_t(a)[0] for a in w[1:])
    zero_token_y = mp._act(b1, "gelu") @ w2 + b2  # expert 0's y of the zero token
    torch.testing.assert_close(y[0, 5:], zero_token_y.expand(3, -1), **FWD)


# ------------------------------------------------------------- (c) gates


@pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
def test_gates_match_paddle_tpu(gate, interpret):
    """Scores, softmax top-k and the aux loss of each gate, on the same
    weight and tokens; the capacity pairs and routing switches agree."""
    D, E, T = 16, 6, 40
    jcls = {"naive": jmoe.NaiveGate, "gshard": jmoe.GShardGate, "switch": jmoe.SwitchGate}[gate]
    tcls = {"naive": tmoe.NaiveGate, "gshard": tmoe.GShardGate, "switch": tmoe.SwitchGate}[gate]
    jg, tg = jcls(D, E), tcls(D, E, device="cpu")
    assert (jg.topk, jg.capacity, jg.random_routing) == (tg.topk, tg.capacity, tg.random_routing)
    weight = np.array(jg.weight.numpy())
    with torch.no_grad():
        tg.weight.copy_(torch.from_numpy(weight))
    x = np.random.default_rng(7).normal(size=(T, D)).astype(np.float32)
    scores_j = jg.score(jnp.asarray(x))
    probs_j = jax.nn.softmax(scores_j, axis=-1)
    vals_j, idx_j = jax.lax.top_k(probs_j, jg.topk)
    aux_j = type(jg).aux_loss(probs_j, idx_j, E)
    with torch.no_grad():
        scores = tg.score(torch.from_numpy(x))
        probs = torch.softmax(scores, dim=-1)
        vals, idx = torch.topk(probs, tg.topk, dim=-1)
        aux = type(tg).aux_loss(probs, idx, E)
    np.testing.assert_allclose(scores.numpy(), _np(scores_j), **FWD)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(vals.numpy(), _np(vals_j), **FWD)
    np.testing.assert_allclose(float(aux), float(aux_j), **FWD)


@pytest.mark.parametrize("p2", [0.05, 0.2, 0.45, 0.7])
def test_gshard_jitter_keep_rate(p2):
    """The second expert is kept with probability min(1, 2·p2): over 20000
    tokens from a seeded generator the keep rate is within 0.02 of it (more
    than five standard deviations); the first rank is never dropped."""
    n = 20000
    gv = torch.tensor([[1.0 - p2, p2]]).expand(n, 2).contiguous()
    drop = tmoe.jitter_drop_mask(gv, torch.Generator().manual_seed(11))
    assert not drop[:, 0].any()
    assert abs((1.0 - drop[:, 1].float().mean().item()) - min(1.0, 2 * p2)) < 0.02


def test_gshard_jitter_only_in_training_and_reseedable(monkeypatch):
    layer = tmoe.MoELayer(16, 32, 4, device="cpu", seed=3)
    calls = []
    real = tmoe.jitter_drop_mask
    monkeypatch.setattr(tmoe, "jitter_drop_mask", lambda gv, gen: calls.append(1) or real(gv, gen))
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 50, 16)).astype(np.float32))
    with torch.no_grad():
        layer.eval()
        a, b = layer(x), layer(x)
        assert not calls and torch.equal(a, b)
        layer.train()
        t1 = layer(x)
        layer.generator.manual_seed(layer.seed)
        t2 = layer(x)
    assert len(calls) == 2 and torch.equal(t1, t2)


# ----------------------------------------------------------- (d) MoELayer


@pytest.mark.parametrize("gate,act", [("gshard", "gelu"), ("switch", "relu"), ("naive", "silu")])
def test_moe_layer_matches_paddle_tpu(interpret, gate, act):
    """Output and aux loss in training (capacity factor 1.2 from the gate's
    pair, 1.25 for the naive gate's default; random routing off on both)
    and in eval (2.4, or 2.0); the skewed tokens overflow the training
    capacity."""
    D, H, E = 16, 32, 4
    paddle.seed(21)
    jl = jmoe.MoELayer(D, H, E, gate=gate, activation=act)
    tl = tmoe.MoELayer(D, H, E, gate=gate, activation=act, device="cpu")
    state = {k: torch.from_numpy(np.array(v.numpy())) for k, v in jl.state_dict().items()}
    tl.load_state_dict(state)
    jl.gate.random_routing = tl.gate.random_routing = False
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    x[:, :, :4] += 1.5  # push the scores towards a few experts
    for train in (True, False):
        jl.train() if train else jl.eval()
        tl.train(train)
        want = np.asarray(jl(paddle.to_tensor(x)).numpy())
        with torch.no_grad():
            got = tl(torch.from_numpy(x))
        cf = ((1.25, 2.0) if gate == "naive" else (1.2, 2.4))[0 if train else 1]
        assert tl.capacity(24) == max(1, math.ceil(24 * tl.top_k * cf / E))
        np.testing.assert_allclose(got.numpy(), want, err_msg=f"train={train}", **FWD)
        np.testing.assert_allclose(float(tl.aux_loss), float(_np(jl.aux_loss.numpy())), **FWD)


# ---------------------------------------------------------- (e) GPT-MoE


def _converted_pair(seed, **cfg_kw):
    """A paddle_tpu GPT made from ``seed`` and the port's, with its weights
    carried across by ``utils/convert``; random routing off on both."""
    paddle.seed(seed)
    jm = JGPT(JGPTConfig.tiny(**cfg_kw))
    pm = GPTForPretraining(GPTConfig.tiny(**cfg_kw), device="cpu")
    pm.load_state_dict(state_dict_from_paddle_tpu(
        {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}))
    for j, t in zip(jm.gpt.layers, pm.gpt.layers):
        if j.moe is not None:
            j.moe.gate.random_routing = t.moe.gate.random_routing = False
    return jm, pm


def _ids(shape, seed, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("cfg_kw", [dict(moe=4, moe_every=1), dict(moe=4, moe_every=2),
                                    dict(stacked=False)], ids=["moe_every1", "moe_every2", "dense"])
def test_gpt_per_layer_and_moe_logits_match_paddle_tpu(interpret, cfg_kw):
    jm, pm = _converted_pair(seed=31, **cfg_kw)
    jm.eval()
    pm.eval()
    ids = _ids((2, 24), seed=32)
    jout = jm(paddle.to_tensor(ids))
    with torch.no_grad():
        out = pm(torch.from_numpy(ids).long())
    if "moe" in cfg_kw:
        n_moe = sum(blk.moe is not None for blk in pm.gpt.layers)
        assert n_moe == {1: 2, 2: 1}[cfg_kw["moe_every"]]
        (logits, aux), (jlogits, jaux) = out, jout
        np.testing.assert_allclose(float(aux), float(_np(jaux.numpy())), **FWD)
    else:
        logits, jlogits = out, jout
        assert not isinstance(out, tuple) and pm.gpt.moe_aux_loss is None
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits.numpy()), atol=2e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="stacked"):
        pm.generate(ids[:1, :4], max_new_tokens=2)


def test_convert_checks_per_layer_names_and_shapes(interpret):
    jm, _ = _converted_pair(seed=33, moe=4)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_paddle_tpu({k: v for k, v in state.items() if k != "gpt.layers.1.moe.w1"})
    with pytest.raises(KeyError, match="extra"):
        state_dict_from_paddle_tpu({**state, "gpt.layers.1.ffn1.weight": state["gpt.layers.0.ffn1.weight"]})
    with pytest.raises(ValueError, match="moe.w2"):
        state_dict_from_paddle_tpu({**state, "gpt.layers.1.moe.w2": state["gpt.layers.1.moe.w1"]})
    with pytest.raises(ValueError, match="qkv_proj"):
        state_dict_from_paddle_tpu({**state, "gpt.layers.0.attn.qkv_proj.weight":
                                    state["gpt.layers.0.attn.qkv_proj.weight"][:, :96]})


# ------------------------------------------------------- (f) TrainStep

LR = 1e-3
# parameters after three AdamW steps at lr 1e-3: each step moves a parameter
# by about lr * sign(g) at first, so an entry whose gradient sits at the f32
# noise of the two sides' sums may land up to 2 lr per step apart; atol 1e-4
# holds where the gradients stand above that noise (as in
# tests/test_torch_train.py)
PARAMS_AFTER = dict(atol=1e-4, rtol=1e-4)


def test_train_steps_match_paddle_tpu(interpret):
    """Three f32 AdamW steps of a tiny GPT-MoE (two MoE blocks of 4 experts,
    capacity factor 1.25, aux coefficient 0.01) on one batch: every loss
    and the parameters after step 3; the port's steps go through
    ``pallas_sorted``."""
    jm, pm = _converted_pair(seed=35, moe=4, moe_every=1)
    batches = [_ids((2, 16), seed=36)] * 3
    jstep = JTrainStep(jm, paddle.optimizer.AdamW(learning_rate=LR, parameters=jm.parameters()),
                       JCriterion())
    tstep = TrainStep(pm, AdamW(learning_rate=LR, parameters=pm.named_parameters()),
                      GPTPretrainingCriterion())
    metrics.reset_counters("kernels.moe.")
    jl = [float(jstep(paddle.to_tensor(b), paddle.to_tensor(b))["loss"].numpy()) for b in batches]
    tl = [float(tstep(b, b)["loss"]) for b in batches]
    assert metrics.counters("kernels.moe.") == {"kernels.moe.picked": 1, "kernels.moe.fallback": 0}
    np.testing.assert_allclose(tl, jl, **GRAD)
    assert tl[-1] < tl[0]
    jparams = {n: np.asarray(jnp.asarray(v, jnp.float32)) for n, v in jstep.state["params"].items()}
    for n, p in pm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jparams[n], err_msg=n, **PARAMS_AFTER)


# ----------------------------------------------------------- (g) registry


def test_registry_picks_pallas_sorted_and_honours_override(interpret):
    T, D, H, E, K = 16, 8, 16, 2, 2
    gv, gi = _routing(T, E, K, seed=12)
    w = tuple(torch.from_numpy(a) for a in _ffn_weights(E, D, H, seed=13))
    call = (torch.from_numpy(np.random.default_rng(14).normal(size=(T, D)).astype(np.float32)),
            torch.from_numpy(gv), torch.from_numpy(gi), None, *w)
    metrics.reset_counters("kernels.moe.")
    out = registry.dispatch("moe", *call, capacity=16, activation="gelu")
    assert registry.select("moe", *call, capacity=16, activation="gelu").name == "pallas_sorted"
    assert metrics.counters("kernels.moe.") == {"kernels.moe.picked": 1, "kernels.moe.fallback": 0}
    assert registry.implementations("moe") == ["pallas_sorted", "dense"]
    _FLAGS["FLAGS_kernel_overrides"] = "moe=dense"
    impl = registry.select("moe", *call, capacity=16, activation="gelu")
    assert impl.name == "dense" and impl.fallback
    torch.testing.assert_close(impl.fn(*call, capacity=16, activation="gelu"), out, **FWD)
    # shapes the predicate rejects fall back to dense; the jax side agrees
    assert registry.select("moe", *call, capacity=16, activation="tanh").name == "dense"


def test_predicate_takes_the_cuda_kernels_limits():
    """The rule of K4/K4b for a ``cuda`` device, evaluated without a card:
    f32 and bf16, gelu/relu/silu, any D, H and capacity (the kernels mask
    ragged tiles) within the launch grid."""
    ok = dict(num_experts=8, d_model=1024, d_hidden=4096, capacity=4096, dtype=torch.float32,
              activation="gelu", device_type="cuda")
    assert mp.moe_kernel_available(**ok)
    assert mp.moe_kernel_available(**{**ok, "dtype": torch.bfloat16})
    assert mp.moe_kernel_available(**{**ok, "d_model": 200, "d_hidden": 328, "capacity": 77})
    assert not mp.moe_kernel_available(**{**ok, "dtype": torch.float16})
    assert not mp.moe_kernel_available(**{**ok, "activation": "tanh"})
    assert not mp.moe_kernel_available(**{**ok, "num_experts": 65536})
    assert not mp.moe_kernel_available(**{**ok, "capacity": 65536 * 128 + 1})
    assert not mp.moe_kernel_available(**{**ok, "capacity": 0})
    assert not mp.moe_kernel_available(**{**ok, "device_type": "mps"})
    tok = torch.zeros((4, 8))
    w = (torch.zeros(2, 8, 16), torch.zeros(2, 1, 16), torch.zeros(2, 16, 8), torch.zeros(2, 1, 8))
    gv, gi = torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.long)
    assert mp.moe_available(tok, gv, gi, None, *w, capacity=4, activation="gelu")
    assert not mp.moe_available(tok, gv, gi, None, w[0].bfloat16(), *w[1:], capacity=4,
                                activation="gelu")
    assert not mp.moe_available(tok, gv, gi, None, w[0], w[1], w[2][:, :8], w[3], capacity=4,
                                activation="gelu")


def test_predicate_bf16_needs_tma_aligned_widths():
    """bf16 K4/K4b read their operands by TMA, whose row strides are
    16-byte multiples: D and H must be multiples of 8 in bf16; f32 (the
    SIMT kernels, 4-byte copies at a ragged edge) takes any widths. The
    rule holds for the dispatch's predicate too."""
    ok = dict(num_experts=8, d_model=1024, d_hidden=4096, capacity=77, dtype=torch.bfloat16,
              activation="gelu", device_type="cuda")
    assert mp.moe_kernel_available(**ok)
    assert mp.moe_kernel_available(**{**ok, "d_model": 200, "d_hidden": 328})
    for bad in (dict(d_model=1020), dict(d_hidden=4100), dict(d_model=130, d_hidden=64)):
        assert not mp.moe_kernel_available(**{**ok, **bad})
        assert mp.moe_kernel_available(**{**ok, **bad, "dtype": torch.float32})
    tok = torch.zeros((4, 12), dtype=torch.bfloat16)
    w = tuple(torch.zeros(s, dtype=torch.bfloat16) for s in ((2, 12, 16), (2, 1, 16), (2, 16, 12),
                                                             (2, 1, 12)))
    gv, gi = torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.long)
    assert not mp.moe_available(tok, gv, gi, None, *w, capacity=4, activation="gelu")
    assert mp.moe_available(tok.float(), gv, gi, None, *(t.float() for t in w), capacity=4,
                            activation="gelu")


def test_criterion_adds_the_aux_loss():
    rng = np.random.default_rng(15)
    logits = torch.from_numpy(rng.normal(size=(2, 5, 30)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 30, (2, 5)))
    mask = torch.from_numpy((rng.random((2, 5)) > 0.3).astype(np.float32))
    aux = torch.tensor(1.7)
    crit = GPTPretrainingCriterion(moe_aux_coef=0.5)
    for m in (None, mask):
        torch.testing.assert_close(crit((logits, aux), labels, m), crit(logits, labels, m) + 0.85)


# ------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain version in true f32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,act", [((2, 150, 72, 200), "gelu"), ((4, 256, 256, 512), "gelu"),
                                       ((3, 77, 130, 64), "relu"), ((2, 128, 128, 256), "silu")])
def test_kernels_match_plain_on_card(card, shape, act, dtype):
    """K4 and K4b against the plain versions in f32 on the same inputs
    (bf16 inputs widened). The largest error over each output, relative to
    that output's largest magnitude: f32 at most 2e-5 (f32 sums over up to
    a few hundred terms in another order); bf16 at most 1e-2 (the kernel
    rounds h, dh and its outputs to bf16, 2**-8 relative each). Three rows
    of dy are zero, as padding rows' are. A bf16 width that is no multiple
    of 8 (D = 130) is not the bf16 kernels' (TMA's 16-byte row strides):
    the predicate refuses it and the wrapper raises, launching nothing."""
    E, cap, D, H = shape
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(16)
    xg = torch.randn(E * cap, D, generator=g)
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _ffn_weights(E, D, H, seed=17))
    dy = torch.randn(E * cap, D, generator=g)
    dy[cap - 3:cap] = 0
    args = [t.to(card, dt) for t in (xg, w1, b1, w2, b2)]
    before = mp.moe_grouped_ffn_fwd.launches, mp.moe_grouped_ffn_bwd.launches
    if dt == torch.bfloat16 and (D % 8 or H % 8):
        assert not mp.moe_kernel_available(E, D, H, cap, dt, act)
        with pytest.raises(ValueError, match="multiples of 8"):
            mp.moe_grouped_ffn_fwd(*args, act)
        assert mp.moe_grouped_ffn_fwd.launches == before[0]
        return
    y, s = mp.moe_grouped_ffn_fwd(*args, act)
    grads = mp.moe_grouped_ffn_bwd(*args, s, dy.to(card, dt), act)
    torch.cuda.synchronize()
    assert (mp.moe_grouped_ffn_fwd.launches, mp.moe_grouped_ffn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_args = [t.float() for t in args]
    want_y, want_s = mp._reference_ffn_fwd(*ref_args, act)
    want = mp._reference_ffn_bwd(*ref_args, want_s, dy.to(card), act)
    lim = 2e-5 if dtype == "float32" else 1e-2
    assert y.dtype == dt and s.dtype == torch.float32
    for name, got, w_ in zip(("y", "s", "dx", "dw1", "db1", "dw2", "db2"), (y, s, *grads),
                             (want_y, want_s, *want)):
        assert _rel_err(got, w_) <= lim, (name, _rel_err(got, w_))


@pytest.mark.cuda
def test_dispatch_combine_on_card_matches_cpu(card):
    """``moe_dispatch_combine`` and its gradients on the card (K4 + K4b
    through the autograd function) against the same call on the CPU (the
    plain versions); f32, relative max error at most 2e-5."""
    T, D, H, E, K, capacity = 300, 128, 256, 4, 2, 120
    gv, gi = _routing(T, E, K, seed=18, skew=1.0)
    rng = np.random.default_rng(19)
    host = [torch.from_numpy(a) for a in (rng.normal(size=(T, D)).astype(np.float32), gv,
                                          *_ffn_weights(E, D, H, seed=20))]
    g = torch.from_numpy(rng.normal(size=(T, D)).astype(np.float32))
    results = []
    for device in (card, torch.device("cpu")):
        leaves = [t.to(device).requires_grad_() for t in host]
        out = mp.moe_dispatch_combine(leaves[0], leaves[1], torch.from_numpy(gi).to(device), None,
                                      *leaves[2:], capacity=capacity, activation="gelu")
        (out * g.to(device)).sum().backward()
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(*results):
        assert _rel_err(got, want) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,rows", [
    ((4, 256, 256, 512), (90, 0, 256, 13)),  # fill 0.35, an empty and a full expert
    ((3, 77, 200, 328), (77, 1, 30)),        # a ragged capacity
    ((2, 300, 128, 256), (128, 300)),        # rows[e] on a 128-row tile edge
    ((8, 512, 128, 256), (179, 129, 0, 512, 37, 256, 255, 1)),
])
def test_kernels_honour_rows_on_card(card, shape, rows, dtype):
    """K4 and K4b with live ``rows`` and junk (random values) in the padding
    rows of xg and dy, against the plain versions on the same inputs (which
    zero the junk), at the tolerances of ``test_kernels_match_plain_on_card``.
    The junk can only be ignored if the kernels honour ``rows``. The padding
    rows hold the zero token's values: s = b1 and dx = 0 exactly, and one y
    row per expert, whichever row of its padding it is."""
    E, cap, D, H = shape
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(24)
    xg = torch.randn(E * cap, D, generator=g)
    dy = torch.randn(E * cap, D, generator=g)
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _ffn_weights(E, D, H, seed=25))
    args = [t.to(card, dt) for t in (xg, w1, b1, w2, b2)]
    live = torch.tensor(rows, dtype=torch.int32, device=card)
    before = mp.moe_grouped_ffn_fwd.launches, mp.moe_grouped_ffn_bwd.launches
    y, s = mp.moe_grouped_ffn_fwd(*args, "gelu", live)
    grads = mp.moe_grouped_ffn_bwd(*args, s, dy.to(card, dt), "gelu", live)
    torch.cuda.synchronize()
    assert (mp.moe_grouped_ffn_fwd.launches, mp.moe_grouped_ffn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_args = [t.float() for t in args]
    want_y, want_s = mp._reference_ffn_fwd(*ref_args, "gelu", live)
    want = mp._reference_ffn_bwd(*ref_args, want_s, dy.to(card, dt).float(), "gelu", live)
    lim = 2e-5 if dtype == "float32" else 1e-2
    for name, got, w_ in zip(("y", "s", "dx", "dw1", "db1", "dw2", "db2"), (y, s, *grads),
                             (want_y, want_s, *want)):
        assert bool(torch.isfinite(got.float()).all()), name
        assert _rel_err(got, w_) <= lim, (name, _rel_err(got, w_))
    y3, s3, dx3 = (t.reshape(E, cap, -1) for t in (y, s, grads[0]))
    for e, r in enumerate(rows):
        if r == cap:
            continue
        torch.testing.assert_close(s3[e, r:], args[2][e].float().expand(cap - r, -1), atol=0,
                                   rtol=0)
        assert not dx3[e, r:].any()
        torch.testing.assert_close(y3[e, r:], y3[e, r:r + 1].expand(cap - r, -1), atol=0, rtol=0)
