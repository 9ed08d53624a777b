"""The rest of the port's ``nn`` library against ``paddle_tpu``'s, on the
CPU: the functional tail (``extension_ops``), the sequence ops, the
losses and their layers, the extension layers, ``ParamAttr``, and the
weight conversion of ``HSigmoidLoss`` and ``Bilinear``.

The same numpy inputs go through both packages (ints where the reference
takes ids, lengths or labels); f32 results agree to atol 1e-5 / rtol
1e-5 (elementwise formulas and reductions of a few hundred terms in
another order). The losses with a loop of their own (``ctc_loss``,
``hsigmoid_loss``) and ``grid_sample`` are also held by their input
gradients (atol 1e-5 / rtol 1e-4). ``class_center_sample`` draws fresh
entropy on both sides, so its invariants are checked, and its draw is
compared where every class is a positive.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
import paddle_tpu.nn.functional as jF  # noqa: E402

from paddle_tpu_torch.distributed import mp_layers as mpl  # noqa: E402
from paddle_tpu_torch.framework.param_attr import ParamAttr  # noqa: E402
from paddle_tpu_torch.nn import functional as tF  # noqa: E402
from paddle_tpu_torch.nn import initializer as I  # noqa: E402
from paddle_tpu_torch.nn import layer as L  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_by_name  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _u(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.05, 0.95, shape).astype(np.float32)


def _i(shape, high, seed=0, low=0):
    return np.random.default_rng(seed).integers(low, high, shape).astype(np.int64)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _flat(o)]
    return [out]


def _compare(fn, *arrays, tol=TOL):
    """``fn(F, *tensors)`` on both packages' functionals."""
    want = _flat(fn(jF, *(paddle.to_tensor(a) for a in arrays)))
    got = _flat(fn(tF, *(torch.from_numpy(a) for a in arrays)))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), _np(w), **tol)


# -- the functional tail -----------------------------------------------------------------
def _pool_mask(n):
    x = _x((2, 3) + (6,) * n, 31)
    fn = {1: jF.max_pool1d, 2: jF.max_pool2d, 3: jF.max_pool3d}[n]
    out, idx = fn(paddle.to_tensor(x), 2, return_mask=True)
    return _np(out), _np(idx).astype(np.int64)


EXT = {
    "pixel_shuffle": (lambda F, x: F.pixel_shuffle(x, 2), [_x((2, 8, 3, 3))]),
    "pixel_shuffle_nhwc": (lambda F, x: F.pixel_shuffle(x, 2, "NHWC"), [_x((2, 3, 3, 8))]),
    "pixel_unshuffle": (lambda F, x: F.pixel_unshuffle(x, 2), [_x((2, 2, 6, 4))]),
    "pixel_unshuffle_nhwc": (lambda F, x: F.pixel_unshuffle(x, 2, "NHWC"), [_x((2, 6, 4, 2))]),
    "channel_shuffle": (lambda F, x: F.channel_shuffle(x, 3), [_x((2, 6, 2, 3))]),
    "channel_shuffle_nhwc": (lambda F, x: F.channel_shuffle(x, 2, "NHWC"), [_x((2, 2, 3, 6))]),
    "zeropad2d": (lambda F, x: F.zeropad2d(x, [1, 2, 0, 3]), [_x((2, 3, 4, 5))]),
    "zeropad2d_nhwc": (lambda F, x: F.zeropad2d(x, 1, "NHWC"), [_x((2, 4, 5, 3))]),
    "diag_embed": (lambda F, x: F.diag_embed(x), [_x((2, 3, 4))]),
    "diag_embed_offset_dims": (lambda F, x: F.diag_embed(x, offset=-1, dim1=0, dim2=2),
                               [_x((3, 4))]),
    "temporal_shift": (lambda F, x: F.temporal_shift(x, 3, 0.25), [_x((6, 8, 2, 2))]),
    "temporal_shift_nhwc": (lambda F, x: F.temporal_shift(x, 2, 0.2, "NHWC"), [_x((4, 2, 2, 10))]),
    "affine_grid": (lambda F, t: F.affine_grid(t, [2, 3, 4, 5]), [_x((2, 2, 3))]),
    "affine_grid_unaligned": (lambda F, t: F.affine_grid(t, [2, 3, 4, 5], align_corners=False),
                              [_x((2, 2, 3))]),
    "grid_sample": (lambda F, x, g: F.grid_sample(x, g), [_x((2, 3, 5, 6)), 1.2 * _x((2, 4, 3, 2), 2)]),
    "grid_sample_nearest_border": (lambda F, x, g: F.grid_sample(
        x, g, mode="nearest", padding_mode="border", align_corners=False),
        [_x((2, 3, 5, 6)), 1.2 * _x((2, 4, 3, 2), 2)]),
    "fold": (lambda F, x: F.fold(x, [5, 6], 2), [_x((2, 12, 20))]),
    "fold_strided": (lambda F, x: F.fold(x, [6, 7], [2, 3], strides=2, paddings=1, dilations=1),
                     [_x((2, 6 * 4, 16))]),
    "max_unpool1d": (lambda F, x, i: F.max_unpool1d(x, i, 2), list(_pool_mask(1))),
    "max_unpool2d": (lambda F, x, i: F.max_unpool2d(x, i, 2), list(_pool_mask(2))),
    "max_unpool3d": (lambda F, x, i: F.max_unpool3d(x, i, 2, output_size=[6, 6, 6]),
                     list(_pool_mask(3))),
    "gather_tree": (lambda F, i, p: F.gather_tree(i, p), [_i((5, 2, 3), 9, 3), _i((5, 2, 3), 3, 4)]),
    "sparse_attention": (lambda F, q, k, v, o, c: F.sparse_attention(q, k, v, o, c),
                         [_x((2, 2, 4, 8)), _x((2, 2, 4, 8), 1), _x((2, 2, 4, 8), 2),
                          np.array([[[0, 2, 3, 5, 7]] * 2] * 2, np.int64),
                          np.array([[[0, 1, 1, 0, 2, 1, 3]] * 2] * 2, np.int64)]),
}


@pytest.mark.parametrize("case", sorted(EXT))
def test_extension_ops_match_reference(case):
    fn, arrays = EXT[case]
    _compare(fn, *arrays)


def test_grid_sample_gradient_matches_reference():
    x, g = _x((2, 3, 5, 6)), 1.2 * _x((2, 4, 3, 2), 2)
    cot = _x((2, 3, 4, 3), 3)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x).requires_grad_(True)
    jx.stop_gradient = False
    (jF.grid_sample(jx, paddle.to_tensor(g)) * paddle.to_tensor(cot)).sum().backward()
    (tF.grid_sample(tx, torch.from_numpy(g)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **GRAD)


def test_class_center_sample_keeps_the_reference_contract():
    """Every positive is sampled, the sample is sorted and ``num_samples``
    long, the labels remap into it; with every class a positive both
    packages give the same sample. A group raises (the reference ignores
    it: "Faults in the reference")."""
    label = torch.from_numpy(_i((12,), 20, 5))
    remapped, sampled = tF.class_center_sample(label, 20, 9,
                                               generator=np.random.default_rng(0))
    pos = set(label.tolist())
    assert pos <= set(sampled.tolist()) and len(sampled) == max(9, len(pos))
    assert sampled.tolist() == sorted(sampled.tolist())
    assert torch.equal(sampled[remapped], label)
    full = _i((10,), 4, 6)
    want = jF.class_center_sample(paddle.to_tensor(full), 4, 2)
    got = tF.class_center_sample(torch.from_numpy(full), 4, 2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_np(g), _np(w))
    with pytest.raises(NotImplementedError, match="Faults in the reference"):
        tF.class_center_sample(label, 20, 9, group=object())


# -- sequence ops -------------------------------------------------------------------------
LENS = np.array([3, 0, 5, 2], np.int64)


@pytest.mark.parametrize("pool", ["sum", "average", "sqrt", "max", "first", "last"])
def test_sequence_pool_matches_reference(pool):
    _compare(lambda F, x, n: F.sequence_pool(x, n, pool), _x((4, 5, 3)), LENS)


def test_sequence_ops_match_reference():
    """``sequence_mask`` (its maxlen and dtype), ``sequence_pad`` and
    ``sequence_unpad`` round trip, ``sequence_softmax`` and
    ``sequence_expand``, forward and (expand, unpad) gradients."""
    _compare(lambda F, n: F.sequence_mask(n), LENS)
    _compare(lambda F, n: F.sequence_mask(n, maxlen=7, dtype="float32"), LENS)
    lens = np.array([3, 1, 5, 2], np.int64)
    _compare(lambda F, x, n: F.sequence_softmax(x, n), _x((4, 5, 2)), lens)
    seqs = [_x((int(n), 3), 10 + i) for i, n in enumerate(lens)]
    jp = jF.sequence_pad([paddle.to_tensor(s) for s in seqs], pad_value=-1.0, maxlen=6)
    tp = tF.sequence_pad([torch.from_numpy(s) for s in seqs], pad_value=-1.0, maxlen=6)
    for w, g in zip(jp, tp):
        np.testing.assert_array_equal(_np(g), _np(w))
    with pytest.raises(ValueError, match="maxlen"):
        tF.sequence_pad([torch.from_numpy(s) for s in seqs], maxlen=2)
    for w, g in zip(jF.sequence_unpad(*jp), tF.sequence_unpad(*tp)):
        np.testing.assert_array_equal(_np(g), _np(w))
    x = _x((4, 3))
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x).requires_grad_(True)
    jx.stop_gradient = False
    jo, to = jF.sequence_expand(jx, paddle.to_tensor(lens)), tF.sequence_expand(tx, torch.from_numpy(lens))
    np.testing.assert_array_equal(_np(to), _np(jo))
    cot = _x(tuple(to.shape), 5)
    (jo * paddle.to_tensor(cot)).sum().backward()
    (to * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **TOL)


# -- losses -------------------------------------------------------------------------------
LOSSES = {
    "softmax_with_cross_entropy": (lambda F, x, y: F.softmax_with_cross_entropy(
        x, y, return_softmax=True), [_x((4, 6)), _i((4, 1), 6)]),
    "softmax_with_cross_entropy_soft": (lambda F, x, y: F.softmax_with_cross_entropy(
        x, y, soft_label=True), [_x((4, 6)), _u((4, 6), 2)]),
    "mse_loss": (lambda F, a, b: F.mse_loss(a, b), [_x((4, 5)), _x((4, 5), 1)]),
    "mse_loss_none": (lambda F, a, b: F.mse_loss(a, b, "none"), [_x((4, 5)), _x((4, 5), 1)]),
    "l1_loss_sum": (lambda F, a, b: F.l1_loss(a, b, "sum"), [_x((4, 5)), _x((4, 5), 1)]),
    "smooth_l1_loss": (lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.5), [_x((4, 5)), _x((4, 5), 1)]),
    "nll_loss": (lambda F, x, y: F.nll_loss(x, y, ignore_index=2), [_x((6, 5)), _i((6,), 5, 3)]),
    "nll_loss_weight_nd": (lambda F, x, y, w: F.nll_loss(x, y, w), [_x((2, 5, 3)), _i((2, 3), 5, 4),
                                                                    _u((5,), 5)]),
    "binary_cross_entropy": (lambda F, p, y, w: F.binary_cross_entropy(p, y, w),
                             [_u((4, 3)), _i((4, 3), 2, 1).astype(np.float32), _u((4, 3), 2)]),
    "bce_with_logits": (lambda F, z, y: F.binary_cross_entropy_with_logits(z, y),
                        [_x((4, 3)), _i((4, 3), 2, 1).astype(np.float32)]),
    "bce_with_logits_pos_weight": (lambda F, z, y, pw, w: F.binary_cross_entropy_with_logits(
        z, y, w, "sum", pw), [_x((4, 3)), _i((4, 3), 2, 1).astype(np.float32), _u((3,), 3),
                              _u((4, 3), 4)]),
    "kl_div": (lambda F, x, y: F.kl_div(x, y), [_x((4, 5)), _u((4, 5), 1)]),
    "kl_div_batchmean": (lambda F, x, y: F.kl_div(x, y, "batchmean"), [_x((4, 5)), _u((4, 5), 1)]),
    "margin_ranking_loss": (lambda F, a, b, y: F.margin_ranking_loss(a, b, y, 0.1),
                            [_x((6,)), _x((6,), 1), np.sign(_x((6,), 2))]),
    "hinge_embedding_loss": (lambda F, a, y: F.hinge_embedding_loss(a, y, 0.5),
                             [_x((6,)), np.where(_x((6,), 2) > 0, 1.0, -1.0).astype(np.float32)]),
    "cosine_embedding_loss": (lambda F, a, b, y: F.cosine_embedding_loss(a, b, y, 0.2),
                              [_x((5, 4)), _x((5, 4), 1), np.array([1, -1, 1, -1, -1], np.int64)]),
    "triplet_margin_loss": (lambda F, a, p, n: F.triplet_margin_loss(a, p, n, swap=True),
                            [_x((5, 4)), _x((5, 4), 1), _x((5, 4), 2)]),
    "log_loss": (lambda F, p, y: F.log_loss(p, y), [_u((4, 1)), _i((4, 1), 2).astype(np.float32)]),
    "square_error_cost": (lambda F, a, b: F.square_error_cost(a, b), [_x((4, 3)), _x((4, 3), 1)]),
    "sigmoid_focal_loss": (lambda F, z, y, n: F.sigmoid_focal_loss(z, y, n),
                           [_x((4, 3)), _i((4, 3), 2, 1).astype(np.float32),
                            np.array(3.0, np.float32)]),
    "dice_loss": (lambda F, p, y: F.dice_loss(p, y), [_u((3, 4, 5)), _i((3, 4, 1), 5)]),
    "npair_loss": (lambda F, a, p, y: F.npair_loss(a, p, y), [_x((6, 4)), _x((6, 4), 1),
                                                              _i((6,), 3, 2)]),
    "margin_cross_entropy": (lambda F, x, y: F.margin_cross_entropy(x, y, return_softmax=True),
                             [np.tanh(_x((5, 7))), _i((5,), 7, 3)]),
    "margin_cross_entropy_sum": (lambda F, x, y: F.margin_cross_entropy(
        x, y, 0.9, 0.3, 0.1, 16.0, reduction="sum"), [np.tanh(_x((5, 7))), _i((5,), 7, 3)]),
}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_match_reference(case):
    fn, arrays = LOSSES[case]
    _compare(fn, *arrays)


def _ctc_inputs(T=12, B=3, C=6, L=4):
    logits = _x((T, B, C), 20)
    labels = _i((B, L), C, 21, low=1)
    return logits, labels, np.array([12, 10, 7], np.int64), np.array([4, 2, 3], np.int64)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_and_its_gradient_match_reference(reduction):
    logits, labels, il, ll = _ctc_inputs()
    jx, tx = paddle.to_tensor(logits), torch.from_numpy(logits).requires_grad_(True)
    jx.stop_gradient = False
    j = jF.ctc_loss(jx, *(paddle.to_tensor(a) for a in (labels, il, ll)), reduction=reduction)
    t = tF.ctc_loss(tx, *(torch.from_numpy(a) for a in (labels, il, ll)), reduction=reduction)
    np.testing.assert_allclose(_np(t), _np(j), **TOL)
    j.sum().backward()
    t.sum().backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **GRAD)


def test_ctc_loss_on_an_infeasible_alignment_is_finite_near_1e30():
    """A label longer than the input can emit: the -1e30 floor gives a
    finite loss near 1e30 on both sides (``torch.nn.functional.ctc_loss``
    gives inf)."""
    logits = _x((3, 1, 5), 22)
    labels, il, ll = np.array([[1, 2, 3, 4]], np.int64), np.array([3]), np.array([4])
    j = jF.ctc_loss(*(paddle.to_tensor(a) for a in (logits, labels, il, ll)), reduction="none")
    t = tF.ctc_loss(*(torch.from_numpy(np.asarray(a)) for a in (logits, labels, il, ll)),
                    reduction="none")
    assert np.isfinite(_np(t)).all() and float(t[0]) > 1e29
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6)
    lab = torch.from_numpy(labels)
    assert torch.isinf(torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits), -1), lab, torch.tensor([3]), torch.tensor([4]),
        blank=0, reduction="none"))[0]


@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_loss_layer_and_gradient_match_reference(bias):
    """``HSigmoidLoss`` (its weights carried by name) and the functional with
    and without the bias, and the input's gradient."""
    paddle.seed(23)
    jm = jnn.HSigmoidLoss(4, 7, bias_attr=None if bias else False)
    pm = L.HSigmoidLoss(4, 7, bias_attr=None if bias else False, device="cpu")
    assert tuple(pm.weight.shape) == (6, 4) and (pm.bias is None) == (not bias)
    pm.load_state_dict(state_dict_by_name({k: _np(v) for k, v in jm.state_dict().items()}, pm))
    if bias:
        with torch.no_grad():
            pm.bias.copy_(torch.from_numpy(_x((6, 1), 24)))
        jm.bias.set_value(_x((6, 1), 24))
    x, y = _x((5, 4), 25), _i((5, 1), 7, 26)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x).requires_grad_(True)
    jx.stop_gradient = False
    j, t = jm(jx, paddle.to_tensor(y)), pm(tx, torch.from_numpy(y))
    np.testing.assert_allclose(_np(t), _np(j), **TOL)
    j.backward()
    t.backward()
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **GRAD)


LOSS_LAYERS = {
    "MSELoss": ((), [_x((4, 3)), _x((4, 3), 1)]),
    "L1Loss": (("sum",), [_x((4, 3)), _x((4, 3), 1)]),
    "SmoothL1Loss": (("mean", 0.3), [_x((4, 3)), _x((4, 3), 1)]),
    "NLLLoss": ((None, 1), [_x((5, 4)), _i((5,), 4, 2)]),
    "BCELoss": ((), [_u((4, 3)), _i((4, 3), 2, 1).astype(np.float32)]),
    "BCEWithLogitsLoss": ((), [_x((4, 3)), _i((4, 3), 2, 1).astype(np.float32)]),
    "KLDivLoss": (("sum",), [_x((4, 5)), _u((4, 5), 1)]),
    "MarginRankingLoss": ((0.2,), [_x((6,)), _x((6,), 1), np.sign(_x((6,), 2))]),
    "HingeEmbeddingLoss": ((0.7,), [_x((6,)), np.where(_x((6,), 2) > 0, 1.0, -1.0).astype(np.float32)]),
    "CosineEmbeddingLoss": ((0.1,), [_x((5, 4)), _x((5, 4), 1), np.array([1, -1, 1, 1, -1])]),
    "TripletMarginLoss": ((0.5, 1.0), [_x((5, 4)), _x((5, 4), 1), _x((5, 4), 2)]),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layers_match_reference(name):
    args, arrays = LOSS_LAYERS[name]
    want = getattr(jnn, name)(*args)(*(paddle.to_tensor(a) for a in arrays))
    got = getattr(L, name)(*args)(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_ctc_layer_matches_reference():
    logits, labels, il, ll = _ctc_inputs()
    want = jnn.CTCLoss(blank=0)(*(paddle.to_tensor(a) for a in (logits, labels, il, ll)))
    got = L.CTCLoss(blank=0)(*(torch.from_numpy(a) for a in (logits, labels, il, ll)))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -- extension layers ---------------------------------------------------------------------
LAYERS = {
    "PixelShuffle": ((2,), [_x((2, 8, 3, 3))]),
    "PixelUnshuffle": ((2,), [_x((2, 2, 4, 6))]),
    "ChannelShuffle": ((2,), [_x((2, 6, 2, 2))]),
    "Fold": (([5, 6], 2), [_x((2, 12, 20))]),
    "MaxUnPool1D": ((2,), list(_pool_mask(1))),
    "MaxUnPool2D": ((2,), list(_pool_mask(2))),
    "MaxUnPool3D": ((2,), list(_pool_mask(3))),
    "Softmax2D": ((), [_x((2, 3, 4, 5))]),
    "ThresholdedReLU": ((0.3,), [_x((3, 4))]),
    "PairwiseDistance": ((3.0, 1e-6, True), [_x((4, 5)), _x((4, 5), 1)]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_extension_layers_match_reference(name):
    args, arrays = LAYERS[name]
    want = getattr(jnn, name)(*args)(*(paddle.to_tensor(a) for a in arrays))
    got = getattr(L, name)(*args)(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -- ParamAttr and the weight conversion ---------------------------------------------------
def test_param_attr_initializer_precedence_name_and_trainable():
    """The attribute's initializer before the global one, the global before
    the layer's default; ``name`` names the parameter (``param_name``); ``trainable=False``
    takes no gradient; ``learning_rate`` and ``regularizer`` are kept and
    not read (the same step either way); an initialiser passed as the
    attribute raises (the reference ignores it)."""
    attr = ParamAttr(name="w0", initializer=I.Constant(2.0), learning_rate=0.1,
                     regularizer="l2", trainable=False)
    I.set_global_initializer(I.Constant(0.5), I.Constant(-1.0))
    try:
        lin = L.Linear(3, 2, weight_attr=attr, device="cpu")
        assert torch.equal(lin.weight, torch.full((3, 2), 2.0)) and lin.weight.param_name == "w0"
        assert torch.equal(lin.bias, torch.full((2,), -1.0))
        norm = L.LayerNorm(4, device="cpu")
        assert torch.equal(norm.weight, torch.full((4,), 0.5))
        # the tensor-parallel layers' and the MoE layer's parameters too,
        # biases included, as the reference's
        from paddle_tpu.distributed import moe as jmoe, mp_layers as jmpl
        from paddle_tpu_torch.distributed.moe import MoELayer
        jnn.initializer.set_global_initializer(jnn.initializer.Constant(0.5),
                                               jnn.initializer.Constant(-1.0))
        try:
            pairs = [(mpl.ColumnParallelLinear(3, 4, device="cpu"), jmpl.ColumnParallelLinear(3, 4)),
                     (mpl.RowParallelLinear(3, 4, device="cpu"), jmpl.RowParallelLinear(3, 4)),
                     (MoELayer(8, 16, 4, device="cpu"), jmoe.MoELayer(8, 16, 4))]
        finally:
            jnn.initializer.set_global_initializer(None, None)
        for tl, jl in pairs:
            want = {k: _np(v) for k, v in jl.state_dict().items()}
            got = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert {float(v) for v in np.unique(want["bias" if "bias" in want else "b1"])} == {-1.0}
    finally:
        I.set_global_initializer(None, None)
    assert not lin.weight.requires_grad and lin.bias.requires_grad
    assert attr.learning_rate == 0.1 and attr.regularizer == "l2"
    assert torch.equal(L.LayerNorm(4, device="cpu").weight, torch.ones(4))
    for make in (lambda a: L.Conv2D(2, 3, 1, weight_attr=a, device="cpu"),
                 lambda a: L.Embedding(5, 3, weight_attr=a, device="cpu"),
                 lambda a: L.LSTMCell(2, 3, weight_hh_attr=a, device="cpu"),
                 lambda a: L.BatchNorm1D(3, weight_attr=a, device="cpu"),
                 lambda a: L.PReLU(weight_attr=a, device="cpu"),
                 lambda a: L.HSigmoidLoss(3, 4, weight_attr=a, device="cpu"),
                 lambda a: mpl.ColumnParallelLinear(3, 4, weight_attr=a, device="cpu"),
                 lambda a: mpl.RowParallelLinear(3, 4, weight_attr=a, device="cpu"),
                 lambda a: mpl.VocabParallelEmbedding(5, 3, weight_attr=a, device="cpu")):
        p = next(q for n, q in make(ParamAttr(name="p", initializer=I.Constant(3.0),
                                              trainable=False)).named_parameters(
        ) if n in ("weight", "weight_hh"))
        assert p.param_name == "p" and not p.requires_grad and bool((p == 3.0).all())
    # learning_rate is not read: a step is the same with 0.1 or 1.0
    steps = []
    for lr_scale in (0.1, 1.0):
        torch.manual_seed(0)
        lin = L.Linear(3, 2, weight_attr=ParamAttr(initializer=I.Constant(1.0),
                                                   learning_rate=lr_scale), device="cpu")
        from paddle_tpu_torch.optimizer import SGD
        opt = SGD(learning_rate=0.1, parameters=lin.parameters())
        lin(torch.ones(1, 3)).sum().backward()
        opt.step()
        steps.append(lin.weight.detach().clone())
    assert torch.equal(*steps)
    with pytest.raises(NotImplementedError, match="Faults in the reference"):
        L.Linear(3, 2, weight_attr=I.Normal(0.0, 1.0), device="cpu")


def test_reference_param_attr_behaves_alike():
    """The reference's ``ParamAttr`` takes the same fields and its layers
    the same precedence and ``trainable``, as the port's."""
    jattr = paddle.ParamAttr(name="w0", initializer=jnn.initializer.Constant(2.0),
                             trainable=False)
    jlin = jnn.Linear(3, 2, weight_attr=jattr)
    assert np.all(_np(jlin.weight) == 2.0) and jlin.weight.stop_gradient
    fields = ("name", "initializer", "learning_rate", "regularizer", "trainable",
              "do_model_average", "need_clip")
    assert all(hasattr(ParamAttr(), f) and hasattr(jattr, f) for f in fields)


def test_bilinear_and_rnn_weights_convert_by_name_in_their_layouts():
    """``Bilinear``'s ``[out, in1, in2]`` weight and an ``LSTM``'s
    ``[4 hidden, in]`` weights come across by name untransposed and give
    the reference's outputs."""
    paddle.seed(27)
    jb, tb = jnn.Bilinear(3, 4, 2), L.Bilinear(3, 4, 2, device="cpu")
    tb.load_state_dict(state_dict_by_name({k: _np(v) for k, v in jb.state_dict().items()}, tb))
    a, b = _x((5, 3), 28), _x((5, 4), 29)
    np.testing.assert_allclose(_np(tb(torch.from_numpy(a), torch.from_numpy(b))),
                               _np(jb(paddle.to_tensor(a), paddle.to_tensor(b))), **TOL)
    jl, tl = jnn.LSTM(3, 5), L.LSTM(3, 5, device="cpu")
    state = {k: _np(v) for k, v in jl.state_dict().items()}
    tl.load_state_dict(state_dict_by_name(state, tl))
    assert tuple(tl.weight_ih_l0_d0.shape) == state["weight_ih_l0_d0"].shape == (20, 3)
    x = _x((2, 4, 3), 30)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))[0]), _np(jl(paddle.to_tensor(x))[0]),
                               **TOL)
