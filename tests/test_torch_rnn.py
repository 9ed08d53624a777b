"""The port's recurrent layers and beam search against ``paddle_tpu``'s, on
the CPU.

The cells, ``SimpleRNN``/``LSTM``/``GRU`` (2 layers, one and two
directions, batch- and time-major), ``RNN``, ``BiRNN`` and
``RNNCellBase.get_initial_states`` get the reference's weights by name
(``utils.convert.state_dict_by_name``: the ``[gates * hidden, in]``
layout, not transposed) and the same numpy inputs. Forwards and the
gradients of ``sum(out * cotangent)`` (an exact cotangent) with respect to
every parameter and the input agree to atol 1e-5 / rtol 1e-4 (f32 sums of
``hidden`` terms in another order, carried through the time steps).
``dynamic_decode``'s tokens are bitwise the reference's, its scores within
1e-6, also on a case built so every candidate ties. The arguments the
reference accepts and never reads raise and cite ROADMAP.md's "Faults in
the reference".
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn as jnn  # noqa: E402
from paddle_tpu.nn.layer import extension as jext  # noqa: E402

from paddle_tpu_torch.nn import layer as L  # noqa: E402
from paddle_tpu_torch.nn.layer import rnn as trnn  # noqa: E402
from paddle_tpu_torch.utils.convert import state_dict_by_name  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
B, T, IN, HID = 3, 5, 6, 8


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t.numpy())


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _copy(jm, pm):
    pm.load_state_dict(state_dict_by_name({k: _np(v) for k, v in jm.state_dict().items()}, pm))


def _parity(jm, pm, inputs, **kw):
    """Forward both on the numpy ``inputs`` (a list; the first gets a
    gradient), then ``sum(leaf * cotangent)`` over every output leaf
    backward: the outputs, the input's and every parameter's gradients."""
    _copy(jm, pm)
    jx = [paddle.to_tensor(a) for a in inputs]
    tx = [torch.from_numpy(a) for a in inputs]
    jx[0].stop_gradient = False
    tx[0].requires_grad_(True)
    jo, to = _leaves(jm(*jx, **kw)), _leaves(pm(*tx, **kw))
    assert len(jo) == len(to)
    cots = [_x(tuple(t.shape), 100 + i) for i, t in enumerate(to)]
    for j, t in zip(jo, to):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)
    sum((j * paddle.to_tensor(c)).sum() for j, c in zip(jo, cots)).backward()
    sum((t * torch.from_numpy(c)).sum() for t, c in zip(to, cots)).backward()
    np.testing.assert_allclose(_np(tx[0].grad), _np(jx[0].grad), **TOL)
    jgrads = {n: _np(p.grad) for n, p in jm.named_parameters()}
    assert set(jgrads) == {n for n, _ in pm.named_parameters()}
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), jgrads[n], err_msg=n, **TOL)


CELLS = {
    "simple_tanh": (lambda: jnn.SimpleRNNCell(IN, HID), lambda: L.SimpleRNNCell(IN, HID, device="cpu"), 1),
    "simple_relu": (lambda: jnn.SimpleRNNCell(IN, HID, activation="relu"),
                    lambda: L.SimpleRNNCell(IN, HID, activation="relu", device="cpu"), 1),
    "lstm": (lambda: jnn.LSTMCell(IN, HID), lambda: L.LSTMCell(IN, HID, device="cpu"), 2),
    "gru": (lambda: jnn.GRUCell(IN, HID), lambda: L.GRUCell(IN, HID, device="cpu"), 1),
}


@pytest.mark.parametrize("case", sorted(CELLS))
def test_cells_match_reference(case):
    """One step from given states (and from zeros): outputs and gradients,
    the ``[gates * hidden, in]`` weights carried across by name."""
    make_j, make_t, n_states = CELLS[case]
    paddle.seed(2)
    jm, pm = make_j(), make_t()
    assert tuple(pm.weight_ih.shape) == tuple(jm.weight_ih.shape)
    states = [_x((B, HID), 3 + i) for i in range(n_states)]

    class WithStates(torch.nn.Module):
        def __init__(self, cell, wrap):
            super().__init__()
            self.cell, self.wrap = cell, wrap

        def forward(self, x, *st):
            return self.cell(x, self.wrap(st))

    class JWithStates(jnn.Layer):
        def __init__(self, cell, wrap):
            super().__init__()
            self.cell, self.wrap = cell, wrap

        def forward(self, x, *st):
            return self.cell(x, self.wrap(st))

    wrap = (lambda st: tuple(st)) if n_states == 2 else (lambda st: st[0])
    _parity(JWithStates(jm, wrap), WithStates(pm, wrap), [_x((B, IN), 1)] + states)
    jo = _leaves(jm(paddle.to_tensor(_x((B, IN), 1))))
    to = _leaves(pm(torch.from_numpy(_x((B, IN), 1))))
    for j, t in zip(jo, to):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)


@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
@pytest.mark.parametrize("direction,time_major", [("forward", False), ("bidirect", True)],
                         ids=["forward", "bidirect_time_major"])
def test_stacks_match_reference(mode, direction, time_major):
    """Two layers: the outputs, the final states ``[layers * directions, b,
    hidden]`` and every gradient; the parameters carry across by name."""
    paddle.seed(4)
    jm = getattr(jnn, mode)(IN, HID, num_layers=2, direction=direction, time_major=time_major)
    pm = getattr(L, mode)(IN, HID, num_layers=2, direction=direction, time_major=time_major,
                          device="cpu")
    assert list(pm.state_dict()) == list(jm.state_dict())
    x = _x((T, B, IN) if time_major else (B, T, IN), 5)
    _parity(jm, pm, [x])


def test_rnn_birnn_and_initial_states_match_reference():
    """``RNN`` over an ``LSTMCell`` forward and reversed (time-major too),
    ``BiRNN`` over two ``GRUCell``s with given initial states, and
    ``get_initial_states`` (flat and nested shapes, the batch read off a
    chosen dim)."""
    paddle.seed(6)
    jcell, pcell = jnn.LSTMCell(IN, HID), L.LSTMCell(IN, HID, device="cpu")
    for reverse, tm in ((False, False), (True, True)):
        x = _x((T, B, IN) if tm else (B, T, IN), 7)
        _parity(jnn.RNN(jcell, is_reverse=reverse, time_major=tm),
                L.RNN(pcell, is_reverse=reverse, time_major=tm), [x])
    paddle.seed(8)
    jfw, jbw = jnn.GRUCell(IN, HID), jnn.GRUCell(IN, HID)
    pfw, pbw = L.GRUCell(IN, HID, device="cpu"), L.GRUCell(IN, HID, device="cpu")
    jb, pb = jnn.BiRNN(jfw, jbw), L.BiRNN(pfw, pbw)

    class Bi(torch.nn.Module):
        def __init__(self, bi):
            super().__init__()
            self.bi = bi

        def forward(self, x, h0, h1):
            return self.bi(x, (h0, h1))

    class JBi(jnn.Layer):
        def __init__(self, bi):
            super().__init__()
            self.bi = bi

        def forward(self, x, h0, h1):
            return self.bi(x, (h0, h1))

    _parity(JBi(jb), Bi(pb), [_x((B, T, IN), 9), _x((B, HID), 10), _x((B, HID), 11)])

    class JCell(jext.RNNCellBase):
        state_shape = (HID,)

    class PCell(L.RNNCellBase):
        state_shape = (HID,)

    ref = _x((T, B, IN), 12)
    for kw in (dict(), dict(shape=[(2,), (3, 4)], init_value=1.5), dict(batch_dim_idx=1)):
        want = _leaves(JCell().get_initial_states(paddle.to_tensor(ref), **kw))
        got = _leaves(PCell().get_initial_states(torch.from_numpy(ref), **kw))
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(_np(g), _np(w))


class _Decoder:
    """An ``LSTMCell`` decoder with an embedding and a projection, on both
    sides with the same weights."""

    def __init__(self, vocab=11, emb=6, hid=HID, tie=False):
        paddle.seed(13)
        self.j = dict(cell=jnn.LSTMCell(emb, hid), emb=jnn.Embedding(vocab, emb),
                      out=jnn.Linear(hid, vocab))
        self.t = dict(cell=L.LSTMCell(emb, hid, device="cpu"),
                      emb=L.Embedding(vocab, emb, device="cpu"),
                      out=L.Linear(hid, vocab, device="cpu"))
        for k in self.j:
            _copy(self.j[k], self.t[k])
        if tie:  # every token the same logit: every candidate ties
            for side, zero in ((self.j, lambda p: p.set_value(np.zeros(p.shape, np.float32))),
                               (self.t, lambda p: torch.nn.init.zeros_(p))):
                zero(side["out"].weight)
                zero(side["out"].bias)


@pytest.mark.parametrize("tie", [False, True], ids=["ranked", "tied"])
def test_dynamic_decode_tokens_bitwise(tie):
    """Beam 3 over 2 rows for at most 7 tokens from given LSTM states: the
    ids (padded with the end token) bitwise, the beams' scores within
    1e-6. With every logit equal the order is the reference's tie order
    (lower beam, then the token ``argsort`` put first)."""
    d = _Decoder(tie=tie)
    h, c = _x((2, HID), 14), _x((2, HID), 15)
    jdec = jext.BeamSearchDecoder(d.j["cell"], 1, 2, 3, embedding_fn=d.j["emb"],
                                  output_fn=d.j["out"])
    tdec = L.BeamSearchDecoder(d.t["cell"], 1, 2, 3, embedding_fn=d.t["emb"],
                               output_fn=d.t["out"])
    jids, jsc = jext.dynamic_decode(jdec, (paddle.to_tensor(h), paddle.to_tensor(c)),
                                    max_step_num=7)
    tids, tsc = L.dynamic_decode(tdec, (torch.from_numpy(h), torch.from_numpy(c)),
                                 max_step_num=7)
    np.testing.assert_array_equal(_np(tids), _np(jids))
    assert tids.dtype == torch.int64 and tids.shape[:2] == (2, 3)
    np.testing.assert_allclose(_np(tsc), _np(jsc), atol=1e-6, rtol=0)
    if not tie:
        assert len(set(map(tuple, _np(tids).reshape(6, -1)))) > 1


def test_ignored_arguments_raise_and_cite_the_fault():
    """What the reference accepts and never reads raises here, citing
    ROADMAP.md's "Faults in the reference": the stacks' ``dropout``,
    ``initial_states``, ``sequence_length`` and their other keywords,
    ``RNN``'s ``sequence_length``, and a cell's ``*_attr=False``."""
    lstm = L.LSTM(IN, HID, device="cpu")
    x = torch.zeros(B, T, IN)
    calls = [lambda: L.LSTM(IN, HID, dropout=0.5, device="cpu"),
             lambda: L.SimpleRNN(IN, HID, activation="relu", device="cpu"),
             lambda: L.GRU(IN, HID, weight_ih_attr=object(), device="cpu"),
             lambda: lstm(x, initial_states=(torch.zeros(1, B, HID), torch.zeros(1, B, HID))),
             lambda: lstm(x, sequence_length=torch.full((B,), T)),
             lambda: L.RNN(L.GRUCell(IN, HID, device="cpu"))(x, sequence_length=torch.full((B,), T)),
             lambda: L.LSTMCell(IN, HID, bias_ih_attr=False, device="cpu")]
    for call in calls:
        with pytest.raises(NotImplementedError, match="Faults in the reference"):
            call()
    assert trnn.FAULT.startswith("the reference accepts")
    # the reference's default activation is accepted: it is what runs
    assert L.SimpleRNN(IN, HID, activation="tanh", device="cpu")(x)[0].shape == (B, T, HID)
