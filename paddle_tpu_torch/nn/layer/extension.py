"""The layer tail of the port (``paddle_tpu/nn/layer/extension.py``): the
pixel and channel shuffles, ``Fold``, ``MaxUnPool1D/2D/3D``,
``Softmax2D``, ``ThresholdedReLU``, ``PairwiseDistance``, ``CTCLoss``,
``HSigmoidLoss``, ``RNNCellBase``, ``BiRNN``, and beam search
(``BeamSearchDecoder`` and ``dynamic_decode``).

Beam search runs the reference's host-driven loop: the cell, embedding
and projection run on the tensors' device, and each step's candidates are
ranked on the host exactly as the reference ranks them, so the tokens are
the reference's for the same scores: a beam's top ``beam_size`` tokens
from ``numpy.argsort`` (ascending), then the candidates of all beams in
that order (beam by beam) sorted stably by score, so ties go to the lower
beam, then to the token ``argsort`` put first; a finished beam carries on
as one candidate with its score and adds no token; the ids are padded
with ``end_token``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...framework.device import resolve_device
from .. import functional as F
from .. import initializer as I
from ._attr import param, wants
from .rnn import RNN

__all__ = ["PixelShuffle", "PixelUnshuffle", "ChannelShuffle", "Fold", "MaxUnPool1D",
           "MaxUnPool2D", "MaxUnPool3D", "Softmax2D", "ThresholdedReLU", "PairwiseDistance",
           "CTCLoss", "HSigmoidLoss", "RNNCellBase", "BiRNN", "BeamSearchDecoder",
           "dynamic_decode"]


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r, self.df = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.r, self.df)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.r, self.df = downscale_factor, data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.r, self.df)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.g, self.df = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.g, self.df)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.a = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, *self.a)


class _MaxUnPoolBase(nn.Module):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None, output_size=None,
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.output_size = output_size

    def forward(self, x, indices):
        return getattr(F, self._fn)(x, indices, self.kernel_size, self.stride, self.padding,
                                    output_size=self.output_size)


class MaxUnPool1D(_MaxUnPoolBase):
    _fn = "max_unpool1d"


class MaxUnPool2D(_MaxUnPoolBase):
    _fn = "max_unpool2d"


class MaxUnPool3D(_MaxUnPoolBase):
    _fn = "max_unpool3d"


class Softmax2D(nn.Module):
    """Softmax over the channels (dim -3) of NCHW input."""

    def forward(self, x):
        return F.softmax(x, axis=-3)


class ThresholdedReLU(nn.Module):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


class PairwiseDistance(nn.Module):
    """``(sum |x - y + epsilon|^p)^(1/p)`` over the last dim."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.eps, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return (torch.abs(x - y + self.eps) ** self.p).sum(dim=-1, keepdim=self.keepdim) ** (
            1.0 / self.p)


class CTCLoss(nn.Module):
    """:func:`~paddle_tpu_torch.nn.functional.ctc_loss` (logits in,
    impossible paths floored at -1e30). ``norm_by_times`` is not read, as
    in the reference."""

    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, logits, labels, input_lengths, label_lengths, norm_by_times=False):
        return F.ctc_loss(logits, labels, input_lengths, label_lengths, self.blank,
                          self.reduction)


class HSigmoidLoss(nn.Module):
    """The hierarchical sigmoid over the default tree: ``weight``
    ``[num_classes - 1, feature_size]`` (XavierNormal, the reference's
    default) and ``bias`` ``[num_classes - 1, 1]`` (zeros; none with
    ``bias_attr=False``). Custom trees raise, as in the reference."""

    def __init__(self, feature_size, num_classes, weight_attr=None, bias_attr=None,
                 is_custom=False, is_sparse=False, name=None, *, device=None, generator=None):
        super().__init__()
        if is_custom:
            raise NotImplementedError("custom trees not supported; default tree only")
        device = resolve_device(device)
        self.num_classes = num_classes
        self.weight = param((num_classes - 1, feature_size), weight_attr, I.XavierNormal(),
                            generator, device, layer="HSigmoidLoss")
        self.bias = (param((num_classes - 1, 1), bias_attr, I.Constant(0.0), generator, device,
                           is_bias=True, layer="HSigmoidLoss", what="bias")
                     if wants(bias_attr, "HSigmoidLoss", "bias") else None)

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self.num_classes, self.weight, self.bias)


class RNNCellBase(nn.Module):
    """A base for user cells: :meth:`get_initial_states`."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None, init_value=0.0,
                           batch_dim_idx=0):
        """f32 states filled with ``init_value``: ``[batch] + shape`` (or a
        tuple of them for a nested ``shape``), ``batch`` read off
        ``batch_ref``'s dim ``batch_dim_idx``; ``shape`` None takes the
        cell's ``state_shape``. ``dtype`` is not read, as in the reference."""
        batch = batch_ref.shape[batch_dim_idx]
        hidden = shape if shape is not None else getattr(self, "state_shape", None)

        def build(shp):
            return torch.full((batch,) + tuple(int(d) for d in shp), init_value,
                              dtype=torch.float32, device=batch_ref.device)

        if isinstance(hidden, (list, tuple)) and hidden and isinstance(hidden[0], (list, tuple)):
            return tuple(build(s) for s in hidden)
        return build(tuple(hidden))


class BiRNN(nn.Module):
    """``cell_fw`` forward and ``cell_bw`` reversed over the sequence, the
    outputs concatenated on the feature dim; returns ``(outputs, (fw
    states, bw states))``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        st_fw, st_bw = initial_states if initial_states is not None else (None, None)
        out_fw, s_fw = self.fw(inputs, st_fw, sequence_length)
        out_bw, s_bw = self.bw(inputs, st_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (s_fw, s_bw)


class BeamSearchDecoder:
    """Beam search over ``cell``: each step embeds the last tokens
    (``embedding_fn``), runs the cell, and projects its output to the
    vocabulary (``output_fn``); :func:`dynamic_decode` runs it."""

    def __init__(self, cell, start_token, end_token, beam_size, embedding_fn=None,
                 output_fn=None):
        self.cell = cell
        self.start, self.end, self.beam = int(start_token), int(end_token), int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def _map_state(state, fn):
    return tuple(fn(s) for s in state) if isinstance(state, (list, tuple)) else fn(state)


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """The beam-search loop over ``decoder`` from the cell states ``inits``
    (``[batch, ...]`` each) for at most ``max_step_num`` tokens, stopping
    when every beam has ended: returns ``(ids [batch, beam, T] int64, the
    beams' scores [batch, beam] f32)``, on the states' device. The first
    step expands each row into its ``beam`` best first tokens (ties to the
    lower token); later steps rank as the module's docstring says."""
    cell, K = decoder.cell, decoder.beam
    state = inits
    leaf = state[0] if isinstance(state, (list, tuple)) else state
    B, device = leaf.shape[0], leaf.device

    def log_probs(tok, st):
        x = decoder.embedding_fn(tok) if decoder.embedding_fn is not None else tok
        out, new_st = cell(x, st)
        if decoder.output_fn is not None:
            out = decoder.output_fn(out)
        return torch.log_softmax(out.float(), dim=-1).detach().cpu().numpy(), new_st

    with torch.no_grad():
        lp0, state = log_probs(torch.full((B,), decoder.start, dtype=torch.int64, device=device),
                               state)
        top = np.argsort(-lp0, axis=-1, kind="stable")[:, :K]  # lax.top_k: ties to the lower id
        beam_scores = np.take_along_axis(lp0, top, axis=-1)
        seqs = [[[int(top[b, k])] for k in range(K)] for b in range(B)]
        state = _map_state(state, lambda t: torch.repeat_interleave(t, K, dim=0))
        finished = np.zeros((B, K), bool)
        for _ in range(max_step_num - 1):
            if finished.all():
                break
            last = torch.tensor([seqs[b][k][-1] for b in range(B) for k in range(K)],
                                dtype=torch.int64, device=device)
            lp, state = log_probs(last, state)
            lp = lp.reshape(B, K, lp.shape[-1])
            new_seqs, new_scores, sel = [], [], []
            for b in range(B):
                cand = []
                for k in range(K):
                    if finished[b, k]:
                        cand.append((beam_scores[b, k], k, decoder.end))
                        continue
                    for t in np.argsort(lp[b, k])[-K:]:
                        cand.append((beam_scores[b, k] + lp[b, k, t], k, int(t)))
                cand.sort(key=lambda c: -c[0])
                picked = cand[:K]
                new_seqs.append([seqs[b][k] + ([t] if not finished[b, k] else [])
                                 for _, k, t in picked])
                new_scores.append([s for s, _, _ in picked])
                sel.append([k for _, k, _ in picked])
            idx = torch.tensor([b * K + k for b in range(B) for k in sel[b]], device=device)
            state = _map_state(state, lambda t: t.index_select(0, idx))
            seqs, beam_scores = new_seqs, np.asarray(new_scores)
            for b in range(B):
                for k in range(K):
                    if seqs[b][k] and seqs[b][k][-1] == decoder.end:
                        finished[b, k] = True
    T = max(len(s) for bs in seqs for s in bs)
    ids = np.full((B, K, T), decoder.end, np.int64)
    for b in range(B):
        for k in range(K):
            ids[b, k, :len(seqs[b][k])] = seqs[b][k]
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(np.asarray(beam_scores, np.float32)).to(device))
