"""What every model of the port's zoo shares: its weights drawn from a
generator seeded ``seed`` on ``device`` (None: the card), and
``pretrained=True`` refused (the port downloads nothing)."""
from __future__ import annotations

import torch

from ...framework.device import resolve_device


def made(device=None, seed=0, generator=None):
    """``dict(device=..., generator=...)`` for the layers of one model."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(int(seed))
    return dict(device=device, generator=generator)


def refuse_pretrained(pretrained):
    """The reference drops ``pretrained=True`` without a word (ROADMAP.md,
    "Faults in the reference"); the port raises."""
    if pretrained:
        raise NotImplementedError("pretrained weights are not available: the port downloads "
                                  "nothing; load a state with utils.convert instead")
