"""The parameter attributes the port's layers take: None (the defaults),
False (no such parameter; biases and norm affines) or a
:class:`~paddle_tpu_torch.framework.param_attr.ParamAttr` (or any object
with its fields). The reference also takes an initialiser object or any
other value there and ignores it (its ``create_parameter`` reads
``attr.initializer``, which an initialiser lacks); the port raises for
those instead (ROADMAP.md, "Faults in the reference")."""
from torch import nn

from .. import initializer as I


def wants(attr, layer, what):
    """Whether a layer makes its ``what`` parameter: False means none; None
    or a parameter attribute, one. Anything else raises."""
    if attr is None:
        return True
    if attr is False:
        return False
    if hasattr(attr, "initializer"):
        return True
    raise NotImplementedError(
        f"{layer}: {what}_attr={attr!r} is not a ParamAttr: the reference ignores such an "
        f"attribute (ROADMAP.md, 'Faults in the reference'); pass None, False or "
        f"ParamAttr(initializer=...)")


def value(shape, attr, default, generator, device, is_bias=False, layer="", what="weight"):
    """A parameter's initial value as the reference's ``create_parameter``
    makes it: from ``attr``'s initializer, else the global one, else
    ``default``."""
    wants(attr, layer, what)
    return I.make(shape, attr, default, generator, device, is_bias=is_bias)


def finish(p, attr):
    """``p`` with ``attr.name`` as its ``param_name`` (a tensor's ``name`` is
    torch's own and cannot be set) and ``attr.trainable=False`` as
    ``requires_grad=False``."""
    if attr is not None:
        if getattr(attr, "name", None):
            p.param_name = attr.name
        if getattr(attr, "trainable", True) is False:
            p.requires_grad_(False)
    return p


def param(shape, attr, default, generator, device, is_bias=False, layer="", what="weight"):
    """The ``nn.Parameter`` a layer makes as the reference's
    ``create_parameter`` does (:func:`value`, then :func:`finish`)."""
    return finish(nn.Parameter(value(shape, attr, default, generator, device, is_bias, layer,
                                     what)), attr)
