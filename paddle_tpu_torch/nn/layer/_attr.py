"""The parameter attributes the port's layers take."""


def wants(attr, layer, what):
    """Whether a layer makes its ``what`` parameter: ``attr`` False means
    none; None the default initialiser. A ``ParamAttr`` is not ported yet
    and raises."""
    if attr is None:
        return True
    if attr is False:
        return False
    raise NotImplementedError(f"{layer}: {what}_attr={attr!r} is not ported, only None or False")
