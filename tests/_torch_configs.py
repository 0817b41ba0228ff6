"""The port's configs held against the JAX package's field by field.

The port's ``ModelConfig`` and ``MoEConfig`` carry options the JAX package
lacks (``repro_torch.core.config``: ``ModelConfig.rope_scaling``,
``MoEConfig.norm_topk_prob`` and ``MoEConfig.dropless``), each defaulting
to the JAX package's behaviour.  ``reference_fields`` compares every field
the JAX package has and requires each of the port's own at its default."""
import dataclasses


def reference_fields(port, reference):
    """``dataclasses.asdict(port)`` cut to the fields that ``reference``
    (the JAX package's config) has; asserts that each field it cuts holds
    its default.  Compare the result with ``dataclasses.asdict(reference)``."""
    if not (dataclasses.is_dataclass(port)
            and dataclasses.is_dataclass(reference)):
        return dataclasses.asdict(port) if dataclasses.is_dataclass(port) \
            else port
    names = {f.name for f in dataclasses.fields(reference)}
    out = {}
    for f in dataclasses.fields(port):
        value = getattr(port, f.name)
        if f.name in names:
            out[f.name] = reference_fields(value, getattr(reference, f.name))
        else:
            assert value == f.default, (type(port).__name__, f.name, value)
    return out
