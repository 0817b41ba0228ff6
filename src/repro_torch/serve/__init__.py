"""Serving layer: the prefill/decode steps on the card
(``repro_torch.serve.step``) and the batching policies
(``repro_torch.serve.policy``) shared with the simulated serving scenario in
``repro_torch.sim.serving``.

The step factories are re-exported lazily: ``repro_torch.serve.step``
imports torch and the model stack, while the policy dataclasses are
dependency-free — the simulator must be able to import them without paying
for torch.
"""
from repro_torch.serve.policy import (BatchingPolicy,  # noqa: F401
                                      ContinuousBatching, DynamicBatching,
                                      StaticBatching, get_policy)

_STEP_EXPORTS = ("make_decode_step", "make_prefill_step")


def __getattr__(name):
    if name in _STEP_EXPORTS:
        from repro_torch.serve import step
        return getattr(step, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
