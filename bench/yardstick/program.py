"""The system under test, ``repro_torch``, as the benchmark drives it: the
only module of the benchmark that imports it.  It takes from the program
the serving steps and the greedy pick, and nothing of its measurement."""
from __future__ import annotations

from dataclasses import fields


def model_config(spec):
    """The program's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.core.config import ModelConfig, SSMConfig
    m = dict(spec["model"])
    if m.get("ssm") is not None:
        m["ssm"] = SSMConfig(**m["ssm"])
    known = {f.name for f in fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in m.items() if k in known})


class Steps:
    """The serving steps of ``repro_torch.serve.step`` for one
    configuration, as ``repro_torch.launch.serve.serve`` runs them:
    ``prefill(params, tokens)`` -> (last-position logits (B, 1, V), cache),
    ``decode(params, cache, tokens, pos)`` -> (next tokens (B, 1), cache,
    logits) and ``greedy(logits)`` -> (B, 1) tokens."""

    def __init__(self, spec):
        from repro_torch.serve import step
        self.cfg = model_config(spec)
        self._step = step
        self._prefill = {}
        self.decode = step.make_decode_step(self.cfg)
        self.greedy = step.greedy

    def prefill(self, params, tokens, max_seq):
        fn = self._prefill.get(max_seq)
        if fn is None:
            fn = self._prefill[max_seq] = self._step.make_prefill_step(
                self.cfg, max_seq)
        return fn(params, self._step.prefill_inputs(self.cfg, tokens))


def init_params_shapes(spec):
    """{path: (shape, dtype)} of ``T.init_params`` for the configuration,
    made on fake tensors (no memory): what the benchmark's param maker has
    to match."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import tree
    from repro_torch.models import transformer as T
    with FakeTensorMode():
        p = T.init_params(model_config(spec), 0, "cpu")
        return {k: (tuple(v.shape), v.dtype)
                for k, v in tree.flatten(p).items()}
