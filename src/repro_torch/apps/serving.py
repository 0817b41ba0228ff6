"""Serving scenario app: one call from an architecture id to a simulated
served workload.

The apps layer composes scenario pieces the way ``apps.camera`` composes
the ISP with a DNN program: here the pieces are a ``ModelConfig`` from the
registry, a synthetic trace generator, a batching policy, and the serving
co-simulation — ``python -m repro_torch.launch.serve_batch --simulate`` and
ad-hoc design-space scripts call this instead of wiring the four by hand.

Where the caller passes no ``config``, both entry points price on
``default_config()``: one H100 at its dense bf16 tensor-core peak
(``hw.PEAK_FLOPS_BF16``, 989e12), because the served models run in bf16
(``bytes_per_param=2.0``).  It is the H100 counterpart of the reference's
default, the TPU v5e's bf16 peak.  The engine's own ``EngineConfig()``
(which ``simulate_serving(config=None)`` keeps) prices at the float32 rate
of the CUDA cores, 67e12, about 15x below what a bf16 model is served at.

The port's copy of ``repro/apps/serving.py``; numpy only, no torch.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.serve.policy import (BatchingPolicy, QueueDepthAutoscaler,
                                      RouterPolicy, get_policy)
from repro_torch.sim import hw
from repro_torch.sim.engine import EngineConfig
from repro_torch.sim.serving import (TRACE_GENERATORS, FleetResult,
                                     ServingResult, simulate_fleet,
                                     simulate_serving)


def default_config() -> EngineConfig:
    """One H100 at its dense bf16 peak: what ``serve_trace`` and
    ``serve_fleet`` price on when the caller passes no ``config``."""
    return EngineConfig(peak_flops=hw.PEAK_FLOPS_BF16)


def serve_trace(arch: str = "gemma_2b",
                policy: Union[str, BatchingPolicy] = "continuous", *,
                rate_rps: float = 50.0, n_requests: int = 64,
                max_batch: int = 8, trace_kind: str = "poisson",
                seed: int = 0, smoke: bool = False,
                config: Optional[EngineConfig] = None,
                prompt_len=(16, 128), output_len=(8, 64)) -> ServingResult:
    """Simulate serving ``arch`` under a policy and a synthetic trace.

    ``policy`` is a name (``static`` | ``dynamic`` | ``continuous``) or a
    ready ``BatchingPolicy``; ``smoke`` selects the reduced registry config
    (useful when the full model's weights would dwarf the trace);
    ``config`` defaults to ``default_config()`` (one H100, bf16 peak).
    Returns the full ``ServingResult``; ``result.stats()`` has the TTFT/
    TPOT/throughput summary.
    """
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if isinstance(policy, str):
        policy = get_policy(policy, max_batch=max_batch)
    gen = TRACE_GENERATORS[trace_kind]
    trace = gen(n_requests, rate_rps, prompt_len=prompt_len,
                output_len=output_len, seed=seed)
    return simulate_serving(cfg, trace, policy,
                            config or default_config(), name=f"{arch}/serve")


def serve_fleet(arch: str = "gemma_2b",
                policy: Union[str, BatchingPolicy] = "continuous", *,
                n_replicas: int = 2,
                router: Union[str, RouterPolicy] = "round_robin",
                autoscaler: Optional[QueueDepthAutoscaler] = None,
                rate_rps: float = 200.0, n_requests: int = 2000,
                max_batch: int = 8, trace_kind: str = "diurnal",
                seed: int = 0, smoke: bool = False,
                config: Optional[EngineConfig] = None,
                prompt_len=(16, 128), output_len=(8, 64)) -> FleetResult:
    """Simulate an N-replica serving fleet of ``arch`` under a router
    (``round_robin`` | ``least_outstanding`` | ``session_affinity``), an
    optional ``QueueDepthAutoscaler``, and a synthetic trace
    (``diurnal`` by default — the daily load wave autoscalers exist
    for); ``config`` defaults to ``default_config()``.  The memoized
    replay path handles million-request traces; ``result.stats()`` has the
    SLO-attainment / cost-per-token roll-up.
    """
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if isinstance(policy, str):
        policy = get_policy(policy, max_batch=max_batch)
    gen = TRACE_GENERATORS[trace_kind]
    kw = {"arrays": True} if trace_kind == "diurnal" else {}
    trace = gen(n_requests, rate_rps, prompt_len=prompt_len,
                output_len=output_len, seed=seed, **kw)
    res = simulate_fleet(cfg, trace, policy, config or default_config(),
                         n_replicas=n_replicas, router=router,
                         autoscaler=autoscaler, name=f"{arch}/fleet")
    res.meta.update({"rate_rps": rate_rps, "trace_kind": trace_kind,
                     "seed": seed})
    return res
