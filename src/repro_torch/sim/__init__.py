"""The port's simulator: SMAUG's event engine priced at the H100's constants
or from the card's measured kernel table, and its design-space layer.

``hw`` holds the H100's constants and the SoC topology layer (``Device``,
``Link``, ``SoCTopology``, ``Fabric``); ``ir`` the ``CostedOp`` IR and its
graph, decode and task lowerings; ``backends`` the compute-cost backends
(roofline, systolic, measured table) and the calibration fit;
``costmodel`` the engine's per-op cost terms and the analytic
``CostModel`` (numpy, or float64 torch with ``torch.func`` gradients);
``engine`` the event-driven executor whose one ``run()`` returns timeline,
breakdown, roofline and energy; ``sweep`` the design-space layer
(``sweep``, ``batched``, ``optimize``, ``topology_sweep``,
``fleet_sweep``); ``serving`` the trace-driven serving co-simulation
(request traces, batching policies from ``repro_torch.serve.policy``, the
memoized replay and the replica fleet); ``report`` the result types and
aggregations.  numpy at import (torch loads only for the cost model's torch
backend): the port's own copy of the JAX package's ``repro/sim``, held
against it by ``tests/test_torch_sim.py``, ``tests/test_torch_sweep.py``,
``tests/test_torch_serving.py`` and ``tests/test_torch_fleet.py``.

    from repro_torch.apps.paper_graphs import build_paper_graph
    from repro_torch.configs.paper_nets import PAPER_NETS
    from repro_torch.sim import EngineConfig, run

    g = build_paper_graph(PAPER_NETS["vgg16"], 1)
    res = run(g.program(1), EngineConfig())     # one H100, roofline
    res.makespan, res.breakdown.fractions()

Still to copy from the reference: the training and cluster simulators
(``training.py``, ``from_training_step``, ``from_collective``,
``training_sweep``, ``cluster_sweep``) and the HLO lowering (``from_hlo``,
``lower_hlo``).
"""
from repro_torch.sim.backends import (CostBackend,  # noqa: F401
                                      RooflineBackend, SystolicBackend,
                                      TableBackend, get_backend)
from repro_torch.sim.costmodel import CostModel, Unsupported  # noqa: F401
from repro_torch.sim.engine import (EngineConfig, EngineResult,  # noqa: F401
                                    Plan, chain_op_costs, prepare, run)
from repro_torch.sim.hw import (Device, Fabric, FabricTier,  # noqa: F401
                                Link, PARAM_FIELDS, SoCTopology,
                                apply_params, params_from_config,
                                resolve_tier_params, tco_per_step)
from repro_torch.sim.ir import (CostedOp, Program,  # noqa: F401
                                from_decode, from_graph, from_serving_step)
from repro_torch.sim.serving import (Request, ServingResult,  # noqa: F401
                                     as_serving_records, bursty_trace,
                                     load_trace, poisson_trace, save_trace,
                                     serving_sweep, simulate_serving,
                                     trace_from_records)
from repro_torch.sim.sweep import (batched, fleet_sweep,  # noqa: F401
                                   optimize, sweep, topology_sweep)
