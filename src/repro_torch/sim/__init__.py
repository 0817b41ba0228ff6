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
``fleet_sweep``, ``training_sweep``, ``cluster_sweep``); ``serving`` the
trace-driven serving co-simulation (request traces, batching policies from
``repro_torch.serve.policy``, the memoized replay and the replica fleet);
``training`` the pipeline-parallel training co-simulation (GPipe / 1F1B
over an ``SoCTopology``, DP x TP x PP over a ``Fabric``, with the
collectives of ``ir.from_collective`` as per-hop transfers); ``report``
the result types and aggregations.  numpy at import (torch loads only for
the cost model's torch backend): the port's own copy of the JAX package's
``repro/sim``, held against it by ``tests/test_torch_sim.py``,
``tests/test_torch_sweep.py``, ``tests/test_torch_serving.py``,
``tests/test_torch_fleet.py``, ``tests/test_torch_training.py`` and
``tests/test_torch_cluster.py``.

    from repro_torch.apps.paper_graphs import build_paper_graph
    from repro_torch.configs.paper_nets import PAPER_NETS
    from repro_torch.sim import EngineConfig, run

    g = build_paper_graph(PAPER_NETS["vgg16"], 1)
    res = run(g.program(1), EngineConfig())     # one H100, roofline
    res.makespan, res.breakdown.fractions()

A training step priced on one H100 at its bf16 peak (what
``python -m repro_torch.launch.train --dry-run`` prints):

    from repro_torch.apps.serving import default_config
    from repro_torch.configs import get_config
    from repro_torch.sim import simulate_training

    r = simulate_training(get_config("tinyllama_1_1b"), n_microbatches=2,
                          seq_len=4096, global_batch=8,
                          config=default_config())
    r.step_time_s, r.tokens_per_s

Still to copy from the reference: the HLO lowering (``from_hlo``,
``lower_hlo``).
"""
from repro_torch.sim.backends import (CostBackend,  # noqa: F401
                                      RooflineBackend, SystolicBackend,
                                      TableBackend, get_backend)
from repro_torch.sim.costmodel import (CostModel,  # noqa: F401
                                      Unsupported, relaxation_err)
from repro_torch.sim.engine import (EngineConfig, EngineResult,  # noqa: F401
                                    Plan, chain_op_costs, prepare, run)
from repro_torch.sim.hw import (Device, Fabric, FabricTier,  # noqa: F401
                                Link, PARAM_FIELDS, SoCTopology,
                                apply_params, params_from_config,
                                resolve_tier_params, tco_per_step)
from repro_torch.sim.ir import (CostedOp, Program,  # noqa: F401
                                collective_time, from_collective,
                                from_decode, from_graph, from_serving_step,
                                from_training_step, partition_stages)
from repro_torch.sim.serving import (Request, ServingResult,  # noqa: F401
                                     as_serving_records, bursty_trace,
                                     load_trace, poisson_trace, save_trace,
                                     serving_sweep, simulate_serving,
                                     trace_from_records)
from repro_torch.sim.sweep import (BatchedSweep,  # noqa: F401
                                   OptimizeResult, as_cluster_records,
                                   as_records, as_training_records,
                                   batched, cluster_sweep, fleet_sweep,
                                   lower_graph, optimize, placements_for,
                                   sweep, topology_sweep, training_sweep)
from repro_torch.sim.training import (TrainingResult,  # noqa: F401
                                      bubble_bound, schedule_order,
                                      simulate_training)
