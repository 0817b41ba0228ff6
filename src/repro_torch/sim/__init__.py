"""The port's simulator: SMAUG's event engine priced at the H100's constants
or from the card's measured kernel table.

``hw`` holds the H100's constants and the SoC topology layer (``Device``,
``Link``, ``SoCTopology``, ``Fabric``); ``ir`` the ``CostedOp`` IR and its
graph and task lowerings; ``backends`` the compute-cost backends (roofline,
systolic, measured table) and the calibration fit; ``costmodel`` the
engine's per-op cost terms; ``engine`` the event-driven executor whose one
``run()`` returns timeline, breakdown, roofline and energy; ``report`` the
result types and aggregations.  numpy only: the port's own copy of the JAX
package's ``repro/sim`` core, held against it by ``tests/test_torch_sim.py``.

    from repro_torch.apps.paper_graphs import build_paper_graph
    from repro_torch.configs.paper_nets import PAPER_NETS
    from repro_torch.sim import EngineConfig, run

    g = build_paper_graph(PAPER_NETS["vgg16"], 1)
    res = run(g.program(1), EngineConfig())     # one H100, roofline
    res.makespan, res.breakdown.fractions()

The reference's sweep, serving and training simulators are not ported yet.
"""
from repro_torch.sim.backends import (CostBackend,  # noqa: F401
                                      RooflineBackend, SystolicBackend,
                                      TableBackend, get_backend)
from repro_torch.sim.costmodel import Unsupported  # noqa: F401
from repro_torch.sim.engine import (EngineConfig, EngineResult,  # noqa: F401
                                    Plan, chain_op_costs, prepare, run)
from repro_torch.sim.hw import (Device, Fabric, FabricTier,  # noqa: F401
                                Link, PARAM_FIELDS, SoCTopology,
                                apply_params, params_from_config,
                                resolve_tier_params, tco_per_step)
from repro_torch.sim.ir import (CostedOp, Program,  # noqa: F401
                                from_graph)
