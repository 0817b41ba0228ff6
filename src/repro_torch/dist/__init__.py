"""Distribution layer.  On one device only the process-global perf flags
are ported (``context``); the mesh, the sharding rules, tensor and
pipeline parallelism and gradient compression are not."""
from repro_torch.dist import context  # noqa: F401
