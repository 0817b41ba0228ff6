"""Distribution layer, the port of the JAX package's ``repro.dist`` on
``torch.distributed``: manual SPMD over a ``DeviceMesh`` whose dimensions
carry the reference's axis names (``pod``, ``data``, ``model``, ``stage``).

Modules:
  context   — process-global mesh, bound axes + PerfFlags (the ablations)
  sharding  — logical-axis -> mesh-axis rule engine with divisibility guards
  tp        — tensor-parallel projection helper (closes a TP region)
  compress  — int8 block-quantized gradient all-reduce with error feedback
  pipeline  — GPipe-style pipeline parallelism over a 'stage' mesh axis

Expert parallelism is ``models.moe``'s; the restore onto another mesh is
``ckpt.load_checkpoint``'s; the meshes are ``launch.mesh``'s.
"""
from repro_torch.dist import context  # noqa: F401
