"""Batched serving example — measured and modeled in one script.

The port's counterpart of ``examples/serve_batch.py``, with its flags and
its printed lines; the work is ``repro_torch.launch.serve_batch``'s, whose
``main``, ``run_measured`` and ``run_simulated`` it names.  The
default mode prefills a batch of prompts on the card (``--device cpu`` for
the CPU), then greedy-decodes with a shared KV cache.  ``--simulate``
replays a synthetic request trace against the same batching policy through
the serving simulator (``repro_torch.sim.serving``), priced on one H100 at
its bf16 peak.

  PYTHONPATH=src python examples_torch/serve_batch.py --arch gemma3_1b \\
      --tokens 16
  PYTHONPATH=src python examples_torch/serve_batch.py --simulate \\
      --policy continuous --rate 50 --requests 64
"""
from repro_torch.launch.serve_batch import (main, run_measured,  # noqa: F401
                                            run_simulated)

if __name__ == "__main__":
    main()
