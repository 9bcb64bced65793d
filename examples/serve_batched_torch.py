"""Batched serving example of the PyTorch/CUDA port: continuous batching with
slot retirement (the serving-level dead-block prediction), gemma-7b reduced
to a smoke size, as ``examples/serve_batched.py`` runs the JAX package.

Runs on the card unless ``--device cpu`` is given; other launcher options
given here are passed on too.

Run:  PYTHONPATH=src python examples/serve_batched_torch.py
      PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
"""

import sys

from repro_torch.launch.serve import main

main(["--arch", "gemma-7b", "--requests", "6", "--max-new", "8", "--max-batch", "3",
      "--max-seq", "96", *sys.argv[1:]])
