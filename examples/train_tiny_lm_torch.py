"""End-to-end training example of the PyTorch/CUDA port: ~100M-param model, a
few hundred steps, with checkpoint/resume and the straggler watchdog, as
``examples/train_tiny_lm.py`` runs the JAX package.

This wraps the port's training launcher (repro_torch.launch.train) with the
reference example's arguments; pass --fast for a 10M-param run.  The
checkpoints go under build/examples/ in the checkout (a second run resumes
from them).  It runs on the card unless ``--device cpu`` is given; other
launcher options given here (``--steps``, ``--ckpt-dir``, ...) replace the
example's.

Run:  PYTHONPATH=src python examples/train_tiny_lm_torch.py [--fast]
      PYTHONPATH=src python examples/train_tiny_lm_torch.py --fast --device cpu
"""

from pathlib import Path
import sys

from repro_torch.launch.train import main

CKPT = Path(__file__).resolve().parents[1] / "build" / "examples"
extra = [a for a in sys.argv[1:] if a != "--fast"]
if "--fast" in sys.argv[1:]:
    args = ["--arch", "llama3.2-3b", "--reduce",
            "--steps", "60", "--batch", "8", "--seq", "128",
            "--ckpt-dir", str(CKPT / "tiny_ckpt"), "--ckpt-every", "25"]
else:
    # ~100M params: d_model 512, 12 layers, vocab 128256
    args = ["--arch", "llama3.2-3b", "--reduce",
            "--d-model", "512", "--layers", "12",
            "--steps", "300", "--batch", "16", "--seq", "256",
            "--ckpt-dir", str(CKPT / "100m_ckpt"), "--ckpt-every", "100"]
main(args + extra)
