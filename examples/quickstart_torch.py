"""Quickstart: train a reduced llama3.2-style model for a few hundred
steps through the PyTorch / CUDA port and watch the loss drop.

  PYTHONPATH=src python examples/quickstart_torch.py               # on the CUDA card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain PyTorch path

The twin of ``examples/quickstart.py``: the same ``launch.train`` flags
and printed lines.  Without a card and without ``--device cpu`` it exits
with an error.
"""

import sys

from repro_torch.launch.train import main

ARGS = ["--arch", "llama3.2-1b", "--steps", "200", "--batch", "8", "--seq", "64",
        "--lr", "3e-3", "--log-every", "20"]

if __name__ == "__main__":
    raise SystemExit(main(ARGS + sys.argv[1:]))
