#!/usr/bin/env python3
"""Training CLI of the PyTorch port, the twin of ``train.py``.

    python3 train_torch.py --dataroot <data> --outputroot <out> --run-name <name> [--<key> <value> ...]

Trains on the GPU; ``IEAGAN_PLATFORM=cpu`` runs on the CPU instead. With no
CUDA device and no such request it exits with an error. See
``ieagan_torch/train/cli.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ieagan_torch.train.cli import main  # noqa: E402

if __name__ == "__main__":
    main()
