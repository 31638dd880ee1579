"""Generator-only inference (the basf2 deployment path)."""

from ieagan_torch.deploy.inference import (
    FROZEN_CONFIG, Model, generate, generate_batched, generate_block, sample_batched)
