"""Fixture: a hazard under torch.compile outside the pass's scope
(onix_torch/pipelines/ is host code): never a finding."""
import time

import torch


@torch.compile
def outside_scope(x):
    return x * time.time()
