"""Fixture: capture hazards under each torch entry that captures or
compiles device work, laid out as a hot-path module (onix_torch/models/
is in the tracehaz pass's scope)."""
import random
import time

import numpy as np
import torch


@torch.compile
def compiled_step(x):
    t = time.time()                     # tracehaz: host clock
    return x * t


@torch.compile(mode="reduce-overhead")
def compiled_with_options(x):
    return x.item()                     # tracehaz: implicit sync


def helper(x):
    return x + np.random.rand()         # tracehaz: host RNG (reached)


fast = torch.compile(lambda x: helper(x))


def graphed(x, g):
    with torch.cuda.graph(g):
        y = x * 2
        y.item()                        # tracehaz: sync inside capture
    return y


def begin_end(x, g):
    g.capture_begin()
    z = x + random.random()             # tracehaz: host RNG
    g.capture_end()
    w = time.time()                     # after capture_end: fine
    return z, w


def host_only(x):
    return time.time(), np.random.rand(), x.item()   # never captured: fine
