"""Fixture (clean): the violating module's fixed forms — host reads
hoisted out of the captured code and passed in as tensors, torch's own
generator inside the capture, and one trace-time stamp that must stay
under a justified exemption."""
import time

import numpy as np
import torch


@torch.compile
def compiled_step(x, t):
    return x * t


def helper(x, gen):
    return x + torch.rand(x.shape, generator=gen)   # device RNG: fine


def graphed(x, g, gen):
    noise = torch.as_tensor(np.random.rand())       # host RNG before capture
    with torch.cuda.graph(g):
        y = helper(x, gen) * noise
    return y


def begin_end(x, g):
    t0 = time.time()                    # before capture_begin: fine
    g.capture_begin()
    # lint: exempt[tracehaz] -- fixture: a stamp frozen at capture by design, read back once per graph build
    stamp = time.time()
    z = x * 2
    g.capture_end()
    return z, stamp, time.time() - t0
