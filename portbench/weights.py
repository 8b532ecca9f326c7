"""The benchmark's model weights, made from the seed on the run's device.

Every leaf the reference's parameter spec draws from a normal distribution
takes its values from one standard-normal fill of a single flat f32 buffer
(one call to the device's generator), scaled by 1/sqrt(fan-in) leaf by leaf;
norm scales are ones and biases zeros.  The same seed gives the same bits
on the same device, so the reference draws the weights again instead of
keeping a copy, and both sides are handed the same tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# what each draw of the run seeds its generator with: (seed, purpose)
PURPOSES = {"weights": 1, "batches": 2, "schedule": 3}


def generator_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``'s generator, from the run's seed."""
    ss = np.random.SeedSequence([seed % 2 ** 64, PURPOSES[purpose]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw(spec: list, seed: int, device) -> dict:
    """{path: tensor} for every (path, shape, init) of ``spec``, f32 on
    ``device``; the normal leaves are views of one buffer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, "weights"))
    normal = [s for s in spec if s[2][0] == "normal"]
    total = sum(math.prod(shape) for _, shape, _ in normal)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for path, shape, (_, fan_in) in normal:
        size = math.prod(shape)
        out[path] = flat[off:off + size].view(shape).mul_(
            1.0 / math.sqrt(fan_in))
        off += size
    for path, shape, init in spec:
        if init[0] == "ones":
            out[path] = torch.ones(shape, dtype=torch.float32, device=device)
        elif init[0] == "zeros":
            out[path] = torch.zeros(shape, dtype=torch.float32, device=device)
    return out


def nested(params: dict) -> dict:
    """The {path: tensor} map as the nested tree the program takes."""
    tree: dict = {}
    for path, t in params.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return tree
