"""The card the port runs on, the counterpart of the JAX package's
``launch/mesh.py``.

The reference builds TPU meshes (a 16 x 16 pod, two pods, a hierarchical
node x fsdp x model mesh) and holds a TPU's peak rates for its roofline.
The port runs on one NVIDIA H100: one card has no mesh, so there are no
mesh builders here (ROADMAP.md, "One card"), only the card's published
peaks, which the dry run's roofline and every kernel's bound divide by
(held in :mod:`repro_torch.kernels.cost`, since the kernels' bounds need
them, and named here as the reference names its TPU's), and :func:`card`,
what the card at hand says of itself.
"""

from __future__ import annotations

import subprocess

from ..kernels.cost import (HBM_BW, HBM_BYTES, PEAK_FLOPS,  # noqa: F401
                            PEAK_FLOPS_BF16, PEAK_FLOPS_F32, SMS)


def card(index: int = 0) -> dict:
    """The CUDA device ``index`` as it reports itself: the name, SM count
    and total memory from ``torch.cuda.get_device_properties``, and
    ``smi``, the line ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints for it (its power limit moves every
    measured rate)."""
    import torch

    p = torch.cuda.get_device_properties(index)
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return {"name": p.name, "sms": p.multi_processor_count,
            "total_memory": p.total_memory, "smi": smi}
