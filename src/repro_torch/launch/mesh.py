"""Production meshes over the port's ``distr.mesh.Mesh``.

Port of ``repro.launch.mesh``. Functions, not module constants: importing
this module touches no device. The production meshes are one pod of
16 x 16 positions over ("data", "model") and two such pods over ("pod",
"data", "model"). The visible cards fill them by default; a caller may
pass any device list instead (one card repeated, CPU positions, or
``torch.device("meta")`` positions for layout accounting, which allocate
nothing).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.distr.mesh import Mesh


def _cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") with ``multi_pod``, filled in order from ``devices``
    (the visible CUDA devices when None). Fewer devices than positions
    raise ValueError, as ``jax.make_mesh`` does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _cards() if devices is None else [torch.device(d) for d in devices]
    size = int(np.prod(shape))
    if len(devs) < size:
        raise ValueError(f"Number of devices {len(devs)} must be >= the "
                         f"product of mesh_shape {shape}")
    return Mesh(np.array(devs[:size], dtype=object).reshape(shape), axes)


def make_host_mesh(device="cuda") -> Mesh:
    """A 1-D "data" mesh over this host's cards (``device="cuda"``), or
    one CPU position (``device="cpu"``). No card raises ValueError."""
    if torch.device(device).type == "cpu":
        devs = [torch.device("cpu")]
    else:
        devs = _cards()
        if not devs:
            raise ValueError("make_host_mesh: no CUDA device is visible; "
                             "pass device='cpu' for a CPU mesh")
    return Mesh(np.array(devs, dtype=object), ("data",))
