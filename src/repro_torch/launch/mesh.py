"""Production meshes.

The port of ``repro/launch/mesh.py``.  ``make_production_mesh`` is a
FUNCTION (importing the module touches no device or process-group state):
(16, 16) = 256 ranks, axes (data, model); multi_pod adds a leading "pod"
axis — (2, 16, 16) = 512 ranks.  The caller initialises the process group
over that many ranks first (real GPUs, or torch's fake backend to check
placements without them); ``device_type`` is ``init_device_mesh``'s.
"""

from __future__ import annotations

__all__ = ["make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
