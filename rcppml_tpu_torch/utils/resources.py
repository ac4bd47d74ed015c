"""Device introspection: the ``gpu_available()`` / ``gpu_info()`` analog
(core/resources.hpp:48-149, R/gpu_backend.R:68-143) on ``torch.cuda``.

The port of ``rcppml_tpu/utils/resources.py``, whose accelerator is JAX's
default backend.  Here it is the CUDA card; there is no TPU variant.
``load_data`` comes with the streaming slice (ROADMAP.md, Queue 1 item 11).
"""

from __future__ import annotations

import torch


def gpu_available() -> bool:
    """True when a CUDA card is visible."""
    return torch.cuda.is_available()


def gpu_info() -> dict:
    """The cards: name, compute capability, memory and count, and whether
    the hand-written kernels (sm_90a) can run on card 0."""
    from ..device import kernels_available
    if not gpu_available():
        return {"backend": "cpu", "num_devices": 0, "devices": [],
                "kernels_available": False}
    devices = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        devices.append({"name": props.name,
                        "capability": (props.major, props.minor),
                        "total_memory": int(props.total_memory),
                        "multiprocessors": int(props.multi_processor_count)})
    return {"backend": "cuda", "num_devices": len(devices),
            "devices": devices, "kernels_available": kernels_available()}


accelerator_available = gpu_available
accelerator_info = gpu_info
