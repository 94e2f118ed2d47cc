"""Device choice and numeric precision for the port.

Everything runs in float32, as the reference does, and float32 products
stay IEEE float32: TF32 keeps ~3 decimal digits, and the ``aa + bb - 2ab``
distance expansion then turns the kernel matrix indefinite (the reference
pins its cross term to full precision for the same reason,
``orion_tpu/algo/gp/kernels.py:16-18``).  Importing this module sets
PyTorch's process-wide switches accordingly.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Never falls back to the CPU: asking for CUDA where no card is present
    raises.  The CPU runs only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "orion_tpu_torch: CUDA requested but no CUDA device is available "
            "(pass device='cpu' to run on the CPU)"
        )
    return dev
