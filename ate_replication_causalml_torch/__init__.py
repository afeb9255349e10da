"""PyTorch/CUDA port of ``ate_replication_causalml_tpu``.

The JAX package is the reference; this package reproduces its slices
on an NVIDIA H100 with PyTorch for the tensor math and hand-written
CUDA kernels (``csrc/``) where the JAX package runs a Pallas kernel.
It never imports ``jax`` or the JAX package.

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``. There is no silent fallback to the CPU when no card
is present: a CUDA request without a card raises. Kernel wrappers run
their plain PyTorch version only for tensors that lie on the CPU.
"""

import torch

# The f32 contracts (IRLS normal equations, histogram sums) are stated
# for full-precision float32 arithmetic. Hopper would otherwise be free
# to run float32 matmuls/convolutions in TF32 (about 3 decimal digits),
# so both switches are pinned off for the whole process at import.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain CPU versions"
        )
    return dev
