"""PyTorch/CUDA port of the block-circulant (SWM) serving stack.

Mirrors ``repro`` module by module; the JAX package is the reference this
package is held against by the parity tests. Every TPU kernel on a ported
path is a hand-written CUDA kernel for Hopper (``sm_90a``); tensors on the
CPU take each kernel's plain PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
