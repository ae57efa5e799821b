"""Block-circulant matmul: the CUDA kernel (``kernel``), the public ops
(``ops``) and frozen-table planning (``plan``)."""

from repro_torch.kernels.block_circulant.ops import (
    block_circulant_matmul, block_circulant_matmul_multi, freq_weights)
from repro_torch.kernels.block_circulant.plan import (BCPlan,
                                                      build_multi_plan,
                                                      build_plan,
                                                      freeze_params)

__all__ = ["block_circulant_matmul", "block_circulant_matmul_multi",
           "freq_weights", "BCPlan", "build_plan", "build_multi_plan",
           "freeze_params"]
