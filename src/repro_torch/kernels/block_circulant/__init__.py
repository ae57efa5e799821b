"""Block-circulant matmul: the CUDA kernel (``kernel``), the public ops
(``ops``) and frozen-table planning (``plan``)."""
