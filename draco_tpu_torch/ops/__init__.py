"""Device operators: SHT, banded algebra, regridding, m-mode packing and
the hand-written CUDA kernels."""
