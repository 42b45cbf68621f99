"""Pipeline stages of the port: detect, compact, delta conv / pool, and the
hand-written CUDA kernels under ``kernels/``."""
