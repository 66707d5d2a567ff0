"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/*.cu`` holds the CUDA C++ sources; ``_build`` compiles them with
``nvcc`` on first use and keeps the per-kernel launch counts.
"""
from ._build import launch_counts, reset_launch_counts, variant_counts

__all__ = ["launch_counts", "reset_launch_counts", "variant_counts"]
