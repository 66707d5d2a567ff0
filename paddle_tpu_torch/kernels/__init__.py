"""Hand-written Hopper kernels of the port and their plain versions.

``csrc/*.cu`` holds the CUDA C++ sources; ``_build`` compiles them with
``nvcc`` on first use and keeps the per-kernel launch counts. Importing
this package registers the kernels that are ``torch.library`` ops
(``paddle_tpu_torch::flash_attention_fwd``, ``flash_attention_bwd``,
``grouped_matmul``, ``grouped_matmul_wgrad``), so a program exported
with them (``jit.save``) resolves its nodes on ``jit.load``.
"""
from . import flash_attention, grouped_matmul  # noqa: F401  (registers ops)
from ._build import launch_counts, reset_launch_counts, variant_counts

__all__ = ["launch_counts", "reset_launch_counts", "variant_counts"]
