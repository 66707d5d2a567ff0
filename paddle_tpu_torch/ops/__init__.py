from .activation import swiglu
from .fused_ops import fused_linear_cross_entropy, rope_qk
from .moe_ops import (
    grouped_matmul,
    moe_combine,
    moe_gate_dispatch,
    moe_ragged_combine,
    moe_ragged_dispatch,
)
from .nn_ops import cross_entropy, rms_norm, scaled_dot_product_attention

__all__ = [
    "cross_entropy", "fused_linear_cross_entropy", "grouped_matmul",
    "moe_combine", "moe_gate_dispatch", "moe_ragged_combine",
    "moe_ragged_dispatch", "rms_norm", "rope_qk",
    "scaled_dot_product_attention", "swiglu",
]
