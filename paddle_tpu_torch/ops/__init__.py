from .activation import swiglu
from .fused_ops import fused_linear_cross_entropy, rope_qk
from .nn_ops import cross_entropy, rms_norm, scaled_dot_product_attention

__all__ = [
    "cross_entropy", "fused_linear_cross_entropy", "rms_norm", "rope_qk",
    "scaled_dot_product_attention", "swiglu",
]
