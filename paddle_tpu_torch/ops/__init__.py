from .activation import swiglu
from .fused_ops import rope_qk
from .nn_ops import rms_norm, scaled_dot_product_attention

__all__ = ["rms_norm", "rope_qk", "scaled_dot_product_attention", "swiglu"]
