from . import activation as _activation
from . import fft_ops as _fft_ops
from . import manipulation as _manipulation
from . import math as _math
from . import nn_ops as _nn_ops
from . import random as _random
from . import rnn_ops as _rnn_ops
from .activation import *  # noqa: F401,F403
from .fft_ops import *  # noqa: F401,F403
from .fused_ops import fused_linear_cross_entropy, rope_qk
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .moe_ops import (
    grouped_matmul,
    moe_combine,
    moe_gate_dispatch,
    moe_ragged_combine,
    moe_ragged_dispatch,
)
from .nn_ops import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .rnn_ops import rnn  # noqa: F401

__all__ = sorted(
    {"fused_linear_cross_entropy", "grouped_matmul", "moe_combine",
     "moe_gate_dispatch", "moe_ragged_combine", "moe_ragged_dispatch",
     "rope_qk"}
    | set(_activation.__all__) | set(_manipulation.__all__)
    | set(_rnn_ops.__all__) | set(_math.__all__) | set(_fft_ops.__all__)
    | set(_random.__all__)
    | (set(_nn_ops.__all__) - {"flash_eligible"})
)
