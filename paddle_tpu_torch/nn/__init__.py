"""The port's layer set (counterpart of ``paddle_tpu.nn``): ``Layer``,
the convolution, normalisation, pooling, activation, common, container,
loss, recurrent and transformer layers, ``functional``, ``initializer``,
``Parameter`` and ``ParamAttr``, and the gradient clips."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradBase,
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
)
from .layer.activation import *  # noqa: F401,F403
from .layer.common import (  # noqa: F401
    AlphaDropout,
    Bilinear,
    CosineSimilarity,
    Dropout,
    Dropout2D,
    Dropout3D,
    Embedding,
    Flatten,
    Identity,
    Linear,
    Pad1D,
    Pad2D,
    Pad3D,
    PixelShuffle,
    PixelUnshuffle,
    Unfold,
    Upsample,
    UpsamplingBilinear2D,
    ZeroPad2D,
)
from .layer.container import (  # noqa: F401
    LayerDict,
    LayerList,
    ParameterList,
    Sequential,
)
from .layer.conv import *  # noqa: F401,F403
from .layer.layers import Layer  # noqa: F401
from .layer.loss import *  # noqa: F401,F403
from .layer.norm import *  # noqa: F401,F403
from .layer.pooling import *  # noqa: F401,F403
from .layer.rnn import *  # noqa: F401,F403
from .layer.transformer import *  # noqa: F401,F403
from .parameter import Parameter, ParamAttr  # noqa: F401
