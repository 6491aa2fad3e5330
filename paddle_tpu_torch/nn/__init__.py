"""``paddle.nn`` of the port (reference ``paddle_tpu/nn/__init__.py``):
``Layer`` and the layers whose ops the port has (the Transformer
layers, the vision layers (conv, pooling and the norms) and the
recurrent layers, cells and beam search included), ``ParamAttr``,
``initializer``, ``functional``,
``utils`` (the weight and spectral norm hooks) and the gradient clips
the optimizers take (``grad_clip=``)."""
from . import functional, initializer, utils  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from .initializer import ParamAttr  # noqa: F401
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish,
    Tanh, Tanhshrink, ThresholdedReLU,
)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, PixelShuffle, Unfold, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .layer.container import (  # noqa: F401
    LayerDict, LayerList, ParameterList, Sequential,
)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, CTCLoss, HSigmoidLoss,
    KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
)
from .layer.rnn import (  # noqa: F401
    GRU, LSTM, RNN, BeamSearchDecoder, BiRNN, GRUCell, LSTMCell, RNNBase,
    RNNCellBase, SimpleRNN, SimpleRNNCell, dynamic_decode,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .layer_base import HookRemoveHelper, Layer  # noqa: F401
