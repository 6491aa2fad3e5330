"""The layers of the port's ``nn`` (``paddle_tpu/nn/layer``)."""
from .common import (  # noqa: F401
    PixelShuffle, Unfold, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D,
)
from .conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LocalResponseNorm,
    SyncBatchNorm,
)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
)
from .loss import CTCLoss, HSigmoidLoss  # noqa: F401
from .rnn import (  # noqa: F401
    GRU, LSTM, RNN, BeamSearchDecoder, BiRNN, GRUCell, LSTMCell, RNNBase,
    RNNCellBase, SimpleRNN, SimpleRNNCell, dynamic_decode,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
