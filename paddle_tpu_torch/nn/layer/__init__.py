"""The layers of the port's ``nn`` (``paddle_tpu/nn/layer``)."""
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
