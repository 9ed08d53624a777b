"""Layers of the port with the reference's names, layouts and default
initialisers (``paddle_tpu/nn/layer/``)."""
from .activation import *  # noqa: F401,F403
from .common import (AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D,  # noqa: F401
                     Dropout3D, Embedding, Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D, Unfold,
                     Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa: F401
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,  # noqa: F401
                   Conv3DTranspose)
from .extension import *  # noqa: F401,F403
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,  # noqa: F401
                   HingeEmbeddingLoss, KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss,
                   SmoothL1Loss, TripletMarginLoss)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,  # noqa: F401
                   InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm, LocalResponseNorm,
                   RMSNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,  # noqa: F401
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from .rnn import GRU, LSTM, RNN, GRUCell, LSTMCell, SimpleRNN, SimpleRNNCell  # noqa: F401
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,  # noqa: F401
                          TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
