"""``paddle.nn`` of the port (counterpart of ``paddle_tpu/nn``): ``Layer``
and ``Parameter``, the initializers, the layers over ``nn.functional``,
convolution and pooling, the transformer and recurrent layers, the beam
search decoder, ``nn.utils`` and the gradient clips."""
from ..ops import _table  # noqa: F401  (the Tensor's methods)
from .layer_base import Layer, Parameter
from . import functional
from . import initializer
from .layers import (  # noqa: F401
    Linear, Embedding, Dropout, Dropout2D, Dropout3D, AlphaDropout, Flatten,
    Identity, Upsample, UpsamplingNearest2D, UpsamplingBilinear2D,
    PixelShuffle, PixelUnshuffle, Unfold, Fold,
    Sequential, LayerList, ParameterList, LayerDict, Unflatten,
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, SyncBatchNorm,
    LayerNorm, RMSNorm, GroupNorm, InstanceNorm1D, InstanceNorm2D,
    InstanceNorm3D, LocalResponseNorm,
    ReLU, ReLU6, GELU, SiLU, Silu, Swish, Sigmoid, Tanh, Softmax, Softmax2D,
    LogSoftmax, Softplus, Softsign, LeakyReLU, ELU, CELU, SELU, Mish,
    Hardtanh, Hardsigmoid, Hardswish, Hardshrink, Softshrink, Tanhshrink,
    LogSigmoid, ThresholdedReLU, Maxout, GLU, PReLU, RReLU,
    CrossEntropyLoss, MSELoss, L1Loss, NLLLoss, BCELoss, BCEWithLogitsLoss,
    KLDivLoss, SmoothL1Loss, CTCLoss, MarginRankingLoss, SoftMarginLoss,
    MultiMarginLoss, MultiLabelSoftMarginLoss, PoissonNLLLoss,
    GaussianNLLLoss, TripletMarginLoss, CosineEmbeddingLoss,
    HingeEmbeddingLoss, Bilinear, CosineSimilarity, Pad1D, Pad2D, Pad3D,
    ZeroPad2D,
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose, MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
    AvgPool3D, AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
    FractionalMaxPool2D, FractionalMaxPool3D, MaxUnPool1D, MaxUnPool2D,
    MaxUnPool3D, ChannelShuffle, PairwiseDistance,
    TripletMarginWithDistanceLoss, SpectralNorm, FeatureAlphaDropout,
    AdaptiveLogSoftmaxWithLoss, HSigmoidLoss, RNNTLoss,
)
from .transformer import (MultiHeadAttention, TransformerEncoderLayer,
                          TransformerEncoder, TransformerDecoderLayer,
                          TransformerDecoder, Transformer)
from .rnn import (SimpleRNN, LSTM, GRU, SimpleRNNCell, RNNCellBase,
                  LSTMCell, GRUCell, RNN, BiRNN)
from .decode import Decoder, BeamSearchDecoder, dynamic_decode
from .clip import ClipGradByNorm, ClipGradByValue, ClipGradByGlobalNorm
from . import utils
