"""paddle_tpu_torch.nn — the nn surface of the port (counterpart of
paddle_tpu.nn): `Layer` and its layers, the recurrent layers, losses,
functional ops and the decode API.  Left out with their queue items:
`SwitchMoE` and `SyncBatchNorm` (the collective path), and the static
graph's `ClipGradByGlobalNorm`, `ClipGradByNorm`, `ClipGradByValue`,
`clip` and `clip_by_norm` (`fluid.clip`)."""

from . import functional, initializer  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer import conv, loss, vision  # noqa: F401 - submodule aliases
from .layer import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                    Layer, Parameter, RNNCellBase, SimpleRNN, SimpleRNNCell)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa
