"""paddle_tpu_torch.nn — the nn surface of the port (counterpart of
paddle_tpu.nn): `Layer` and its layers, the recurrent layers, losses,
functional ops and the decode API, and, as the reference binds them,
the static graph's `ClipGradByGlobalNorm`, `ClipGradByNorm`,
`ClipGradByValue` (`fluid.clip`), `clip` and `clip_by_norm` (the 1.x
layers).  Left out with its queue item: `SwitchMoE` (the model-parallel
half of the collective path, ROADMAP queue 1 item 10b)."""

from . import functional, initializer  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer import conv, loss, vision  # noqa: F401 - submodule aliases
from .layer import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                    Layer, Parameter, RNNCellBase, SimpleRNN, SimpleRNNCell)
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa
from ..fluid.clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                          ClipGradByValue)
from ..fluid.layers import clip, clip_by_norm  # noqa: F401
