"""fluid.layers: the op-emitting layer library (counterpart of
paddle_tpu/fluid/layers/): tensor, nn, loss, control_flow, rnn, the
learning-rate schedules, the sequence layers, the detection layers and
compat's legacy-name tail, star-imported in the reference's order
(compat last)."""

from . import math_op_patch  # noqa: F401 - installs Variable operator sugar
from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .sequence_lod import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from . import (tensor, nn, loss, control_flow, rnn,  # noqa: F401
               learning_rate_scheduler, sequence_lod, detection)
from .compat import *  # noqa: F401,F403 - the legacy-name tail
from . import compat as _compat  # noqa: F401

# the 2.x recurrent and decode classes the reference also gives under
# fluid.layers, resolved on first use (nn imports fluid, so an import
# here would cycle)
_NN_ALIASES = {"BeamSearchDecoder": "BeamSearchDecoder",
               "Decoder": "Decoder", "GRUCell": "GRUCell",
               "LSTMCell": "LSTMCell", "RNNCell": "RNNCellBase",
               "dynamic_decode": "dynamic_decode"}


def __getattr__(name):
    if name in _NN_ALIASES:
        from ... import nn
        return getattr(nn, _NN_ALIASES[name])
    raise AttributeError(name)
