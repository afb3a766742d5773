"""Program transpilers (counterpart of paddle_tpu/fluid/transpiler/): the
collective transpilers, in collective.py."""

from .collective import (Collective, FP16AllReduce,  # noqa: F401
                         GradAllReduce, LocalSGD)
