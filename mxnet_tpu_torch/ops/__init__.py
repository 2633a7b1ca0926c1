"""Operator registry and implementations; importing this package registers
every op (counterpart of ``mxnet_tpu/ops``)."""
from .registry import P, OpDef, register, get_op, list_ops, invoke

from . import elemwise      # noqa: F401
from . import shape_ops     # noqa: F401
from . import nn            # noqa: F401
from . import fused_unit    # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import linalg        # noqa: F401
from . import reduce        # noqa: F401
from . import cache         # noqa: F401
from . import rnn           # noqa: F401
from . import contrib_det   # noqa: F401
