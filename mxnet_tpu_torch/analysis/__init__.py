"""Graph analysis (counterpart of ``mxnet_tpu/analysis``): only the
optimizer's fused-op ``select`` pass is ported, which the decode engine
runs over its step, draft and commit graphs."""
from .optimize import (OptAction, OptPlan, OptState, optimize_graph,
                       SELECT_OPT_PASSES)

__all__ = ["OptAction", "OptPlan", "OptState", "optimize_graph",
           "SELECT_OPT_PASSES"]
