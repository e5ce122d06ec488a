"""Host-side utilities of the port: the NaN checks of ``debug.py``, the
profiler, step timer and metric logger of ``profiling.py`` (exported
here, as the JAX package's ``utils`` does), and ``tb.SummaryWriter``, the
logging shim behind BiNE's ``logdir`` (imported by its user, so that
importing this package loads no TensorBoard backend)."""

from .debug import (  # noqa: F401
    assert_all_finite,
    debug_nans_enabled,
    find_nonfinite,
    nan_checked,
)
from .profiling import MetricLogger, StepTimer, trace  # noqa: F401
