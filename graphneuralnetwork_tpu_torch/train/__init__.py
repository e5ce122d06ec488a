from .checkpoint import restore_checkpoint, save_checkpoint  # noqa: F401
from .han_batch import fit_han_minibatch  # noqa: F401
from .han_loop import fit_han  # noqa: F401
from .loop import (  # noqa: F401
    FitResult,
    TrainState,
    create_train_state,
    fit_node_classifier,
    make_eval_fn,
    train_step,
)
from .metrics import (  # noqa: F401
    Accumulator,
    accuracy,
    masked_softmax_cross_entropy,
)
from .scan_loop import fit_node_classifier_scan, run_epochs  # noqa: F401
from .schedule import (  # noqa: F401
    OptimizerSpec,
    make_optimizer,
    warmup_poly_factor,
)
