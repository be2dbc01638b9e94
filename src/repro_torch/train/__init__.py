"""Training of the port (the counterpart of ``repro.train``)."""
from .loop import (TrainState, build_train_step, init_state,  # noqa: F401
                   make_policy, train_loop)
