"""AdamW with low-precision moment storage, and LR schedules (the
counterpart of ``repro.optim``)."""

from .adamw import OptConfig, adamw_init, adamw_update  # noqa: F401
from .schedules import constant, warmup_cosine  # noqa: F401
