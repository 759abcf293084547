from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedules import make_schedule  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_gradients,
    decompress_gradients,
    error_feedback_update,
)
