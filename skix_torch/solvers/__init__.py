from skix_torch.solvers.ba import (  # noqa: F401
    BAConfig,
    BAResult,
    ba_loss_terms,
    bundle_adjust,
)
from skix_torch.solvers.lm import levenberg_marquardt  # noqa: F401
