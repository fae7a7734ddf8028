from skix_torch.utils.device import resolve_device  # noqa: F401
from skix_torch.utils.profiling import StageTimer  # noqa: F401
