from skix_torch.io.contracts import (  # noqa: F401
    PTInfo,
    check_pt_info_shapes,
    load_pt_info,
    save_pt_info,
)
