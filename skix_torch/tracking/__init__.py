"""SAM3 front path of the port: detector, memory tracker, masklet
lifecycle, the session API and the interactive predictors (port of
``skix/tracking``; the same exports)."""
from skix_torch.tracking.lifecycle import (  # noqa: F401
    TrackerConfig,
    TrackerState,
    init_tracker_state,
    track_sequence,
    tracker_step,
)
from skix_torch.tracking.detector import DetrDetector  # noqa: F401
from skix_torch.tracking.masklet import (  # noqa: F401
    MaskletConfig,
    MaskletState,
    MaskletVideoModel,
    init_masklet_state,
    masklet_update,
    track_masklets,
)
from skix_torch.tracking.session import VideoPredictor  # noqa: F401
from skix_torch.tracking.memory_tracker import (  # noqa: F401
    MaskMemoryTracker,
    propagate_object,
    propagate_objects,
)
from skix_torch.tracking.postprocess import postprocess_detections  # noqa: F401
from skix_torch.tracking.point_sampling import (  # noqa: F401
    get_best_gt_match_from_multimasks,
    get_next_point,
    sample_box_points,
    sample_one_point_from_error_center,
    sample_random_points_from_errors,
    select_closest_cond_frames,
)
from skix_torch.tracking.sam_prompt_encoder import (  # noqa: F401
    InteractiveSegmenter,
    SamImagePredictor,
    SamPromptEncoder,
)
from skix_torch.tracking.vos_predictor import InteractiveVideoPredictor  # noqa: F401
