# the dataset modules register their types with `data.build` on import
from visionllm_tpu_torch.data import det_dataset as _det  # noqa: F401
from visionllm_tpu_torch.data import grd_dataset as _grd  # noqa: F401
from visionllm_tpu_torch.data import gen_dataset as _gen  # noqa: F401
from visionllm_tpu_torch.data import llava_dataset as _llava  # noqa: F401
from visionllm_tpu_torch.data import pose_dataset as _pose  # noqa: F401
from visionllm_tpu_torch.data import det_variants as _detv  # noqa: F401
from visionllm_tpu_torch.data import interactive_dataset as _inter  # noqa: F401
from visionllm_tpu_torch.data import mmic_dataset as _mmic  # noqa: F401
from visionllm_tpu_torch.data import region_dataset as _region  # noqa: F401
from visionllm_tpu_torch.data import region_variants as _regv  # noqa: F401
from visionllm_tpu_torch.data import semseg_dataset as _semseg  # noqa: F401
