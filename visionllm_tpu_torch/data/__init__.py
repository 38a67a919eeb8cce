# the dataset modules register their types with `data.build` on import
from visionllm_tpu_torch.data import det_dataset as _det  # noqa: F401
from visionllm_tpu_torch.data import grd_dataset as _grd  # noqa: F401
from visionllm_tpu_torch.data import gen_dataset as _gen  # noqa: F401
from visionllm_tpu_torch.data import llava_dataset as _llava  # noqa: F401
from visionllm_tpu_torch.data import pose_dataset as _pose  # noqa: F401
