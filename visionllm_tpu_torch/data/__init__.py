# the dataset modules register their types with `data.build` on import
from visionllm_tpu_torch.data import det_dataset as _det  # noqa: F401
from visionllm_tpu_torch.data import grd_dataset as _grd  # noqa: F401
