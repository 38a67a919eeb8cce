"""Detection dataset variants over other sources (counterpart of
`visionllm_tpu/data/det_variants.py`): one class a reference file, on the
conversation and target machinery of `CocoDetDataset`.

* `det_generic` - COCO-format files of other sources (Objects365, ...);
  classes from the annotation file, normalized strip + lower
  (det_llava.py:229); `dataset_name` is an argument.
* `odinw_det` - ODinW: classes from the annotation file, normalized.
* `crowdhuman_det` - one class, "person".
* `cod_det` - camouflaged objects: one class, "camouflage object", with
  instance masks.
* `sod_det` - salient objects: the train prompt names the class
  "forground object" or "salient object" at random, the test prompt
  always "forground object" (the reference's spelling, kept for prompt
  parity); instance masks.

All are `task = "det"`, so the task-grouped sampler sends them to the
gdino step.
"""

from __future__ import annotations

from typing import Dict, List

from visionllm_tpu_torch.data.build import register_dataset
from visionllm_tpu_torch.data.det_dataset import CocoDetDataset


@register_dataset("det_generic")
class GenericDetDataset(CocoDetDataset):
    """COCO-format detection over any source (Objects365, ...)."""

    task = "det"
    _normalize_names = True

    def __init__(self, *args, dataset_name: str = "objects365", **kw):
        super().__init__(*args, **kw)
        self.dataset_name = dataset_name


@register_dataset("odinw_det")
class OdinwDetDataset(CocoDetDataset):
    """ODinW: each suite's class vocabulary from its annotation file."""

    task = "det"
    dataset_name = "odinw"
    _normalize_names = True


@register_dataset("crowdhuman_det")
class CrowdHumanDetDataset(CocoDetDataset):
    task = "det"
    dataset_name = "crowdhuman"
    _classes = ["person"]


class _SingleClassDetDataset(CocoDetDataset):
    """One-query det (COD, SOD): the conversation asks about one class,
    so every annotation, whatever its category, maps to answer slot 0."""

    def __init__(self, *args, with_mask: bool = True, **kw):
        super().__init__(*args, with_mask=with_mask, **kw)

    def _class_name(self) -> str:
        raise NotImplementedError

    def _build_class_list(self, gt_labels) -> List[str]:
        return [self._class_name()]

    def _id2index(self, class_list) -> Dict[int, int]:
        return {i: 0 for i in range(len(self.coco.class_names))}


@register_dataset("cod_det")
class CodDetDataset(_SingleClassDetDataset):
    task = "det"
    dataset_name = "cod"
    _classes = ["camouflage object"]

    def _class_name(self) -> str:
        return "camouflage object"


@register_dataset("sod_det")
class SodDetDataset(_SingleClassDetDataset):
    task = "det"
    dataset_name = "sod"
    # the test-time name; train draws "salient object" half the time
    _classes = ["forground object"]

    def __init__(self, *args, dataset_name: str = "sod", **kw):
        super().__init__(*args, **kw)
        self.dataset_name = dataset_name

    def _class_name(self) -> str:
        if self.test_mode:
            return "forground object"
        return self.rng.choice(["forground object", "salient object"])
