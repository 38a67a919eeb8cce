# mirror of visionllmv2/datasets/configs/det/coco_val.py:1-9
datasets = [
    {
        "type": "coco_det",
        "ann_file": "data/coco/annotations/instances_val2017.json",
        "img_prefix": "data/coco/val2017",
        "with_mask": True,
        "test_mode": True,
    }
]
