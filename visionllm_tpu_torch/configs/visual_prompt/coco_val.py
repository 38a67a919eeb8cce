# mirror of visionllmv2/datasets/configs/visual_prompt/coco_val.py
datasets = [
    {
        "type": "coco_interactive",
        "ann_file": "data/coco/annotations/instances_val2017.json",
        "img_prefix": "data/coco/val2017",
        "test_mode": True,
    }
]
