# mirror of visionllmv2/datasets/configs/semseg/ade20k_val.py
datasets = [
    {
        "type": "semseg",
        "ann_file": "data/ade20k/validation.json",
        "img_prefix": "data/ade20k/images/validation",
        "test_mode": True,
    }
]
