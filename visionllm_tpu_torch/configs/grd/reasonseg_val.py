# mirror of visionllmv2/datasets/configs/grd/reasonseg_val.py
datasets = [
    {
        "type": "reasonseg",
        "ann_file": "data/reasonseg/val/annotations.json",
        "img_prefix": "data/reasonseg/val",
        "with_mask": True,
        "test_mode": True,
    }
]
