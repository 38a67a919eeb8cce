# mirror of visionllmv2/datasets/configs/det/cod_val.py
datasets = [
    {
        "type": "cod_det",
        "ann_file": "data/cod/annotations/test.json",
        "img_prefix": "data/cod/Imgs",
        "with_mask": True,
        "test_mode": True,
    }
]
