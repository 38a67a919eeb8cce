# mirror of visionllmv2/datasets/configs/det/crowdhuman_val.py
datasets = [
    {
        "type": "crowdhuman_det",
        "ann_file": "data/crowdhuman/annotations/val.json",
        "img_prefix": "data/crowdhuman/Images",
        "test_mode": True,
    }
]
