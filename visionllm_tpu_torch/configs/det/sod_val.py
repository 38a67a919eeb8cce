# mirror of visionllmv2/datasets/configs/det/sod_val.py — five SOD suites
datasets = [
    {"type": "sod_det", "dataset_name": name,
     "ann_file": f"data/sod/{name}/annotations/test.json",
     "img_prefix": f"data/sod/{name}/images",
     "with_mask": True, "test_mode": True}
    for name in ("DUTS", "DUT-OMRON", "ECSSD", "HKU-IS", "PASCAL-S")
]
