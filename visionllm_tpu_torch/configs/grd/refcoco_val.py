# mirror of visionllmv2/datasets/configs/grd/refcoco_val.py:1-60
_SPLITS = [
    ("refcoco-unc", "instances_val.json"),
    ("refcoco-unc", "instances_testA.json"),
    ("refcoco-unc", "instances_testB.json"),
    ("refcocoplus-unc", "instances_val.json"),
    ("refcocoplus-unc", "instances_testA.json"),
    ("refcocoplus-unc", "instances_testB.json"),
    ("refcocog-umd", "instances_val.json"),
    ("refcocog-umd", "instances_test.json"),
]
datasets = [
    {"type": "refcoco_grd",
     "ann_file": f"data/coco2014/annotations/{d}/{f}",
     "img_prefix": "data/coco2014/train2014",
     "with_mask": True, "test_mode": True}
    for d, f in _SPLITS
]
