# mirror of visionllmv2/datasets/configs/pose/unikpt_val.py
datasets = [
    {
        "type": "coco_pose",
        "ann_file": "data/coco/annotations/person_keypoints_val2017.json",
        "img_prefix": "data/coco/val2017",
        "test_mode": True,
    },
    {
        "type": "crowdpose",
        "ann_file": "data/crowdpose/annotations/crowdpose_test.json",
        "img_prefix": "data/crowdpose/images",
        "test_mode": True,
    },
]
