# mirror of visionllmv2/datasets/configs/det/odinw13_val.py — 13 suites
_SUITES = [
    "AerialMaritimeDrone", "Aquarium", "CottontailRabbits",
    "EgoHands", "NorthAmericaMushrooms", "Packages", "PascalVOC",
    "pistols", "pothole", "Raccoon", "ShellfishOpenImages",
    "thermalDogsAndPeople", "VehiclesOpenImages",
]
datasets = [
    {"type": "odinw_det",
     "ann_file": f"data/odinw/{s}/valid/annotations_without_background.json",
     "img_prefix": f"data/odinw/{s}/valid",
     "test_mode": True}
    for s in _SUITES
]
