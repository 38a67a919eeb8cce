"""Q/A template banks for the perception tasks (own copy of the JAX
package's `data/templates.py`, byte for byte in every constant).

These are prompt-data constants from the reference (must match
byte-for-byte where eval uses them: test-mode always takes index 0 —
coco_llava.py:216-244). Sources: datasets/coco_llava.py:17-66 (det),
refcoco_llava.py (grd), unikpt_llava.py (pose), coco_interactive.py
(visual prompts).
"""

DET_QUESTIONS = [
    "Can you analyze the image and identify the <class> present?",
    "In this image, could you detect all instances of <class>?",
    "Are you capable of identifying <class> within this image?",
    "Could you please detect the objects you find that belong to the <class> category in the image?",
    "Can you perform object detection on the image and tell me the <class> you find?",
    "I'm trying to detect <class> in the image. Can you help me?",
    "Can you carry out object detection on this image and identify the <class> it contains?",
    "In the context of the image, I'd like to know which objects fall under the category of <class>. Is that something you can do?",
    "I have an image that needs examination for objects related to <class>. Can you perform that?",
    "Can you determine if there are any <class> present in the image using object detection?",
    "Could you please carry out object detection on this image and list any <class> that you discover?",
    "Could you help me identify the objects corresponding to <class> in the provided image?",
    "Are you capable of detecting and labeling <class> objects within the image?",
    "I'm curious about the objects in the image that correspond to the <class> category. Could you assist in finding them?",
    "Can you detect <class> within the image and provide information about its presence?",
    "Please examine the image and let me know which objects fall under the <class> category.",
    "Please perform object detection on this image for identifying <class>.",
    "I need your expertise to locate <class> in this image.",
    "Please let me know the objects falling into the <class> category in the image.",
    "Please help me identify objects falling under the <class> category in this image.",
    "Please assist me in identifying the <class> objects within the image.",
    "Please provide a breakdown of all the <class> objects visible in the image.",
    "Please analyze the image and let me know if you can find any objects categorized as <class>.",
    "I'm seeking your help in identifying <class> within the contents of the image.",
    "Please conduct object detection on the image to locate any <class> that may be present.",
    "Please execute object detection on this image and provide details about any <class> you detect.",
    "Please identify and list any <class> in the given image using object detection.",
    "Please analyze the image and let me know if there are any recognizable <class> objects.",
    "Detect any <class> in the given image, if possible.",
    "I need assistance in recognizing the <class> shown in the image.",
]

DET_YES = [
    "Yes, here are the results for <class> in the image.",
    "Certainly, the image shows the results for <class>.",
    "Absolutely, you can see the results for <class> in the image.",
    "Yes, the detection results for <class> are presented.",
    "Certainly, the image does show the results of <class>.",
    "Certainly, you can spot the results of <class> in the image.",
    "Yes, there is a clear depiction for the results of <class>.",
    "Of course, the image provides a comprehensive results of <class>.",
    "Absolutely, the image showcases the results of <class>.",
    "Sure, the image contains the detection results for <class>.",
]


def det_answer_tokens(num_embs: int) -> str:
    """The routing-token block appended per class: '[DET][EMB][EMB2]...'
    (coco_llava.py:230-238)."""
    if num_embs == 1:
        return "[DET][EMB]"
    return "[DET][EMB]" + "".join(f"[EMB{i}]" for i in range(2, num_embs + 1))


def grd_answer_tokens(num_embs: int) -> str:
    if num_embs == 1:
        return "[GRD][EMB]"
    return "[GRD][EMB]" + "".join(f"[EMB{i}]" for i in range(2, num_embs + 1))


def pose_answer_tokens(num_embs: int) -> str:
    if num_embs == 1:
        return "[POSE][EMB]"
    return "[POSE][EMB]" + "".join(
        f"[EMB{i}]" for i in range(2, num_embs + 1))


# grounding templates (refcoco_llava.py:30-77; test mode uses index 0)
GRD_QUESTIONS = [
    "Where can we locate the <expression> in the image?",
    "Do you know where the <expression> is within the image?",
    "Have you seen the <expression> in this image? Where is it?",
    "Could you tell me where the <expression> is in the image?",
    "Whereabouts in the image can we find the <expression>?",
    "Do you have any idea where the <expression> might be in this image?",
    "Are you aware of the <expression>'s position within the image?",
    "Where in the image should we be looking for the <expression>?",
    "Is it possible to identify the <expression>'s location in this image?",
    "Have you figured out where the <expression> is in this image?",
    "Could you provide guidance on finding the <expression> in the image?",
    "Do you know where I can locate the <expression> in the picture?",
    "Can you tell me the precise location of the <expression> in the image?",
    "Would you be able to point out the <expression> within the image?",
    "Are you able to discern the <expression> in the image?",
    "Please help me locate the <expression> in the image.",
    "Please find the object indicated by the expression <expression> in the image.",
    "Please assist in identifying the <expression> within the image.",
    "Please determine the exact position of the <expression> in the image.",
    "Please ascertain the whereabouts of the <expression> in this image.",
    "Please assist me in locating the <expression> within the image.",
    "Please take a moment to find the object denoted by the expression <expression> in the image.",
    "Please help us identify the precise location of the <expression> in this image.",
    "Please provide your guidance in finding and marking the <expression> within the image.",
    "Please make it a priority to discover and highlight the <expression> within the image.",
    "Let's determine the specific area where the <expression> is situated in the image.",
    "We're aiming to establish the spatial coordinates of the <expression> in this image.",
    "We need to establish the exact whereabouts of the <expression> within the image.",
    "We are actively engaged in the process of locating the <expression> in the image.",
    "Let's find the <expression> within the image.",
]

GRD_YES = [
    "Yes, it is <expression>.",
    "Certainly, it is <expression>.",
    "Absolutely, it is <expression>.",
    "Yes, it is <expression>.",
    "Affirmative, it is <expression>.",
    "Sure, it is <expression>.",
    "Of course, it is <expression>.",
    "Without question, it is <expression>.",
    "Certainly, it is <expression>.",
    "Absolutely, it is <expression>.",
]

# pose templates (unikpt_llava.py:60-99; test mode uses index 0)
POSE_QUESTIONS = [
    "Can you examine the image and pinpoint the keypoint locations of the <class>?",
    "Could you analyze the picture and determine the keypoint placement of the <class>?",
    "Please inspect the image and locate the keypoints for <class>.",
    "Can you evaluate the photo and identify where the keypoints of <class> are situated?",
    "Look at the image and detect the keypoint positions of the <class>.",
    "Please analyze this image and find the keypoints of <class>.",
    "Can you check the image and show me where the keypoints of <class> are located?",
    "Please find the exact keypoint position of the <class>.",
    "Please observe the photo and identify the keypoint locations of the <class>.",
    "Can you review the image and point out the keypoints of <class>?",
]

POSE_ANS = [
    "Utilizing keypoints detection, the image analysis reveals the location of <class>.",
    "By focusing on keypoints in the image, you can accurately detect the position of <class>.",
    "The keypoints in the image indicate the precise location of <class>.",
    "Through detailed keypoints analysis, the exact position of <class> in the photo can be identified.",
    "KeyPoints detection techniques allow for the pinpointing of <class> in the image.",
    "In this image, the keypoints clearly show where the <class> is located.",
    "The image, when scanned for keypoints, reveals the specific location of <class>.",
    "By examining the keypoints, the <class> position in the image becomes evident.",
    "The location of <class> can be determined by analyzing the keypoints in this picture.",
    "KeyPoints detection in the image helps to accurately spot the <class>.",
]

GEN_ANSWER = "[GEN]" + "[EMB]"
EDIT_ANSWER = "[EDIT]" + "[EMB]"


def gen_answer_tokens(num_embs_gen: int) -> str:
    """[GEN] followed by num_embs_gen repeated [EMB] (text2img.py:113 —
    gen/edit repeat the same [EMB] token, unlike perception)."""
    return "[GEN]" + "[EMB]" * num_embs_gen


def edit_answer_tokens(num_embs_gen: int) -> str:
    return "[EDIT]" + "[EMB]" * num_embs_gen
