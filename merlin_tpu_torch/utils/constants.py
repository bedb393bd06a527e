"""Model and serving constants (a copy of ``merlin_tpu/utils/constants.py``).
"""

# serving heartbeats
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15
LOGDIR = "log"

IGNORE_INDEX = -100

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"

DEFAULT_BOX_TOKEN = "<box>"
DEFAULT_BOX_START_TOKEN = "<box_start>"
DEFAULT_BOX_END_TOKEN = "<box_end>"

DEFAULT_PAD_TOKEN = "[PAD]"
DEFAULT_EOS_TOKEN = "</s>"
DEFAULT_BOS_TOKEN = "</s>"
DEFAULT_UNK_TOKEN = "<unk>"

# Number of vision-patch tokens a single image expands to in text.
# CLIP ViT-L/14 @ 448 with a stride-2 conv projector: (448/14/2)^2 = 256.
DEFAULT_IMAGE_PATCH_LEN = 256


def image_placeholder(num_patches: int = DEFAULT_IMAGE_PATCH_LEN,
                      use_start_end: bool = True) -> str:
    """The literal text one image becomes before tokenization:
    ``<im_start><im_patch>*N<im_end>`` when ``use_start_end``, else bare
    patches."""
    patches = DEFAULT_IM_PATCH_TOKEN * num_patches
    if use_start_end:
        return DEFAULT_IM_START_TOKEN + patches + DEFAULT_IM_END_TOKEN
    return patches
