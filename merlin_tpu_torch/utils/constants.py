"""Model constants the port uses (a copy of the needed part of
``merlin_tpu/utils/constants.py``)."""

IGNORE_INDEX = -100

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IM_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
