"""Dataset registry: name -> spec database (a copy of
``merlin_tpu/data/registry.py``; the port keeps its own module-level
registry, so a name registered in one package is unknown to the other).

A typed registry with a ``register``/``get_spec`` API, the four reference
families (conversation, interleave JSON, pair/pair-token/interpair tar
shards, interleave tar shards), the dataset names the reference's launch
recipes use, and path roots under ``$MERLIN_DATA_ROOT``. The ``det_*`` and
``track_*`` shard sets are registered both as pair and as interpair sets:
the recipes read them through ``--interpair_datasets``.

Spec schemas (reference parity):
  conversation:  {images, annotations, frequency[, merge_round]}
  interleave(json): {images, annotations, frequency, use_eos_for_each_turn}
  pair/pair_token/interpair (webdata): {path (glob or list), size, merge_round}
  interleave_webdata: {path, size}
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from typing import Dict, List, Optional, Sequence, Union


def data_root() -> str:
    return os.environ.get("MERLIN_DATA_ROOT", "/data/merlin")


@dataclasses.dataclass
class ConversationSpec:
    annotations: str
    images: str = ""
    frequency: float = 1.0
    merge_round: int = 0  # 0 = no round merging


@dataclasses.dataclass
class InterleaveJsonSpec:
    annotations: str
    images: str = ""
    frequency: float = 1.0
    use_eos_for_each_turn: bool = True


@dataclasses.dataclass
class WebdataSpec:
    path: Union[str, List[str]]  # shard glob or explicit shard list
    size: int
    merge_round: int = 1

    def shard_list(self) -> List[str]:
        """Expand the glob / return the explicit list of shard paths.
        s3:// expands through the credentialed storage adapter
        (boto3-or-fsspec, reference base_dataset.py:33-35 semantics);
        other remote schemes through fsspec."""
        if isinstance(self.path, str):
            if self.path.startswith("s3://") \
                    and any(c in self.path for c in "*?["):
                from merlin_tpu_torch.data.storage import list_keys

                return list_keys(self.path)
            if "://" in self.path and any(c in self.path for c in "*?["):
                import fsspec

                fs, _ = fsspec.core.url_to_fs(self.path)
                proto = self.path.split("://", 1)[0]
                return sorted(f"{proto}://{p}" for p in fs.glob(self.path))
            if any(c in self.path for c in "*?["):
                return sorted(_glob.glob(self.path))
            return [self.path]
        return list(self.path)


# family name -> {dataset name -> spec}
_REGISTRY: Dict[str, Dict[str, object]] = {
    "conversation": {},
    "interleave_json": {},
    "pair": {},
    "pair_token": {},
    "interpair": {},
    "interleave": {},
}

FAMILIES = tuple(_REGISTRY)


def register(family: str, name: str, spec) -> None:
    if family not in _REGISTRY:
        raise KeyError(f"unknown dataset family {family!r}; one of {FAMILIES}")
    _REGISTRY[family][name] = spec


def get_spec(family: str, name: str):
    try:
        return _REGISTRY[family][name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY.get(family, {})))
        raise KeyError(
            f"dataset {name!r} not registered in family {family!r} (known: {known})"
        ) from None


def names(family: str) -> List[str]:
    return sorted(_REGISTRY[family])


def parse_dataset_flag(flag: str) -> List[str]:
    """``"a+b+c"`` -> ``["a","b","c"]`` (reference data/builder.py:27)."""
    return [n for n in flag.split("+") if n]


def _seed_defaults() -> None:
    """Register the dataset names the reference launch recipes use.

    Paths are $MERLIN_DATA_ROOT-relative; users point the env var at their
    own mirror. Sizes/merge_rounds match the reference registry where the
    reference recorded them (constants.py:150-353).
    """
    root = data_root()

    # --- conversation (SFT) ---------------------------------------------
    for name, ann in [
        ("blip_laion_cc_sbu_558k", "annotations/blip_laion_cc_sbu_558k.json"),
        ("llava665k", "LLaVA1.5/llava_v1_5_mix665k.json"),
        ("llava665k_refine", "LLaVA1.5/llava_v1_5_665k_refine.json"),
        ("track_sft", "annotations/mix_sft_track_30k.json"),
        ("track_sft_v1", "annotations/merlin_sft_70k-valid.json"),
        ("track_sft_v2", "annotations/merlin_sft_70k_v2-valid.json"),
        ("track_sft_v3", "annotations/merlin_sft_90k_v3.json"),
        ("track_sft_pretrain_44k", "annotations/mix_sample_pretrain_44k.json"),
        ("track_sft_46k_v3", "annotations/mix_sample_track_sft_46k_v3.json"),
    ]:
        register("conversation", name, ConversationSpec(
            annotations=os.path.join(root, ann), images=os.path.join(root, "images")))

    # --- interleave (json) ----------------------------------------------
    # Full reference INTERLEAVE_DATA transcription (constants.py:76-143):
    # caption sets + interleaved-detection sets.
    for name, images, ann in [
        ("cococaption", "COCO", "annotations/cococap_interleave_38k.json"),
        ("nocaps", "NoCaps-4.5k", "annotations/nocaps_interleave_1.5k.json"),
        ("flickr30k", "Flickr-30k",
         "annotations/flickr30k_interleave_10k.json"),
        ("flickr30k_cn", "Flickr-30k",
         "annotations/flickr30k_cn_interleave_10k.json"),
        ("textcaps", "TextCaps-25k",
         "annotations/textcaps_interleave_7k.json"),
        ("obj365", "Objects365",
         "annotations/objv2_train_interleave_det345k_correct.json"),
        ("obj365_cn", "Objects365",
         "annotations/objv2_train_interleave_det345k_cn_correct.json"),
        ("openimages", "OpenImages/train",
         "annotations/openimages_interleave_det348k.json"),
        ("openimages_cn", "OpenImages/train",
         "annotations/openimages_interleave_det348k_cn.json"),
        ("lvis", "COCO", "annotations/lvis_train_interleave_det20k.json"),
        ("lvis_cn", "COCO",
         "annotations/lvis_train_interleave_det20k_cn.json"),
    ]:
        register("interleave_json", name, InterleaveJsonSpec(
            annotations=os.path.join(root, ann),
            images=os.path.join(root, images)))

    # --- pair webdata (pretrain) ----------------------------------------
    # Full reference PAIR_WEBDATA transcription (constants.py:151-300):
    # every surviving (name, shard set, size, merge_round) entry; shard
    # roots are $MERLIN_DATA_ROOT-relative mirrors of the reference's
    # cluster buckets.
    pair_sets = [
        # Laion 2B series
        ("laion2b_10m", "laion2b-en/*.tar", 10_000_000, 12),
        ("laion2b_10m_6merge", "laion2b-en/*.tar", 10_000_000, 6),
        ("laion2b_20m_6merge", "laion2b-en/*.tar", 20_000_000, 6),
        ("laion2b_5m", "laion2b-en/*.tar", 5_000_000, 12),
        # TAISU 100M series
        ("taisu_100m", "taisu-tarfiles/*/*.tar", 100_000_000, 12),
        ("taisu_20m_6merge", "taisu-tarfiles/*/*.tar", 20_000_000, 6),
        # Laion 400M series
        ("laion400m_100m", "laion400m/*.tar", 100_000_000, 12),
        ("laion400m_70m", "laion400m/*.tar", 70_000_000, 12),
        ("laion400m_50m", "laion400m/*.tar", 50_000_000, 12),
        ("laion400m_10m", "laion400m/*.tar", 10_000_000, 12),
        ("laion400m_5m", "laion400m/*.tar", 5_000_000, 12),
        # Laion chinese 100M series
        ("laion_cn_100m", "laion-cn/*/*.tar", 100_000_000, 12),
        ("laion_cn_70m", "laion-cn/*/*.tar", 70_000_000, 12),
        ("laion_cn_50m", "laion-cn/*/*.tar", 50_000_000, 12),
        ("laion_cn_10m", "laion-cn/*/*.tar", 10_000_000, 12),
        ("laion_cn_10m_6merge", "laion-cn/*/*.tar", 10_000_000, 6),
        ("laion_cn_5m", "laion-cn/*/*.tar", 5_000_000, 12),
        # Synthdog series (OCR)
        ("synthdog_224_10m", "synthdog-224-tarfiles/*/*.tar",
         10_000_000, 12),
        ("synthdog_10m", "synthdog-tarfiles/*/*.tar", 10_000_000, 12),
        ("synthdog_2m_6merge", "synthdog-tarfiles/*/*.tar", 2_000_000, 6),
        # GRIT grounding series
        ("grit_5m", "grit-5m-tarfiles/*.tar", 5_000_000, 12),
        ("grit_5m_6merge", "grit-5m-tarfiles/*.tar", 5_000_000, 6),
        ("grit_2_5m", "grit-5m-tarfiles/*.tar", 2_500_000, 12),
        # Detection series
        ("det_224_5m", "detection-224-tarfiles/*/*.tar", 5_000_000, 8),
        ("det_3m_4merge", "detection-tarfiles/*/*.tar", 3_000_000, 4),
        ("det_224_3m_en", "detection-224-tarfiles/*-en/*.tar",
         3_000_000, 8),
        ("det_3m_en", "detection-tarfiles/*-en/*.tar", 3_000_000, 8),
        ("det_3m_en_4merge", "detection-tarfiles/*-en/*.tar", 3_000_000, 4),
        ("det_5m_v1_en_4merge", "det-tarfiles-v1/*.tar", 5_000_000, 4),
        ("det_1_5m_en", "detection-tarfiles/*-en/*.tar", 1_500_000, 8),
        # Tracking series (multi-frame)
        ("track_224_2m", "track-224-tarfiles/*.tar", 2_000_000, 5),
        ("track_224_1m", "track-224-tarfiles/*.tar", 1_000_000, 5),
        ("track_2m", "track-tarfiles/*.tar", 2_000_000, 5),
        ("track_1m", "track-tarfiles/*.tar", 1_000_000, 5),
        ("track_1m_2merge", "track-tarfiles/*.tar", 1_000_000, 2),
        ("track_1m_v1_2merge", "track-tarfiles-v1/*.tar", 1_000_000, 2),
        ("track_1m_v2_2merge", "track-tarfiles-v2/*.tar", 1_000_000, 2),
    ]
    for name, rel, size, mr in pair_sets:
        spec = WebdataSpec(
            path=os.path.join(root, rel), size=size, merge_round=mr)
        register("pair", name, spec)
        # det_*/track_* shards are multi-frame: the recipes consume them
        # through the interpair family flag (pretrain.sh
        # --interpair_datasets); the spec database is shared, mirroring
        # the reference's single PAIR_WEBDATA dict.
        if name.startswith(("det_", "track_")):
            register("interpair", name, spec)

    # --- pre-tokenized pair webdata --------------------------------------
    register("pair_token", "qa_mix_22set", WebdataSpec(
        path=os.path.join(root, "qa-token-tarfiles/*.tar"),
        size=10_000_000, merge_round=6))

    # --- interleave webdata (MMC4/OBELICS style) --------------------------
    register("interleave", "oblisc_1m", WebdataSpec(
        path=os.path.join(root, "oblisc-tarfiles/*.tar"), size=1_000_000,
        merge_round=1))


_seed_defaults()
