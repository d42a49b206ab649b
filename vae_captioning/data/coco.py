"""MS-COCO caption corpus loading.

Replaces the reference's ``Captions`` class (``utils/captions.py:5-63``):
parses ``captions_*2014.json``, tokenizes every annotation, and keeps a
``file_name -> [token-id list]`` mapping plus filename<->image-id maps.

The reference's ``max_length`` clip is dead code (it tests ``len()`` of the
annotation *dict*, ``utils/captions.py:32-34``); here caption clipping is
implemented for real against ``cap_max_length`` — COCO captions are far
shorter than the default 100 so behaviour is identical on real data.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

from vae_captioning.data.tokenizer import tokenize_caption
from vae_captioning.data.vocabulary import Vocabulary


class CocoCaptions:
    """Tokenized captions for one COCO split."""

    def __init__(self, captions_json: str, max_length: int = 100):
        self.path = captions_json
        self.max_length = max_length
        # file_name -> list of token lists (later: token-id lists)
        self.captions: Dict[str, List[List[str]]] = defaultdict(list)
        self.captions_indexed: Dict[str, List[List[int]]] = {}
        self._fn_to_id: Dict[str, int] = {}
        self._id_to_fn: Dict[int, str] = {}
        self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            j = json.load(f)
        self._id_to_fn = {img["id"]: img["file_name"] for img in j["images"]}
        self._fn_to_id = {img["file_name"]: img["id"] for img in j["images"]}
        for ann in j.get("annotations", []):
            tokens = tokenize_caption(ann["caption"])
            if len(tokens) > self.max_length:
                tokens = tokens[: self.max_length]
            self.captions[self._id_to_fn[ann["image_id"]]].append(tokens)

    @property
    def num_images(self) -> int:
        return len(self.captions)

    @property
    def filename_to_imid(self) -> Dict[str, int]:
        return self._fn_to_id

    @property
    def imid_to_filename(self) -> Dict[int, str]:
        return self._id_to_fn

    def index_captions(self, vocab: Vocabulary) -> None:
        """Map tokens to ids with <UNK> fallback (ref utils/captions.py:43-60)."""
        self.captions_indexed = {
            fn: [vocab.encode(cap) for cap in caps]
            for fn, caps in self.captions.items()
        }

    def all_tokenized(self):
        for caps in self.captions.values():
            yield from caps


def load_test_image_ids(image_info_json: str) -> Dict[str, int]:
    """filename -> image_id for a captionless split
    (ref utils/batch_gen.py:207-213)."""
    with open(image_info_json) as f:
        j = json.load(f)
    return {img["file_name"]: img["id"] for img in j["images"]}


def coco_paths(coco_dir: str) -> Dict[str, str]:
    """Resolve the reference's COCO directory layout (ref utils/data.py:22-28)."""
    return {
        "train_cap_json": os.path.join(coco_dir, "annotations/captions_train2014.json"),
        "valid_cap_json": os.path.join(coco_dir, "annotations/captions_val2014.json"),
        "test_info_json": os.path.join(coco_dir, "annotations/image_info_test2014.json"),
        "train_instances_json": os.path.join(coco_dir, "annotations/instances_train2014.json"),
        "valid_instances_json": os.path.join(coco_dir, "annotations/instances_val2014.json"),
        "train_dir": os.path.join(coco_dir, "images/train2014/"),
        "valid_dir": os.path.join(coco_dir, "images/val2014/"),
        "test_dir": os.path.join(coco_dir, "images/test2014/"),
    }
