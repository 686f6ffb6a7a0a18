"""MS-COCO image-captioning dataset (pre-tokenized captions): a copy of
bdm_db1_tpu/data/coco.py.

Counterpart of the reference IC pipeline
(reference: src/data/coco_token_dataset.py:25-152, src/data/vit_dataset.py:99-139)
without the torchvision dependency: a small COCO-caption index over the same
pre-tokenized annotation json (which carries a ``prompt_items`` key with the
tokenized "describe this image:"-style prompt), PIL image loading through
the port's transform stack (data/transforms.py), and the packed-layout math:

    sequence  = [prompt | vision patches | caption[:-1]]  (= n_position)
    labels    = right-aligned caption (one slot earlier: the last patch
                predicts the first word)
    loss_mask = 1 over the caption tail, 0 at eod padding

``ic_seq_length = n_position - vision_seq_length + 1`` tokens of caption
budget (reference: vit_dataset.py:116-121). An image entry with inline
``"pixels"`` (CHW floats) is read without PIL; PIL is imported only to
open an image file.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np


class CocoCaptionIndex:
    """Minimal COCO caption annotation index (replaces pycocotools for our
    needs): image id -> file name + caption list."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            self.dataset = json.load(f)
        self.imgs = {im["id"]: im for im in self.dataset.get("images", [])}
        self.img_to_anns: Dict[int, List] = {}
        for ann in self.dataset.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)
        self.ids = sorted(self.img_to_anns.keys())


class RandomCOCO:
    """Per-item: image + one randomly picked pre-tokenized caption, padded
    to the caption budget (reference: coco_token_dataset.py:25-55)."""

    def __init__(self, root: str, ann_file: str, transform=None,
                 seq_length: Optional[int] = None):
        self.root = root
        self.coco = CocoCaptionIndex(ann_file)
        self.transform = transform
        prompt_items = self.coco.dataset["prompt_items"]
        self.prompt = list(prompt_items[0])
        self.seq_length = seq_length - len(self.prompt)
        self.ids = self.coco.ids

    def __len__(self) -> int:
        return len(self.ids)

    def _load_image(self, img_id: int) -> np.ndarray:
        info = self.coco.imgs[img_id]
        if "pixels" in info:  # inline test fixture
            return np.asarray(info["pixels"], dtype=np.float32)
        from PIL import Image

        img = Image.open(os.path.join(self.root, info["file_name"]))
        if self.transform is not None:
            return self.transform(img)
        return np.transpose(
            np.asarray(img.convert("RGB"), np.float32) / 255.0, (2, 0, 1))

    def __getitem__(self, index: int) -> Dict:
        img_id = self.ids[index]
        anns = self.coco.img_to_anns[img_id]
        caption = list(random.choice(anns)["caption"])
        caption = caption[: self.seq_length]
        caption = caption + [0] * (self.seq_length - len(caption))
        return {
            "img": self._load_image(img_id),  # CHW float
            "text": np.asarray(caption, np.int32),
            "prompt": np.asarray(self.prompt, np.int32),
            "img_id": img_id,
        }


def ic_loss_mask_and_labels(caption: np.ndarray, eos_token_id: int,
                            n_position: int):
    """Right-aligned labels + text-tail loss mask
    (reference: coco_token_dataset.py:58-82, 118-137)."""
    tokens = caption[:-1]
    seq = tokens.shape[0]
    loss_mask = np.zeros((n_position,), np.float32)
    tail = np.ones(seq, np.float32)
    tail[tokens == eos_token_id] = 0.0
    loss_mask[-seq:] = tail
    loss_mask[-seq - 1] = 1.0
    labels = np.zeros((n_position,), np.int32)
    labels[n_position - seq - 1:] = caption
    return tokens, loss_mask, labels


class ICDataset:
    """RandomCOCO items -> packed IC samples (numpy dicts for collation)."""

    def __init__(self, dataset: RandomCOCO, eos_token_id: int,
                 n_position: int):
        self.dataset = dataset
        self.eos_token_id = eos_token_id
        self.n_position = n_position

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        d = self.dataset[index]
        tokens, loss_mask, labels = ic_loss_mask_and_labels(
            np.asarray(d["text"], np.int32), self.eos_token_id,
            self.n_position)
        return {
            "prompt": d["prompt"].astype(np.int32),
            "images": np.transpose(d["img"], (1, 2, 0)).astype(np.float32),
            "text": tokens.astype(np.int32),
            "loss_mask": loss_mask,
            "label": labels,
            "img_id": np.asarray(d["img_id"], np.int64),
            "modality": "ic",
        }


def ic_caption_budget(n_position: int, image_size: int,
                      patch_size: int) -> int:
    """seq_length handed to RandomCOCO
    (reference: vit_dataset.py:116-121)."""
    vision_seq = (image_size // patch_size) ** 2
    return n_position - vision_seq + 1
