"""IC/VQA dataset factories: a copy of bdm_db1_tpu/data/vit_dataset.py.

Counterpart of reference src/data/vit_dataset.py:99-172
(``get_ic_coco_dataset`` / ``get_vqa_v2_dataset``): builds the transform
stacks and computes the text budget ``n_position - vision_seq_length + 1``,
then wires RandomCOCO/CocoVQA into the packed sample datasets. Also
registers the ``ic`` and ``vqa`` creators for the mixture factory
(--data-path "w <root>:<ann>[:<ques>] ic|vqa"). Importing it needs no
PIL: the transforms import it when they open or change an image.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from bdm_db1_tpu_torch.data.coco import ICDataset, RandomCOCO, ic_caption_budget
from bdm_db1_tpu_torch.data.transforms import ClassificationTransform
from bdm_db1_tpu_torch.data.vqa import CocoVQA, VQADataset


def get_ic_coco_dataset(
    root: str,
    ann_file: str,
    *,
    n_position: int = 1024,
    image_size: int = 224,
    patch_size: int = 16,
    eos_token_id: int = 0,
    train: bool = True,
) -> ICDataset:
    budget = ic_caption_budget(n_position, image_size, patch_size)
    transform = ClassificationTransform(image_size=image_size, train=train)
    coco = RandomCOCO(root, ann_file, transform=transform,
                      seq_length=budget)
    return ICDataset(coco, eos_token_id=eos_token_id, n_position=n_position)


def get_vqa_v2_dataset(
    root: str,
    ann_file: str,
    ques_file: str,
    *,
    n_position: int = 1024,
    image_size: int = 224,
    patch_size: int = 16,
    eos_token_id: int = 0,
    train: bool = True,
) -> VQADataset:
    budget = ic_caption_budget(n_position, image_size, patch_size)
    transform = ClassificationTransform(image_size=image_size, train=train)
    vqa = CocoVQA(root, ann_file, ques_file, transform=transform,
                  seq_length=budget)
    return VQADataset(vqa, eos_token_id=eos_token_id, n_position=n_position)


def _split_spec(prefix: str) -> Tuple[str, ...]:
    return tuple(prefix.split(":"))


def make_ic_creator(*, n_position: int, image_size: int = 224,
                    patch_size: int = 16, eos_token_id: int = 0):
    """Factory creator for type 'ic': prefix = "<img_root>:<ann_json>".
    The reference uses the train set with fake valid/test splits
    (reference: dataset_utils.py:170-173)."""

    def creator(prefix, splits_string, seq_length, num_samples, seed, **_):
        root, ann = _split_spec(prefix)
        ds = get_ic_coco_dataset(
            root, ann, n_position=n_position, image_size=image_size,
            patch_size=patch_size, eos_token_id=eos_token_id, train=True)
        eval_ds = get_ic_coco_dataset(
            root, ann, n_position=n_position, image_size=image_size,
            patch_size=patch_size, eos_token_id=eos_token_id, train=False)
        return ds, eval_ds, eval_ds

    return creator


def make_vqa_creator(*, n_position: int, image_size: int = 224,
                     patch_size: int = 16, eos_token_id: int = 0):
    """Factory creator for type 'vqa':
    prefix = "<img_root>:<ann_json>:<ques_json>"."""

    def creator(prefix, splits_string, seq_length, num_samples, seed, **_):
        root, ann, ques = _split_spec(prefix)
        ds = get_vqa_v2_dataset(
            root, ann, ques, n_position=n_position, image_size=image_size,
            patch_size=patch_size, eos_token_id=eos_token_id, train=True)
        eval_ds = get_vqa_v2_dataset(
            root, ann, ques, n_position=n_position, image_size=image_size,
            patch_size=patch_size, eos_token_id=eos_token_id, train=False)
        return ds, eval_ds, eval_ds

    return creator
