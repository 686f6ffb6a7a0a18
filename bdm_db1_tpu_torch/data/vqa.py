"""VQA v2 dataset + annotation API: a copy of bdm_db1_tpu/data/vqa.py.

Counterpart of the reference's vendored VQA tooling
(reference: src/data/vqa_dataset.py:33-322): a question/annotation index
with the standard API surface (getQuesIds/getImgIds/loadQA/loadRes), the
CocoVQA dataset building packed samples

    question tokens = prompt_items[1] + question + prompt_items[2]
    sequence        = [prompt | vision patches | (ques + ans)[:-1]]
    labels          = right-aligned answer; loss over the answer region

(reference: vqa_dataset.py CocoVQA + coco_token_dataset.py:155-210), and the
sample adapter for the collation layer. Inline ``"pixels"`` images are
read without PIL; PIL is imported only to open an image file.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Optional

import numpy as np


class VQA:
    """VQA v2 annotation index (getQuesIds/getImgIds/loadQA/loadRes)."""

    def __init__(self, annotation_file: Optional[str] = None,
                 question_file: Optional[str] = None):
        self.dataset: Dict = {}
        self.questions: Dict = {}
        self.qa: Dict[int, Dict] = {}
        self.qqa: Dict[int, Dict] = {}
        self.img_to_qa: Dict[int, List] = {}
        if annotation_file is not None and question_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            with open(question_file) as f:
                self.questions = json.load(f)
            self.create_index()

    def create_index(self) -> None:
        for ann in self.dataset.get("annotations", []):
            self.img_to_qa.setdefault(ann["image_id"], []).append(ann)
            self.qa[ann["question_id"]] = ann
        for q in self.questions.get("questions", []):
            self.qqa[q["question_id"]] = q

    def get_ques_ids(self, img_ids=None, ques_types=None, ans_types=None
                     ) -> List[int]:
        anns = list(self.qa.values())
        if img_ids is not None:
            img_ids = set(np.atleast_1d(img_ids).tolist())
            anns = [a for a in anns if a["image_id"] in img_ids]
        if ques_types is not None:
            qt = set(np.atleast_1d(ques_types).tolist())
            anns = [a for a in anns if a.get("question_type") in qt]
        if ans_types is not None:
            at = set(np.atleast_1d(ans_types).tolist())
            anns = [a for a in anns if a.get("answer_type") in at]
        return [a["question_id"] for a in anns]

    # camelCase aliases mirroring the reference API surface
    getQuesIds = get_ques_ids

    def get_img_ids(self, ques_ids=None) -> List[int]:
        if ques_ids is None:
            return sorted(self.img_to_qa.keys())
        return [self.qa[q]["image_id"] for q in np.atleast_1d(ques_ids)]

    getImgIds = get_img_ids

    def load_qa(self, ids) -> List[Dict]:
        return [self.qa[int(i)] for i in np.atleast_1d(ids)]

    loadQA = load_qa

    def load_res(self, res_file: str) -> "VQA":
        """Load a result file as a VQA object sharing our question index
        (reference: vqa_dataset.py loadRes)."""
        res = VQA()
        res.questions = self.questions
        with open(res_file) as f:
            anns = json.load(f)
        assert isinstance(anns, list)
        for ann in anns:
            qid = ann["question_id"]
            src = self.qa[qid]
            ann.setdefault("image_id", src["image_id"])
            ann.setdefault("question_type", src.get("question_type"))
            ann.setdefault("answer_type", src.get("answer_type"))
        res.dataset = {"annotations": anns}
        res.create_index()
        return res

    loadRes = load_res


class CocoVQA:
    """Image + packed question/answer token sample
    (reference: vqa_dataset.py CocoVQA)."""

    def __init__(self, root: str, ann_file: str, ques_file: str,
                 transform=None, seq_length: Optional[int] = None):
        self.root = root
        self.vqa = VQA(ann_file, ques_file)
        self.transform = transform
        prompt_items = self.vqa.dataset["prompt_items"]
        self.prompt = list(prompt_items[0])
        self.ques_prefix = list(prompt_items[1])
        self.ques_suffix = list(prompt_items[2])
        self.seq_length = seq_length - len(self.prompt)
        self.ques_ids = sorted(self.vqa.qa.keys())
        # images: id -> info (file_name or inline pixels)
        self.imgs = {im["id"]: im
                     for im in self.vqa.dataset.get("images", [])}

    def __len__(self) -> int:
        return len(self.ques_ids)

    def _load_image(self, img_id: int) -> np.ndarray:
        info = self.imgs[img_id]
        if "pixels" in info:
            return np.asarray(info["pixels"], dtype=np.float32)
        from PIL import Image

        img = Image.open(os.path.join(self.root, info["file_name"]))
        if self.transform is not None:
            return self.transform(img)
        return np.transpose(
            np.asarray(img.convert("RGB"), np.float32) / 255.0, (2, 0, 1))

    def __getitem__(self, index: int) -> Dict:
        qid = self.ques_ids[index]
        ann = self.vqa.qa[qid]
        qq = self.vqa.qqa[qid]
        ques = (list(self.ques_prefix) + list(qq["question_tokens"])
                + list(self.ques_suffix))
        answers = ann.get("answer_tokens") or [ann["answers"][0]["answer"]]
        ans = list(random.choice(answers)) if isinstance(
            answers[0], (list, tuple)) else list(answers)
        # pad the answer region to the remaining budget
        budget = self.seq_length - len(ques)
        ans = ans[:budget] + [0] * max(0, budget - len(ans))
        return {
            "img": self._load_image(ann["image_id"]),
            "ques": np.asarray(ques, np.int32),
            "ans": np.asarray(ans, np.int32),
            "ques_id": qid,
            "img_id": ann["image_id"],
            "prompt": np.asarray(self.prompt, np.int32),
            "ques_len": len(ques),
        }


def vqa_loss_mask(ans: np.ndarray, eos_token_id: int, n_position: int
                  ) -> np.ndarray:
    """(reference: coco_token_dataset.py:85-101)."""
    seq = len(ans)
    loss_mask = np.zeros((n_position,), np.float32)
    tail = np.ones((seq,), np.float32)
    tail[np.asarray(ans) == eos_token_id] = 0.0
    loss_mask[-seq + 1:] = tail[:-1]
    loss_mask[-seq] = 1.0
    return loss_mask


class VQADataset:
    """CocoVQA items -> packed samples (reference:
    coco_token_dataset.py:155-210)."""

    def __init__(self, dataset: CocoVQA, eos_token_id: int, n_position: int):
        self.dataset = dataset
        self.eos_token_id = eos_token_id
        self.n_position = n_position

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        d = self.dataset[index]
        ques, ans = d["ques"], d["ans"]
        tokens = np.concatenate([ques, ans])[:-1].astype(np.int32)
        labels = np.zeros((self.n_position,), np.int32)
        labels[-len(ans):] = ans
        loss_mask = vqa_loss_mask(ans, self.eos_token_id, self.n_position)
        return {
            "prompt": d["prompt"].astype(np.int32),
            "images": np.transpose(d["img"], (1, 2, 0)).astype(np.float32),
            "text": tokens,
            "ques_len": np.asarray(d["ques_len"], np.int32),
            "loss_mask": loss_mask,
            "label": labels,
            "ques_id": np.asarray(d["ques_id"], np.int64),
            "img_id": np.asarray(d["img_id"], np.int64),
            "modality": "vqa",
        }
