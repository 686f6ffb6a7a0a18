"""Vision preprocessing pipelines (PIL/numpy, torchvision-free): a copy of
bdm_db1_tpu/data/transforms.py.

Counterpart of the reference's transform stacks
(reference: src/data/vit_dataset.py:31-96 ClassificationTransform): train =
RandomResizedCrop + horizontal flip + ColorJitter/AutoAugment + normalize;
eval = resize + center crop + normalize. Outputs CHW float32 (the dataset
layer stores CHW like the reference; batches convert to NHWC).

PIL is imported inside the functions that open or change an image, never
at module import, so the data layer imports where Pillow is not installed
(the inline-pixel datasets never call these). The python ``random`` draws
are the JAX package's, in its order.
"""

from __future__ import annotations

import random

import numpy as np

from bdm_db1_tpu_torch.data.autoaugment import ImageNetPolicy

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def to_chw_float(img, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    arr = (arr - mean) / std
    return np.transpose(arr, (2, 0, 1))


def random_resized_crop(img, size: int, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)):
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target = random.uniform(*scale) * area
        log_r = (np.log(ratio[0]), np.log(ratio[1]))
        ar = np.exp(random.uniform(*log_r))
        cw = int(round((target * ar) ** 0.5))
        ch = int(round((target / ar) ** 0.5))
        if 0 < cw <= w and 0 < ch <= h:
            x = random.randint(0, w - cw)
            y = random.randint(0, h - ch)
            return img.crop((x, y, x + cw, y + ch)).resize(
                (size, size), Image.BICUBIC)
    return center_crop(img.resize((size, size), Image.BICUBIC), size)


def center_crop(img, size: int):
    from PIL import Image

    w, h = img.size
    scale = size / min(w, h)
    img = img.resize((max(size, int(round(w * scale))),
                      max(size, int(round(h * scale)))), Image.BICUBIC)
    w, h = img.size
    x = (w - size) // 2
    y = (h - size) // 2
    return img.crop((x, y, x + size, y + size))


def color_jitter(img, brightness=0.4, contrast=0.4, saturation=0.4):
    from PIL import ImageEnhance

    for enh, amount in ((ImageEnhance.Brightness, brightness),
                        (ImageEnhance.Contrast, contrast),
                        (ImageEnhance.Color, saturation)):
        if amount > 0:
            img = enh(img).enhance(1 + random.uniform(-amount, amount))
    return img


class ClassificationTransform:
    """Train/eval image pipeline (a PIL image) -> CHW float32."""

    def __init__(self, image_size: int = 224, train: bool = True,
                 use_autoaugment: bool = True, use_color_jitter: bool = False):
        self.image_size = image_size
        self.train = train
        self.autoaugment = ImageNetPolicy() if use_autoaugment else None
        self.use_color_jitter = use_color_jitter

    def __call__(self, img) -> np.ndarray:
        if self.train:
            from PIL import Image

            img = random_resized_crop(img, self.image_size)
            if random.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if self.use_color_jitter:
                img = color_jitter(img)
            if self.autoaugment is not None:
                img = self.autoaugment(img)
        else:
            img = center_crop(img, self.image_size)
        return to_chw_float(img)
