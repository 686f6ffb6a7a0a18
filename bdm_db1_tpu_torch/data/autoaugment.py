"""AutoAugment ImageNet policy (PIL), table-driven: a copy of
bdm_db1_tpu/data/autoaugment.py.

Counterpart of the reference's vendored AutoAugment
(reference: src/data/autoaugment.py:34-299): the standard 25-sub-policy
ImageNet schedule from AutoAugment (Cubuk et al., 2019), each sub-policy two
(op, probability, magnitude-index) stages, as a compact op table over
PIL/ImageOps. PIL is imported when an op runs, never at module import; the
python ``random`` draws are the JAX package's, in its order.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

_FILL = (128, 128, 128)


def _affine(img, coeffs):
    from PIL import Image

    return img.transform(img.size, Image.AFFINE, coeffs, fillcolor=_FILL)


def _shear_x(img, mag):
    return _affine(img, (1, mag * random.choice([-1, 1]), 0, 0, 1, 0))


def _shear_y(img, mag):
    return _affine(img, (1, 0, 0, mag * random.choice([-1, 1]), 1, 0))


def _translate_x(img, mag):
    return _affine(
        img, (1, 0, mag * img.size[0] * random.choice([-1, 1]), 0, 1, 0))


def _translate_y(img, mag):
    return _affine(
        img, (1, 0, 0, 0, 1, mag * img.size[1] * random.choice([-1, 1])))


def _rotate(img, mag):
    from PIL import Image

    # rotate with gray fill, preserving size
    rot = img.convert("RGBA").rotate(mag * random.choice([-1, 1]))
    return Image.composite(
        rot, Image.new("RGBA", rot.size, _FILL + (255,)), rot).convert(
        img.mode)


def _enhance(name: str):
    """An ``ImageEnhance.<name>`` op, looked up when it runs."""
    def op(img, mag):
        from PIL import ImageEnhance

        return getattr(ImageEnhance, name)(img).enhance(
            1 + mag * random.choice([-1, 1]))

    return op


def _image_op(name: str, *arg_of_mag):
    """An ``ImageOps.<name>`` op; with ``arg_of_mag`` its one argument is
    that function of the magnitude."""
    def op(img, mag):
        from PIL import ImageOps

        args = [f(mag) for f in arg_of_mag]
        return getattr(ImageOps, name)(img, *args)

    return op


_OPS = {
    "shearX": (_shear_x, np.linspace(0, 0.3, 10)),
    "shearY": (_shear_y, np.linspace(0, 0.3, 10)),
    "translateX": (_translate_x, np.linspace(0, 150 / 331, 10)),
    "translateY": (_translate_y, np.linspace(0, 150 / 331, 10)),
    "rotate": (_rotate, np.linspace(0, 30, 10)),
    "color": (_enhance("Color"), np.linspace(0.0, 0.9, 10)),
    "posterize": (_image_op("posterize", int),
                  np.round(np.linspace(8, 4, 10), 0)),
    "solarize": (_image_op("solarize", lambda m: m),
                 np.linspace(256, 0, 10)),
    "contrast": (_enhance("Contrast"), np.linspace(0.0, 0.9, 10)),
    "sharpness": (_enhance("Sharpness"), np.linspace(0.0, 0.9, 10)),
    "brightness": (_enhance("Brightness"), np.linspace(0.0, 0.9, 10)),
    "autocontrast": (_image_op("autocontrast"), np.zeros(10)),
    "equalize": (_image_op("equalize"), np.zeros(10)),
    "invert": (_image_op("invert"), np.zeros(10)),
}

# (op1, p1, idx1, op2, p2, idx2) x 25 — the published ImageNet policy
_IMAGENET_POLICY: Tuple = (
    ("posterize", 0.4, 8, "rotate", 0.6, 9),
    ("solarize", 0.6, 5, "autocontrast", 0.6, 5),
    ("equalize", 0.8, 8, "equalize", 0.6, 3),
    ("posterize", 0.6, 7, "posterize", 0.6, 6),
    ("equalize", 0.4, 7, "solarize", 0.2, 4),
    ("equalize", 0.4, 4, "rotate", 0.8, 8),
    ("solarize", 0.6, 3, "equalize", 0.6, 7),
    ("posterize", 0.8, 5, "equalize", 1.0, 2),
    ("rotate", 0.2, 3, "solarize", 0.6, 8),
    ("equalize", 0.6, 8, "posterize", 0.4, 6),
    ("rotate", 0.8, 8, "color", 0.4, 0),
    ("rotate", 0.4, 9, "equalize", 0.6, 2),
    ("equalize", 0.0, 7, "equalize", 0.8, 8),
    ("invert", 0.6, 4, "equalize", 1.0, 8),
    ("color", 0.6, 4, "contrast", 1.0, 8),
    ("rotate", 0.8, 8, "color", 1.0, 2),
    ("color", 0.8, 8, "solarize", 0.8, 7),
    ("sharpness", 0.4, 7, "invert", 0.6, 8),
    ("shearX", 0.6, 5, "equalize", 1.0, 9),
    ("color", 0.4, 0, "equalize", 0.6, 3),
    ("equalize", 0.4, 7, "solarize", 0.2, 4),
    ("solarize", 0.6, 5, "autocontrast", 0.6, 5),
    ("invert", 0.6, 4, "equalize", 1.0, 8),
    ("color", 0.6, 4, "contrast", 1.0, 8),
    ("equalize", 0.8, 8, "equalize", 0.6, 3),
)


class ImageNetPolicy:
    """Randomly applies one of the 25 ImageNet sub-policies per call."""

    def __call__(self, img):
        op1, p1, i1, op2, p2, i2 = random.choice(_IMAGENET_POLICY)
        for name, p, idx in ((op1, p1, i1), (op2, p2, i2)):
            if random.random() < p:
                fn, mags = _OPS[name]
                img = fn(img, mags[idx])
        return img

    def __repr__(self):
        return "AutoAugment ImageNet Policy"
