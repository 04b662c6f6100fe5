"""paddle.vision (paddle_tpu/vision/__init__.py): the datasets, LeNet and
the ResNet family, and the image-backend functions. ``transforms`` is
ROADMAP.md's queue 1, item 10e."""
from . import datasets, models
from .models import (LeNet, ResNet, resnet18, resnet34, resnet50, resnet101,
                     resnet152)


def set_image_backend(backend):
    return None


def get_image_backend():
    return "numpy"


def image_load(path, backend=None):
    """reference vision/image.py image_load: read an image file. Uses PIL
    when available, else a raw-numpy fallback for .npy; returns HWC
    uint8 numpy (the 'cv2-like' array backend — PIL objects only when the
    pil backend is explicitly requested and PIL is installed)."""
    if backend in (None, "pil", "cv2", "numpy"):
        try:
            from PIL import Image

            img = Image.open(path)
            if backend == "pil":
                return img
            import numpy as _np

            return _np.asarray(img)
        except ImportError:
            pass
    import numpy as _np

    if str(path).endswith(".npy"):
        return _np.load(path)
    raise RuntimeError(
        "image_load: PIL is unavailable and the file is not .npy")
