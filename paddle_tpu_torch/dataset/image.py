"""dataset.image (reference python/paddle/dataset/image.py): host-side
image helpers.  The reference shells into cv2; this build uses
PIL+numpy (HWC uint8 arrays in, same semantics out)."""

import io
import tarfile

import numpy as np

__all__ = ["load_image", "load_image_bytes", "resize_short", "to_chw",
           "center_crop", "random_crop", "left_right_flip",
           "simple_transform", "load_and_transform",
           "batch_images_from_tar"]


def _to_array(img, is_color):
    arr = np.asarray(img.convert("RGB" if is_color else "L"))
    return arr


def load_image_bytes(data, is_color=True):
    from PIL import Image

    return _to_array(Image.open(io.BytesIO(data)), is_color)


def load_image(file, is_color=True):
    from PIL import Image

    return _to_array(Image.open(file), is_color)


def resize_short(im, size):
    """Scale so the SHORTER edge becomes `size` (reference
    image.py:197)."""
    from PIL import Image

    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    return np.asarray(Image.fromarray(im).resize((w_new, h_new)))


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0, w0 = (h - size) // 2, (w - size) // 2
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, h - size + 1)
    w0 = np.random.randint(0, w - size + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1] if not is_color or im.ndim == 2 \
        else im[:, ::-1, :]


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    """resize_short -> crop (random+flip when training, center
    otherwise) -> CHW float32 -> optional mean subtraction (reference
    image.py:327)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.array(mean, dtype="float32")
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pickle-batch images from a tar (reference image.py:80): writes
    `batch-N` pickle files of {'data': [arrays], 'label': [labels]}
    next to the tar and a meta file listing them."""
    import os
    import pickle

    out_path = f"{data_file}_{dataset_name}_batch"
    os.makedirs(out_path, exist_ok=True)
    data, labels, written = [], [], []
    with tarfile.open(data_file) as tf:
        for m in tf.getmembers():
            if m.name not in img2label:
                continue
            data.append(load_image_bytes(tf.extractfile(m).read()))
            labels.append(img2label[m.name])
            if len(data) == num_per_batch:
                fn = os.path.join(out_path, f"batch-{len(written):05d}")
                with open(fn, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f)
                written.append(fn)
                data, labels = [], []
    if data:
        fn = os.path.join(out_path, f"batch-{len(written):05d}")
        with open(fn, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f)
        written.append(fn)
    with open(os.path.join(out_path, "meta"), "w") as f:
        f.write("\n".join(written))
    return out_path
