"""Write the synthetic smoke data set that the CLIs run on (the port's
counterpart of the repo's `tools/make_smoke_data.py`).

    python -m poco_tpu_torch.cli.make_smoke_data [--n 16] [--root data]

Writes `<root>/dataset_extras/smoke_{train,test}.npz` (the reference npz
schema, pocolib/dataset/base_dataset.py:52-149: imgname, center, scale,
pose, shape, S, part, openpose, gender) and their JPEGs under
`<root>/dataset_folders/smoke/`, so that `cli.train` and `cli.eval` run
on configs/tiny_smoke.yaml with no assets. The same seeds draw the same
arrays as the JAX tool; each image is uniform noise with a filled
radius-60 disc, drawn as `cv2.circle` draws it
(`runtime/raster.circles_filled`), and written as JPEG (quality 95,
4:2:0) with the pixels that the JAX tool's `cv2.imwrite` puts on disk: it
reads the array as BGR, so the file's RGB is the array reversed. Runs on
the host only: nothing here touches a device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..runtime.image_write import write_image
from ..runtime.raster import circles_filled

IMG = 256


def make_split(root: str, split: str, n: int, seed: int) -> str:
    """Write `<root>/dataset_extras/smoke_<split>.npz` and its `n` JPEGs;
    returns the npz path."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "dataset_folders", "smoke")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "dataset_extras"), exist_ok=True)

    imgnames = []
    for i in range(n):
        name = f"{split}_{i:04d}.jpg"
        img = (rng.rand(IMG, IMG, 3) * 255).astype(np.uint8)
        # a blob, so that the crops are not pure noise
        circles_filled(img, np.array([[128, 128]]), 60, (200, 180, 160))
        write_image(os.path.join(img_dir, name), np.ascontiguousarray(img[:, :, ::-1]))
        # relative to DATASET.DATA_DIR, which the loader joins it with
        imgnames.append(f"dataset_folders/smoke/{name}")

    pose = (0.2 * rng.randn(n, 72)).astype(np.float32)
    shape = (0.5 * rng.randn(n, 10)).astype(np.float32)
    # 24 GT 3D joints and their validity, roughly human-sized (meters)
    S = np.concatenate(
        [0.3 * rng.randn(n, 24, 3), np.ones((n, 24, 1))], axis=-1
    ).astype(np.float32)
    # 2D keypoints in pixels and their confidence
    part = np.concatenate(
        [128 + 40 * rng.randn(n, 24, 2), np.ones((n, 24, 1))], axis=-1
    ).astype(np.float32)
    gender = np.array(["m" if i % 2 == 0 else "f" for i in range(n)])

    out = os.path.join(root, "dataset_extras", f"smoke_{split}.npz")
    np.savez(
        out,
        imgname=np.array(imgnames),
        center=np.full((n, 2), 128.0, np.float32),
        scale=np.full((n,), 0.9, np.float32),
        pose=pose,
        shape=shape,
        S=S,
        part=part,
        openpose=np.zeros((n, 25, 3), np.float32),
        gender=gender,
    )
    return out


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=16)
    parser.add_argument("--root", default="data")
    args = parser.parse_args(argv)
    # the train split for DATASETS_AND_RATIOS, the test split for VAL_DS
    # (the CLIs read {name}_train.npz and {name}_test.npz)
    paths = []
    for split, seed in (("train", 0), ("test", 1)):
        paths.append(make_split(args.root, split, args.n, seed))
        print(f"wrote {paths[-1]}")
    return paths


if __name__ == "__main__":
    main()
